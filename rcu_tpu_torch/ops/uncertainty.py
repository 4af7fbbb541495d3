"""Uncertainty-vs-error counts and correction analysis on tensors
(``rcu_tpu.ops.uncertainty`` counterparts).

The corrected dice/accuracy are derived from the 8 counts:

  correct-to-background: prediction := 0 where uncertain
     tp' = tp - tpu, fp' = fp - fpu, fn' = fn + tpu, tn' = tn + fpu
  correct-to-foreground: prediction := 1 where uncertain
     tp' = tp + fnu, fp' = fp + tnu, fn' = fn - fnu, tn' = tn - tnu
"""
from __future__ import annotations

import torch

from rcu_tpu_torch.ops.metrics import dice_from_counts


def uncertainty_counts(prediction, target, thresholded_uncertainty, mask=None):
    """(tp, tn, fp, fn, tpu, tnu, fpu, fnu) as int64 scalars."""
    p = prediction.bool()
    t = target.bool()
    u = thresholded_uncertainty.bool()
    w = torch.ones_like(p) if mask is None else mask.bool()
    tp_m, fp_m = p & t & w, p & ~t & w
    fn_m, tn_m = ~p & t & w, ~p & ~t & w
    return (tp_m.sum(), tn_m.sum(), fp_m.sum(), fn_m.sum(),
            (tp_m & u).sum(), (tn_m & u).sum(), (fp_m & u).sum(),
            (fn_m & u).sum())


def _correction_from_counts(counts):
    """The correction CSV row from the 8 counts. Counts are returned as
    given; the derived values are computed in float32 like the JAX package
    (exact counts below 2^24), so comparisons such as ``dice_benefit`` tie
    the same way there and here."""
    tp, tn, fp, fn, tpu, tnu, fpu, fnu = counts
    ftp, ftn, ffp, ffn, ftpu, ftnu, ffpu, ffnu = (
        torch.as_tensor(c).to(torch.float32) for c in counts)
    n = ftp + ftn + ffp + ffn

    tpu_fpu_ratio = ftpu / ffpu  # inf/nan semantics intentionally identical
    jaccard = ftp / (ftp + ffp + ffn)
    dice_benefit = tpu_fpu_ratio < jaccard
    accuracy_benefit = tpu_fpu_ratio < 1.0

    dice_val = dice_from_counts(ftp, ffp, ffn)
    accuracy_val = (ftp + ftn) / n
    corrected_dice = dice_from_counts(ftp - ftpu, ffp - ffpu, ffn + ftpu)
    corrected_accuracy = ((ftp - ftpu) + (ftn + ffpu)) / n
    corrected_add_dice = dice_from_counts(ftp + ffnu, ffp + ftnu, ffn - ffnu)
    corrected_add_accuracy = ((ftp + ffnu) + (ftn - ftnu)) / n

    return {
        "tpu": tpu, "tnu": tnu, "fpu": fpu, "fnu": fnu,
        "tp": tp, "tn": tn, "fp": fp, "fn": fn,
        "dice_benefit": dice_benefit,
        "accuracy_benefit": accuracy_benefit,
        "dice": dice_val,
        "accuracy": accuracy_val,
        "corrected_dice": corrected_dice,
        "corrected_accuracy": corrected_accuracy,
        "dice_benefit_correct": (corrected_dice > dice_val) == dice_benefit,
        "accuracy_benefit_correct": (corrected_accuracy > accuracy_val) == accuracy_benefit,
        "corrected_add_dice": corrected_add_dice,
        "corrected_add_accuracy": corrected_add_accuracy,
    }


def correction_eval(prediction, target, uncertainty, thresholds, weight=None):
    """Correction analysis for a vector of thresholds (``u > threshold``).

    Returns a dict of tensors shaped ``(len(thresholds),)``."""
    p = prediction.reshape(-1)
    t = target.reshape(-1)
    u = uncertainty.reshape(-1).float()
    w = weight.reshape(-1) if weight is not None else None
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=u.device)
    rows = [_correction_from_counts(uncertainty_counts(p, t, u > th[i], w))
            for i in range(th.numel())]
    return {k: torch.stack([torch.as_tensor(r[k]) for r in rows])
            for k in rows[0]}
