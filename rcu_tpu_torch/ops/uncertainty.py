"""Uncertainty-vs-error counts, error metrics and correction analysis on
tensors (``rcu_tpu.ops.uncertainty`` counterparts).

The error dice, recall and precision map 0/0 to 1, as the reference does.

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


def _f32(x):
    return torch.as_tensor(x).to(torch.float32)


def error_dice(fp, fn, tpu, tnu, fpu, fnu):
    """2(fnu+fpu) / (fn+fp+fnu+fpu+tnu+tpu), 0/0 -> 1."""
    num = _f32(fnu + fpu)
    den = _f32(fn + fp + fnu + fpu + tnu + tpu)
    return torch.where((num == 0) & (den == 0), 1.0, (2.0 * num) / den)


def error_recall(fp, fn, fpu, fnu):
    num = _f32(fnu + fpu)
    den = _f32(fn + fp)
    return torch.where((num == 0) & (den == 0), 1.0, num / den)


def error_precision(tpu, tnu, fpu, fnu):
    num = _f32(fnu + fpu)
    den = _f32(fnu + fpu + tpu + tnu)
    return torch.where((num == 0) & (den == 0), 1.0, num / den)


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


def uncertainty_error_metrics(prediction, target, uncertainty, thresholds,
                              mask=None):
    """Error precision, recall and dice over a threshold vector
    (``u > threshold``): a dict of ``(len(thresholds),)`` tensors."""
    p = prediction.reshape(-1)
    t = target.reshape(-1)
    u = uncertainty.reshape(-1).float()
    m = mask.reshape(-1) if mask is not None else None
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=u.device)
    rows = []
    for i in range(th.numel()):
        tp, tn, fp, fn, tpu, tnu, fpu, fnu = uncertainty_counts(
            p, t, u > th[i], m)
        rows.append({"precision": error_precision(tpu, tnu, fpu, fnu),
                     "recall": error_recall(fp, fn, fpu, fnu),
                     "dice": error_dice(fp, fn, tpu, tnu, fpu, fnu)})
    return {k: torch.stack([r[k] for r in rows]) for k in
            ("precision", "recall", "dice")}
