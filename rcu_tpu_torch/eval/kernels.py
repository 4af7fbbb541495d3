"""The offline eval engine's per-subject reductions (``rcu_tpu.eval.kernels``
counterparts), each one launch of the hand-written eval kernel
(``ops.cuda.evalstats.fused_subject_eval``: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors):

- :func:`ece_dice_confusion`: the masked ECE, the unmasked Dice and
  confusion counts (the ``ece_dice`` pass);
- :func:`calibration_bins`: the masked ECE, the 10 reliability bins and the
  unmasked Dice (the ``calib`` pass);
- :func:`correction_eval`: the correction rows at every threshold (the
  ``bnf_ue`` pass).

The mask reaches the ECE bins only; ``mask=None`` means every voxel. The
ECE passes count no thresholds, and the correction pass reads only the
threshold counts and the confusion: its ECE plane is the uncertainty
plane, which it does not read back. :func:`min_max` (the ``minmax`` pass)
is one ``torch.aminmax``.
"""
from __future__ import annotations

import torch

from rcu_tpu_torch.ops.cuda.evalstats import fused_subject_eval


def _fg(probabilities):
    """The foreground column of a two-class map (class axis last)."""
    if probabilities.shape[-1] != 2:
        raise ValueError("binary calibration needs two-class probabilities, "
                         f"got shape {tuple(probabilities.shape)}")
    return probabilities[..., 1]


def calibration_bins(probabilities, target, prediction, mask=None) -> dict:
    """The masked ECE, the reliability bins (``bins_count``,
    ``bins_avg_confidence``, ``bins_positive_fraction``,
    ``bins_non_zero``) and the unmasked ``dice``, ``tp``, ``tn``, ``fp``,
    ``fn`` and ``n`` of one subject."""
    fg = _fg(probabilities)
    bins, confusion, _ = fused_subject_eval(fg, target, prediction, fg, mask,
                                            ())
    return {**bins, **confusion}


def ece_dice_confusion(probabilities, target, prediction, mask=None) -> dict:
    """``ece``, ``dice``, ``tp``, ``tn``, ``fp``, ``fn``, ``n`` of one
    subject: the ECE masked, the rest not."""
    out = calibration_bins(probabilities, target, prediction, mask)
    return {k: out[k] for k in ("ece", "dice", "tp", "tn", "fp", "fn", "n")}


def correction_eval(prediction, target, uncertainty, thresholds) -> dict:
    """The correction analysis at every threshold (``uncertainty >
    threshold``): a dict of ``(len(thresholds),)`` tensors."""
    _, _, correction = fused_subject_eval(uncertainty, target, prediction,
                                          uncertainty, None, thresholds)
    return correction


def min_max(x) -> dict:
    lo, hi = torch.aminmax(x)
    return {"min": lo, "max": hi}
