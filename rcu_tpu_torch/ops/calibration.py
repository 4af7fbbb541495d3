"""Reliability binning / expected calibration error on tensors
(``rcu_tpu.ops.calibration`` counterparts).

Bin ids equal ``np.digitize(p, linspace(0, 1+1e-8, n+1)) - 1`` for float32
``p``: each float64 edge is split into ``hi = f32(edge)`` and the residual
``lo = edge - hi``; ``p >= edge`` in float64 is then ``p > hi`` when
``lo > 0`` and ``p >= hi`` otherwise, exact because one f32 ulp at ``hi``
exceeds ``|lo|``. :func:`bin_edges` is the single source of that split for
the plain path here and for the CUDA kernel's host arguments.
"""
from __future__ import annotations

import numpy as np
import torch

_TOP = 1.0 + 1e-8  # top bin edge widening of the reference digitize


def bin_edges(n_bins: int = 10):
    """-> [(hi, strict)] for edges[1:]: ``p`` passes an edge when
    ``p > hi`` (strict) or ``p >= hi``."""
    out = []
    for edge in np.linspace(0.0, _TOP, n_bins + 1)[1:]:
        hi = np.float32(edge)
        out.append((hi, edge - float(hi) > 0))
    return out


def bin_ids(probabilities: torch.Tensor, n_bins: int = 10) -> torch.Tensor:
    """int64 bin index per element (NaN lands in bin 0, as in the JAX path)."""
    p = probabilities.float()
    ids = torch.zeros(p.shape, dtype=torch.int64, device=p.device)
    for hi, strict in bin_edges(n_bins):
        ids += (p > float(hi)) if strict else (p >= float(hi))
    return ids.clamp_(0, n_bins - 1)


def binned_sums(probabilities, target, n_bins: int = 10, mask=None):
    """-> (count int64, sum of confidences float64, sum of targets int64)
    per bin over the voxels the mask keeps."""
    p = probabilities.reshape(-1).float()
    t = target.reshape(-1).bool()
    keep = torch.ones_like(t) if mask is None else mask.reshape(-1).bool()
    ids = bin_ids(p, n_bins)[keep]
    count = torch.bincount(ids, minlength=n_bins)
    conf = torch.bincount(ids, weights=p[keep].double(), minlength=n_bins)
    true = torch.bincount(ids[t[keep]], minlength=n_bins)
    return count, conf, true


def bin_statistics(count, conf_sum, true_sum):
    """-> (positive fraction, mean confidence, nonzero) from the per-bin sums."""
    nonzero = count > 0
    safe = torch.where(nonzero, count, 1).double()
    pos_frac = torch.where(nonzero, true_sum / safe, 0.0)
    mean_conf = torch.where(nonzero, conf_sum / safe, 0.0)
    return pos_frac, mean_conf, nonzero


def binary_calibration(probabilities, target, n_bins: int = 10, mask=None):
    """Per-bin (positive fraction, mean confidence, count, nonzero).

    ``probabilities`` is the foreground map or a two-class array with the
    class dim last (the foreground column is used)."""
    probs = probabilities
    if probs.dim() > target.dim():
        if probs.shape[-1] > 2:
            raise ValueError("binary calibration needs binary probabilities")
        probs = probs[..., 1] if probs.shape[-1] == 2 else probs.squeeze(-1)
    count, conf, true = binned_sums(probs, target, n_bins, mask)
    pos_frac, mean_conf, nonzero = bin_statistics(count, conf, true)
    return pos_frac, mean_conf, count, nonzero


def _bin_proportions(bin_weighting: str, bin_count, nonzero, n_dim: int):
    """Bin weights over nonzero bins (the last axis; any leading axes are
    images); zero bins get weight 0."""
    count = torch.where(nonzero, bin_count, 0).double()
    if bin_weighting == "proportion":
        return count / count.sum(-1, keepdim=True)
    if bin_weighting == "log_proportion":
        logc = torch.where(nonzero, torch.log(torch.where(nonzero, count, 1.0)), 0.0)
        return logc / logc.sum(-1, keepdim=True)
    if bin_weighting == "power_proportion":
        powc = torch.where(nonzero, torch.where(nonzero, count, 1.0) ** (1.0 / n_dim), 0.0)
        return powc / powc.sum(-1, keepdim=True)
    if bin_weighting == "mean_proportion":
        return torch.where(nonzero, 1.0 / nonzero.sum(-1, keepdim=True).double(),
                           0.0)
    raise ValueError(f'unknown bin weighting "{bin_weighting}"')


def ece_binary_with_bins(probabilities, target, mask=None, n_bins: int = 10,
                         bin_weighting: str = "proportion",
                         n_dim_override: int = None):
    """ECE plus the fixed-shape reliability bins; floats in float64."""
    n_dim = n_dim_override if n_dim_override is not None else target.dim()
    pos_frac, mean_conf, bin_count, nonzero = binary_calibration(
        probabilities, target, n_bins, mask)
    proportions = _bin_proportions(bin_weighting, bin_count, nonzero, n_dim)
    ece = torch.sum(torch.abs(mean_conf - pos_frac) * proportions)
    return ece, {
        "bins_count": bin_count,
        "bins_avg_confidence": mean_conf,
        "bins_positive_fraction": pos_frac,
        "bins_non_zero": nonzero,
    }
