"""Segmentation metrics on tensors (``rcu_tpu.ops.metrics`` counterparts).

Counts are exact integers (int64), where the JAX package sums 0/1 floats
in float32 (exact below 2^24 voxels).
"""
from __future__ import annotations

import torch


def confusion_counts(prediction: torch.Tensor, target: torch.Tensor, mask=None):
    """Binary confusion counts (tp, tn, fp, fn, n) as int64 scalars."""
    p = prediction.bool()
    t = target.bool()
    w = torch.ones_like(p) if mask is None else mask.bool()
    tp = (p & t & w).sum()
    fp = (p & ~t & w).sum()
    fn = (~p & t & w).sum()
    n = w.sum()
    return tp, n - tp - fp - fn, fp, fn, n


def dice_from_counts(tp, fp, fn):
    """Dice = 2tp / (2tp + fp + fn); 0/0 yields NaN exactly like a float div."""
    return (2.0 * tp) / (2.0 * tp + fp + fn)


def entropy(p: torch.Tensor, dim: int = -1, keepdim: bool = False):
    """Shannon entropy with the 0*log(0)=0 convention (natural log)."""
    positive = p > 0
    plogp = torch.where(positive, p * torch.log(torch.where(positive, p, 1.0)),
                        0.0)
    return -torch.sum(plogp, dim=dim, keepdim=keepdim)
