"""Segmentation metrics (``rcu_tpu.ops.metrics`` counterparts): the eval's
on tensors, and the per-subject validation metrics of training
(:func:`dice`, :func:`smooth_dice`, :func:`nll`, :func:`log_loss`) on
host numpy arrays, in float32 as the JAX package computes them.

Counts are exact integers (int64), where the JAX package sums 0/1 floats
in float32 (exact below 2^24 voxels).
"""
from __future__ import annotations

import numpy as np
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


def dice(prediction, target) -> float:
    """Dice of two binary numpy maps; 0/0 gives NaN as in the JAX package."""
    p, t = np.asarray(prediction, bool), np.asarray(target, bool)
    tp = np.count_nonzero(p & t)
    fp = np.count_nonzero(p & ~t)
    fn = np.count_nonzero(~p & t)
    with np.errstate(invalid="ignore"):
        return float(np.float32(2.0 * tp) / np.float32(2 * tp + fp + fn))


def smooth_dice(prediction, target, smooth: float = 1.0) -> float:
    """Soft dice over the flattened maps, in float32."""
    iflat = np.asarray(prediction, np.float32).reshape(-1)
    tflat = np.asarray(target, np.float32).reshape(-1)
    intersection = np.sum(iflat * tflat, dtype=np.float32)
    smooth = np.float32(smooth)
    return float((np.float32(2.0) * intersection + smooth)
                 / (np.sum(iflat, dtype=np.float32)
                    + np.sum(tflat, dtype=np.float32) + smooth))


def _picked(probs, target):
    flat = probs.reshape(-1, probs.shape[-1])
    return np.take_along_axis(
        flat, np.asarray(target).reshape(-1).astype(np.int64)[:, None], 1)[:, 0]


def nll(probabilities, target, do_log: bool = True) -> float:
    """Mean negative log-likelihood of the target class; class axis last.
    ``do_log``: the inputs are probabilities, else log-probabilities."""
    probs = np.asarray(probabilities, np.float32)
    if do_log:
        probs = np.log(probs)
    return float(-np.mean(_picked(probs, target), dtype=np.float32))


def log_loss(probabilities, target, eps: float = 1e-15) -> float:
    """sklearn's log loss as the JAX package computes it: the probabilities
    clipped to [eps, 1 - eps] and renormalized over the classes. One
    probability per target element is a foreground map; more carry a
    trailing class axis."""
    probs = np.asarray(probabilities, np.float32)
    target = np.asarray(target)
    if probs.size == target.size:
        fg = probs.reshape(-1)
        flat = np.stack([np.float32(1.0) - fg, fg], axis=-1)
    else:
        flat = probs.reshape(-1, probs.shape[-1])
        if flat.shape[0] != target.size:
            raise ValueError(
                f"log_loss shapes disagree: probabilities {probs.shape} "
                f"vs target {target.shape}")
    flat = np.clip(flat, np.float32(eps), np.float32(1.0 - eps))
    flat = flat / np.sum(flat, axis=-1, keepdims=True)
    return float(-np.mean(np.log(_picked(flat, target)), dtype=np.float32))
