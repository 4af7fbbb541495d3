"""Preparation transforms of the eval protocols (``rcu_tpu.ops.prepare``
counterparts): the confidence and sigma rescales and fold, the two-class
stack, the normalized entropy, and the host range check and sigma fold.

f32 arithmetic in the JAX package's order, so that a value lands on the
same side of a bin edge or threshold as there: ``(x - min) / (max - min)``,
then ``* (1 - 2 eps) + eps``; the fold halves and subtracts from 1. A
constant map rescales 0/0 to NaN, as in the JAX package.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch


def rescale_linear(x, min_, max_, epsilon: float = 1e-5):
    """Min/max rescale into [eps, 1 - eps]; ``min_``/``max_`` are f32."""
    min_ = torch.as_tensor(min_, dtype=torch.float32, device=x.device)
    max_ = torch.as_tensor(max_, dtype=torch.float32, device=x.device)
    rescaled = (x - min_) / (max_ - min_)
    return rescaled * (1.0 - 2.0 * epsilon) + epsilon


def rescale_subject_min_max(x, epsilon: float = 1e-5):
    """Rescale by the map's own min and max."""
    return rescale_linear(x, torch.min(x), torch.max(x), epsilon)


def uncertainty_to_foreground_probabilities(uncertainty, prediction):
    """Fold a [0, 1] uncertainty map into a foreground probability map:
    ``1 - u/2`` where the prediction is 1, ``u/2`` elsewhere."""
    half = uncertainty * 0.5
    return torch.where(prediction == 1, 1.0 - half, half)


def add_background_probability(probability):
    """Stack ``[1 - p, p]`` on a new trailing class axis."""
    return torch.stack([1.0 - probability, probability], dim=-1)


def fold_sigma_host(sigma, prediction, sigma_min, sigma_max,
                    epsilon: float = 1e-5):
    """numpy twin of :func:`rescale_linear` + the fold, in float32, for
    host-side paths (serving's confidence of an unscored request)."""
    sigma = np.asarray(sigma, np.float32)
    rescaled = (sigma - np.float32(sigma_min)) \
        / (np.float32(sigma_max) - np.float32(sigma_min))
    rescaled = rescaled * np.float32(1.0 - 2.0 * epsilon) + np.float32(epsilon)
    return np.where(np.asarray(prediction) == 1,
                    1.0 - rescaled * 0.5, rescaled * 0.5).astype(np.float32)


def check_min_max(arr, min_=0.0, max_=1.0, only_warn: bool = False):
    """Raise (or with ``only_warn`` warn) where ``arr`` (a tensor or an
    array) leaves ``[min_, max_]``."""
    if isinstance(arr, torch.Tensor):
        lo, hi = (float(v) for v in torch.aminmax(arr))
    else:
        arr = np.asarray(arr)
        lo, hi = float(arr.min()), float(arr.max())
    for bad, msg in ((hi > max_, f'Found value larger than {max_}: "{hi}"'),
                     (lo < min_, f'Found value smaller than {min_}: "{lo}"')):
        if bad:
            if only_warn:
                warnings.warn(msg)
            else:
                raise ValueError(msg)


def normalized_entropy(probabilities, nb_classes: int = 2):
    """Entropy of a class-last probability tensor over ``log(C)`` (f32 /
    f32, as the JAX package divides), in [0, 1]."""
    if probabilities.shape[-1] != nb_classes:
        raise ValueError(
            f"last dimension of probability array ({tuple(probabilities.shape)}) "
            f"must be equal to nb_classes ({nb_classes})")
    p = probabilities
    plogp = torch.where(p > 0, p * torch.log(torch.where(p > 0, p, 1.0)), 0.0)
    return -torch.sum(plogp, dim=-1) / torch.tensor(
        math.log(float(nb_classes)), dtype=torch.float32, device=p.device)
