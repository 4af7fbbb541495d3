"""Preparation transforms of the confidence and sigma protocols
(``rcu_tpu.ops.prepare`` counterparts of ``rescale_linear``,
``rescale_subject_min_max`` and ``uncertainty_to_foreground_probabilities``).

f32 arithmetic in the JAX package's order, so that a value lands on the
same side of a bin edge or threshold as there: ``(x - min) / (max - min)``,
then ``* (1 - 2 eps) + eps``; the fold halves and subtracts from 1. A
constant map rescales 0/0 to NaN, as in the JAX package.
"""
from __future__ import annotations

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
