"""The MC-dropout protocol's forwards (``rcu_tpu.engine.steps`` counterparts).

Public layout is the JAX package's: NHWC images in, ``(..., classes)``
probabilities out (views over the NCHW compute, no copies).
"""
from __future__ import annotations

import torch

from rcu_tpu_torch.ops import metrics


def predict(model, images):
    """Deterministic softmax forward: (B, H, W, C) -> (B, H, W, classes)."""
    logits = model(images.permute(0, 3, 1, 2).contiguous())
    return torch.softmax(logits, dim=1).permute(0, 2, 3, 1)


def mc_forward(model, images, generators):
    """The T stochastic forwards of the MC protocol, riding the batch dim.

    ``images`` (B, H, W, C); ``generators`` one ``torch.Generator`` per
    sample, on the images' device. Returns (T, B, H, W, classes)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    b = x.shape[0]
    logits = model(x.repeat(len(generators), 1, 1, 1), generators)
    probs = torch.softmax(logits, dim=1)
    return probs.reshape((len(generators), b) + probs.shape[1:]) \
        .permute(0, 1, 3, 4, 2)


def multi_prediction_summary(multi_probabilities):
    """Mean probabilities and predictive entropy over the leading sample axis."""
    probabilities = torch.mean(multi_probabilities, dim=0)
    return {"probabilities": probabilities,
            "entropy": metrics.entropy(probabilities, dim=-1)}
