"""The protocols' forwards (``rcu_tpu.engine.steps`` counterparts).

Public layout is the JAX package's: NHWC images in, ``(..., classes)``
probabilities out (views over the NCHW compute, no copies). Models return
``models.unet.UNetOutput``.
"""
from __future__ import annotations

import torch

from rcu_tpu_torch.ops import metrics


def predict(model, images):
    """Deterministic softmax forward: (B, H, W, C) -> (B, H, W, classes)."""
    logits = model(images.permute(0, 3, 1, 2).contiguous()).logits
    return torch.softmax(logits, dim=1).permute(0, 2, 3, 1)


def mc_forward(model, images, generators):
    """The T stochastic forwards of the MC protocol, riding the batch dim.

    ``images`` (B, H, W, C); ``generators`` one ``torch.Generator`` per
    sample, on the images' device. Returns (T, B, H, W, classes)."""
    x = images.permute(0, 3, 1, 2).contiguous()
    b = x.shape[0]
    logits = model(x.repeat(len(generators), 1, 1, 1), generators).logits
    probs = torch.softmax(logits, dim=1)
    return probs.reshape((len(generators), b) + probs.shape[1:]) \
        .permute(0, 1, 3, 4, 2)


def multi_prediction_summary(multi_probabilities):
    """Mean probabilities and predictive entropy over the leading sample axis."""
    probabilities = torch.mean(multi_probabilities, dim=0)
    return {"probabilities": probabilities,
            "entropy": metrics.entropy(probabilities, dim=-1)}


def aleatoric_forward(model, images, is_log_sigma: bool):
    """One deterministic forward of a sigma-headed model -> (probabilities
    (B, H, W, classes), sigma (B, H, W, classes), prediction (B, H, W)
    int64, predicted-class sigma (B, H, W)).

    sigma is ``exp`` of the head when it gives log-sigma, else its ``abs``.
    The prediction is the argmax of the softmax probabilities, not of the
    logits: two logits apart by less than the softmax resolves tie there,
    and a tie goes to class 0, as ``jnp.argmax`` gives it."""
    out = model(images.permute(0, 3, 1, 2).contiguous())
    probabilities = torch.softmax(out.logits, dim=1)
    sigma = torch.exp(out.sigma) if is_log_sigma else torch.abs(out.sigma)
    prediction = torch.argmax(probabilities, dim=1)
    predicted_sigma = torch.gather(sigma, 1, prediction[:, None])[:, 0]
    return (probabilities.permute(0, 2, 3, 1), sigma.permute(0, 2, 3, 1),
            prediction, predicted_sigma)
