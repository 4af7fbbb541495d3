"""The protocols' forwards (``rcu_tpu.engine.steps`` counterparts).

Public layout is the JAX package's: NHWC images in, ``(..., classes)``
probabilities out (views over the NCHW compute, no copies). Models return
``models.unet.UNetOutput``.
"""
from __future__ import annotations

import torch

from rcu_tpu_torch.ops import metrics


def to_model_layout(images, model):
    """NHWC images as the NCHW tensor that ``model`` takes, in the memory
    format its convolutions run fastest in: channels-last for a bf16 model
    (cuDNN's tensor-core convolutions read NHWC; an NCHW tensor costs a
    transpose on each side of each conv), NCHW for a float32 one."""
    fmt = torch.contiguous_format \
        if getattr(model, "dtype", torch.float32) == torch.float32 \
        else torch.channels_last
    return images.permute(0, 3, 1, 2).contiguous(memory_format=fmt)


def predict(model, images):
    """Deterministic softmax forward: (B, H, W, C) -> (B, H, W, classes)."""
    logits = model(to_model_layout(images, model)).logits
    return torch.softmax(logits, dim=1).permute(0, 2, 3, 1)


def mc_forward(model, images, generators):
    """The T stochastic forwards of the MC protocol, riding the batch dim.

    ``images`` (B, H, W, C); ``generators`` one ``torch.Generator`` per
    sample, on the images' device. Returns (T, B, H, W, classes).

    Where the model has a dropout-free encoder prefix
    (``mc_shared_blocks`` > 0, ``dropout_center < depth``), the prefix runs
    once on the B images and only its outputs are repeated for the T
    samples; the outputs equal those of the full T*B forward with the same
    generators."""
    x = to_model_layout(images, model)
    b, t = x.shape[0], len(generators)
    if getattr(model, "mc_shared_blocks", 0):
        pooled, skips = model.encode_shared(x)
        out = model.decode_rest(torch.cat([pooled] * t),
                                [torch.cat([s] * t) for s in skips],
                                generators)
    else:
        out = model(torch.cat([x] * t), generators)
    probs = torch.softmax(out.logits, dim=1)
    return probs.reshape((t, b) + probs.shape[1:]).permute(0, 1, 3, 4, 2)


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
    out = model(to_model_layout(images, model))
    probabilities = torch.softmax(out.logits, dim=1)
    sigma = torch.exp(out.sigma) if is_log_sigma else torch.abs(out.sigma)
    prediction = torch.argmax(probabilities, dim=1)
    predicted_sigma = torch.gather(sigma, 1, prediction[:, None])[:, 0]
    return (probabilities.permute(0, 2, 3, 1), sigma.permute(0, 2, 3, 1),
            prediction, predicted_sigma)
