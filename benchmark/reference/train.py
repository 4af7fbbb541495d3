"""The first training steps of the published recipe in plain PyTorch: the
U-Net in train mode (BatchNorm on the batch's statistics, channel dropout
from the step's stream), softmax cross-entropy averaged over every pixel
of the batch, autograd, and optax's Adam (``lr``, b1 0.9, b2 0.999, eps
1e-8, bias-corrected moments)."""
from __future__ import annotations

import torch
from torch.nn import functional as F

from benchmark.reference import streams
from benchmark.reference.unet import forward, is_trained


def adam_steps(w0: dict, batches, generators, model: dict, lr: float,
               keep: float, rows: int = None, state=None, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8) -> dict:
    """Run one step per ``(images NCHW, labels)`` batch from the weights
    ``w0``, step ``k``'s dropout from ``generators[k]``. ``rows`` keeps
    only that many leading rows of each batch (a fault to plant).
    ``state``: Adam's ({leaf: first moment}, {leaf: second moment}, steps
    taken) to go on from; None starts from zeros. Returns the losses,
    each trained leaf's first gradient and its change after the last
    step."""
    depth = int(model["depth"])
    params = {k: v.detach().clone().requires_grad_(is_trained(k))
              for k, v in w0.items()}
    names = [k for k in params if is_trained(k)]
    if state is None:
        m = {k: torch.zeros_like(params[k]) for k in names}
        v = {k: torch.zeros_like(params[k]) for k in names}
        taken = 0
    else:
        m = {k: state[0][k].detach().clone() for k in names}
        v = {k: state[1][k].detach().clone() for k in names}
        taken = int(state[2])
    losses, first = [], None
    for step, ((x, y), gen) in enumerate(zip(batches, generators),
                                         start=taken + 1):
        if rows is not None:
            x, y = x[:rows], y[:rows]
        logits = forward(params, x, depth, streams.Masks(gen, keep), keep,
                         mode="train")
        loss = F.cross_entropy(logits, y.long())
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[k] / (1 - b1 ** step)
                v_hat = v[k] / (1 - b2 ** step)
                params[k].sub_(lr * m_hat / (v_hat.sqrt() + eps))
    change = {k: (params[k] - w0[k]).detach() for k in names}
    return {"losses": losses, "first_grad": first, "change": change}
