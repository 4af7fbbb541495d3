"""Training losses (``rcu_tpu.ops.losses`` counterparts), class axis 1.

The ``*_log_probs`` functions return the per-pixel log probability of the
target class; the train steps (``engine.steps``) reduce them with the
batch's ``valid`` mask, and ``cross_entropy`` / ``aleatoric_loss`` are the
plain means over all pixels.
"""
from __future__ import annotations

import torch


def ce_log_probs(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Log-softmax probability of the target class: logits (B, C, H, W),
    integer target (B, H, W) -> (B, H, W)."""
    logp = torch.log_softmax(logits, dim=1)
    return torch.gather(logp, 1, target[:, None].long())[:, 0]


def cross_entropy(logits: torch.Tensor, target: torch.Tensor):
    """Mean softmax cross-entropy."""
    return -torch.mean(ce_log_probs(logits, target))


def aleatoric_noise(nb_samples: int, logits: torch.Tensor, generator=None):
    """The standard normal draws of :func:`aleatoric_log_probs`:
    ``(nb_samples,) + logits.shape``, from ``generator``."""
    return torch.randn((nb_samples,) + tuple(logits.shape), generator=generator,
                       device=logits.device, dtype=logits.dtype)


def aleatoric_log_probs(logits: torch.Tensor, sigma: torch.Tensor,
                        target: torch.Tensor, is_log_sigma: bool,
                        nb_samples: int = 10, generator=None,
                        noise: torch.Tensor = None) -> torch.Tensor:
    """Log of the MC expectation of the target class's softmax probability
    under logits drawn from Normal(logits, sigma) (sigma = exp of the head
    when ``is_log_sigma``): ``nb_samples`` reparameterized samples, their
    softmax averaged. ``noise`` (``(T, B, C, H, W)``, standard normal)
    gives the draws, else they come from ``generator``
    (:func:`aleatoric_noise`). -> (B, H, W)."""
    std = torch.exp(sigma) if is_log_sigma else sigma
    if noise is None:
        noise = aleatoric_noise(nb_samples, logits, generator)
    x_hat = logits[None] + std[None] * noise
    mc_expectation = torch.mean(torch.softmax(x_hat, dim=2), dim=0)
    log_probs = torch.log(mc_expectation)
    return torch.gather(log_probs, 1, target[:, None].long())[:, 0]


def aleatoric_loss(logits, sigma, target, is_log_sigma: bool,
                   nb_samples: int = 10, generator=None, noise=None):
    """Stochastic logit-noise NLL, the mean over all pixels."""
    return -torch.mean(aleatoric_log_probs(logits, sigma, target,
                                           is_log_sigma, nb_samples,
                                           generator, noise))
