"""optax's ``adam`` and ``sgd`` for the port's models, with optax's meaning
and its checkpoint layout (``rcu_tpu.models.registry.get_optimizer``).

An optimizer is stateless, as an optax transformation is: :meth:`init`
makes the state of a model's named parameters and :meth:`step` applies
one update from their ``.grad`` in place (a parameter without a gradient
takes zeros, as ``jax.grad`` gives an unused parameter). The state holds
the moments as one flat buffer each, in ``named_parameters`` order and
the parameters' dtype, so that an update is a few elementwise kernels
over all parameters at once. :meth:`to_flax` and :meth:`from_flax` map it
onto optax's state as the JAX package's checkpoints hold it: ``{'0': {'count', 'mu', 'nu'},
'1': {}}`` for adam, ``{'0': {}, '1': {}}`` (or ``{'0': {'trace'}}`` with
momentum) for sgd, the moments in flax's parameter layout.

The moment updates ``(1 - b) * g + b * m`` are rounded as XLA compiles
optax's: the product ``b * m`` rounded, then one fused multiply-add
(computed in float64, rounded once to float32), so that the moments equal
optax's bit for bit on the same gradients.
"""
from __future__ import annotations

import numpy as np
import torch

from rcu_tpu_torch.models.convert import (flax_from_state_dict,
                                          state_dict_from_flax)


def _f32(value: float) -> float:
    return float(np.float32(value))


def _fma(a: float, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` rounded once to ``y``'s dtype (float32: the product
    and the sum are exact or nearly so in float64)."""
    return (x.double() * _f32(a) + y.double()).to(y.dtype)


def _flat_grads(params: dict) -> torch.Tensor:
    return torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params.values()])


def _apply(params: dict, update: torch.Tensor):
    """``p + update`` for every parameter, ``update`` flat."""
    sizes = [p.numel() for p in params.values()]
    views = [u.view(p.shape) for u, p in
             zip(torch.split(update, sizes), params.values())]
    torch._foreach_add_(list(params.values()), views)


def _named(flat: torch.Tensor, params: dict) -> dict:
    sizes = [p.numel() for p in params.values()]
    return {name: u.view(p.shape) for (name, p), u in
            zip(params.items(), torch.split(flat, sizes))}


def _to_flax_tree(flat: torch.Tensor, params: dict) -> dict:
    return flax_from_state_dict(_named(flat, params))[0]


def _from_flax_tree(tree: dict, params: dict) -> torch.Tensor:
    named = state_dict_from_flax(tree, {})
    if set(named) != set(params):
        raise ValueError("optimizer state does not match the model's "
                         f"parameters: {sorted(set(named) ^ set(params))[:4]}")
    device = next(iter(params.values())).device
    return torch.cat([named[name].reshape(-1) for name in params]).to(device)


def _zeros(params: dict) -> torch.Tensor:
    p = next(iter(params.values()))
    return torch.zeros(sum(q.numel() for q in params.values()),
                       dtype=p.dtype, device=p.device)


class Adam:
    """``optax.adam(lr, b1, b2, eps, eps_root)``."""

    def __init__(self, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, eps_root: float = 0.0):
        self.lr, self.b1, self.b2 = lr, b1, b2
        self.eps, self.eps_root = eps, eps_root

    def init(self, params: dict) -> dict:
        return {"count": 0, "mu": _zeros(params), "nu": _zeros(params)}

    @torch.no_grad()
    def step(self, params: dict, state: dict):
        g = _flat_grads(params)
        state["mu"] = _fma(1 - self.b1, g, state["mu"] * _f32(self.b1))
        state["nu"] = _fma(1 - self.b2, g * g, state["nu"] * _f32(self.b2))
        state["count"] += 1
        count = np.float32(state["count"])
        # the update in float64, rounded once, dividing by 0-dim tensors
        # (CUDA divides by a Python scalar as a multiply by its reciprocal):
        # the card and the CPU agree bit for bit, and optax's float32
        # update lies within its rounding
        bc1, bc2 = (torch.full((), float(np.float32(1) - np.float32(b) ** count),
                               dtype=torch.float64, device=g.device)
                    for b in (self.b1, self.b2))
        mu, nu = state["mu"].double(), state["nu"].double()
        denom = torch.sqrt(nu / bc2 + _f32(self.eps_root)) + _f32(self.eps)
        _apply(params, ((mu / bc1) / denom * _f32(-self.lr)).to(g.dtype))

    def to_flax(self, state: dict, params: dict) -> dict:
        return {"0": {"count": np.asarray(state["count"], np.int32),
                      "mu": _to_flax_tree(state["mu"], params),
                      "nu": _to_flax_tree(state["nu"], params)},
                "1": {}}

    def from_flax(self, opt_state: dict, params: dict) -> dict:
        inner = opt_state["0"]
        return {"count": int(inner["count"]),
                "mu": _from_flax_tree(inner["mu"], params),
                "nu": _from_flax_tree(inner["nu"], params)}


class SGD:
    """``optax.sgd(lr, momentum, nesterov)``."""

    def __init__(self, lr: float = 1e-2, momentum: float = None,
                 nesterov: bool = False):
        self.lr, self.momentum, self.nesterov = lr, momentum, nesterov

    def init(self, params: dict) -> dict:
        return {} if self.momentum is None else {"trace": _zeros(params)}

    @torch.no_grad()
    def step(self, params: dict, state: dict):
        update = _flat_grads(params)
        if self.momentum is not None:
            state["trace"] = _fma(self.momentum, state["trace"], update)
            if self.nesterov:
                update = _fma(self.momentum, state["trace"], update)
            else:
                update = state["trace"]
        _apply(params, update * _f32(-self.lr))

    def to_flax(self, state: dict, params: dict) -> dict:
        inner = {} if self.momentum is None else \
            {"trace": _to_flax_tree(state["trace"], params)}
        return {"0": inner, "1": {}}

    def from_flax(self, opt_state: dict, params: dict) -> dict:
        if self.momentum is None:
            return {}
        return {"trace": _from_flax_tree(opt_state["0"]["trace"], params)}


_OPTIMIZERS = {"adam": (Adam, {"lr", "b1", "b2", "eps", "eps_root"}),
               "sgd": (SGD, {"lr", "momentum", "nesterov"})}


def get_optimizer(optimizer_type: str, params: dict):
    """The optimizer of a config's ``optimizer: {type: {params}}`` node,
    with optax's parameter names and defaults (lr 1e-3 for adam, 1e-2 for
    sgd); an unknown type or parameter raises ``ValueError``."""
    if optimizer_type not in _OPTIMIZERS:
        raise ValueError(f'unknown optimizer type "{optimizer_type}"')
    cls, known = _OPTIMIZERS[optimizer_type]
    unknown = set(params) - known
    if unknown:
        raise ValueError(f"unknown {optimizer_type} params: {sorted(unknown)}")
    return cls(**{k: v for k, v in params.items() if v is not None})
