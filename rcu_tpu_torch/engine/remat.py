"""Recomputation in the backward pass: the ``remat`` policies of
``rcu_tpu.engine.steps.make_train_step`` with ``torch.utils.checkpoint``.

- ``'conv'``: each ConvBnRelu of a model in train mode keeps its conv
  output and recomputes its dropout, BatchNorm and ReLU epilogue in the
  backward pass (JAX's ``save_only_these_names("conv_out")``);
- ``'full'``: the whole forward is recomputed.

``torch.utils.checkpoint`` (non-reentrant) keeps the forward's graph and
drops the tensors that its ops save; the first backward op that needs one
reruns the region's function to make them again. Three things of a train
forward must not change or happen again in that rerun:
- a dropout site draws its masks from an explicit ``torch.Generator``,
  which the checkpoint does not restore;
- a BatchNorm of a mesh step's part adds its per-channel sums over the
  parts (``parallel.mesh.all_sum``), whose barrier waits for every part,
  while one backward runs every part's graph in one thread;
- a BatchNorm updates its running statistics in place.
So a region's forward records, in a tape of its own, each dropout
divisor and each BatchNorm's (global) sums and count (2 x C floats a
site), and the rerun replays them: it draws nothing, sums over no parts
and updates no statistic. The rerun runs the same ops on the same values,
so it saves the same tensors, and the backward runs on the forward's own
graph: where the device's kernels are deterministic the gradients are
bitwise those of no recomputation.
"""
from __future__ import annotations

import contextlib
import threading
import typing

import torch
from torch.utils import checkpoint as _checkpoint

POLICIES = (None, "conv", "full")
_LOCAL = threading.local()


class _Tape:
    """The values a region's forward recorded, replayed in order."""

    def __init__(self):
        self.values = []
        self.replay = False
        self.position = 0


class _Counter:
    """How many region reruns the backward passes have made (a policy that
    recomputed nothing would leave it where it was)."""
    reruns = 0


counter = _Counter()


@contextlib.contextmanager
def _on(tape: _Tape, replay: bool):
    previous = getattr(_LOCAL, "tape", None)
    tape.replay, tape.position = replay, 0
    _LOCAL.tape = tape
    if replay:
        counter.reruns += 1
    try:
        yield
    finally:
        _LOCAL.tape = previous


def replaying() -> bool:
    """Whether this thread reruns a region in a backward pass."""
    tape = getattr(_LOCAL, "tape", None)
    return tape is not None and tape.replay


def in_region() -> bool:
    """Whether this thread runs a region, its forward or its rerun (under
    ``'full'`` the whole model call, which sets no :func:`policy`)."""
    return getattr(_LOCAL, "tape", None) is not None


class _Saved(typing.NamedTuple):
    tensor: typing.Any
    requires_grad: bool


def _freeze(value):
    if isinstance(value, tuple):
        return tuple(_freeze(v) for v in value)
    if isinstance(value, torch.Tensor):
        return _Saved(value.detach(), value.requires_grad)
    return value


def _thaw(value):
    if isinstance(value, _Saved):
        return value.tensor.detach().requires_grad_(value.requires_grad)
    if isinstance(value, tuple):
        return tuple(_thaw(v) for v in value)
    return value


def replayed(compute):
    """``compute()`` (a tensor, or a tuple of tensors and numbers); inside a
    region's rerun, what it gave in that region's forward instead, each
    tensor flagged ``requires_grad`` as it was (so that the rerun saves the
    same tensors as the forward did)."""
    tape = getattr(_LOCAL, "tape", None)
    if tape is None:
        return compute()
    if tape.replay:
        value = tape.values[tape.position]
        tape.position += 1
        return _thaw(value)
    value = compute()
    tape.values.append(_freeze(value))
    return value


def checkpoint(fn, *args):
    """``fn(*args)`` as a region whose saved tensors the backward pass
    recomputes, with a tape of its own (:func:`replayed`)."""
    tape = _Tape()
    return _checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (_on(tape, False), _on(tape, True)))


def policy():
    """The remat policy of the train forward this thread runs."""
    return getattr(_LOCAL, "policy", None)


def check_policy(name):
    if name not in POLICIES:
        raise ValueError(f"unknown remat policy '{name}'; "
                         "choose None, 'conv' or 'full'")


@contextlib.contextmanager
def using(name):
    """Run a train forward under the policy ``name`` in this thread."""
    check_policy(name)
    previous = policy()
    _LOCAL.policy = name
    try:
        yield
    finally:
        _LOCAL.policy = previous


def forward(model, x, generators, name):
    """A train forward ``model(x, generators)`` under the policy ``name``:
    ``'full'`` makes the whole call one region; ``'conv'`` lets each
    ConvBnRelu make its epilogue one."""
    if name == "full":
        return checkpoint(lambda v: model(v, generators), x)
    with using(name):
        return model(x, generators)
