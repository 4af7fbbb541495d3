"""Device helpers shared by the port's entry points (the direct eval, the
test and train loops, the inference service): the float32 policy and the
one-copy fetch of a dispatch's results."""
from __future__ import annotations

import contextlib
import math
import threading

import torch

from rcu_tpu_torch.parallel.mesh import Sharded


def fp32_switches():
    """(holder, attribute, float32 value) of each switch that decides
    whether cuDNN's convolutions and cuBLAS's matmuls may round float32
    to TF32: the ``allow_tf32`` flags and, on a PyTorch that has them,
    the ``fp32_precision`` ones, legacy first."""
    backends = torch.backends
    switches = [(backends.cudnn, "allow_tf32", False),
                (backends.cuda.matmul, "allow_tf32", False)]
    for holder in (getattr(backends.cudnn, "conv", None),
                   backends.cuda.matmul):
        if holder is not None and hasattr(holder, "fp32_precision"):
            switches.append((holder, "fp32_precision", "ieee"))
    return switches


_FP32 = {"lock": threading.Lock(), "users": 0, "saved": None}


@contextlib.contextmanager
def full_float32():
    """cuDNN and matmul TF32 off within the block; the caller's flags come
    back afterwards, also on error. The flags are global to the process:
    while blocks of several threads overlap (a mesh's devices, a
    service's concurrent requests), the flags stay off until the last
    one leaves, which restores the flags the first one found."""
    with _FP32["lock"]:
        if _FP32["users"] == 0:
            switches = fp32_switches()
            _FP32["saved"] = [(holder, name, getattr(holder, name))
                              for holder, name, _ in switches]
            for holder, name, value in switches:
                setattr(holder, name, value)
        _FP32["users"] += 1
    try:
        yield
    finally:
        with _FP32["lock"]:
            _FP32["users"] -= 1
            if _FP32["users"] == 0:
                for holder, name, value in _FP32["saved"]:
                    setattr(holder, name, value)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _flatten(value, prefix + (key,))
    else:
        yield prefix, tree


def _flat(leaf):
    """A contiguous tensor as 1-D with unit stride (a one-element slice of
    a row keeps the row's stride through ``contiguous``)."""
    flat = leaf.reshape(-1)
    return flat.as_strided((1,), (1,)) if flat.numel() == 1 else flat


class _Copy:
    """One device's leaves in one uint8 buffer, copied to the host without
    blocking (on the CPU the packed buffer is the host copy)."""

    def __init__(self, leaves):
        # the widest leaves first: every leaf then starts at a multiple of
        # its own element size in the buffer
        leaves = sorted(leaves, key=lambda kl: -kl[1].element_size())
        self.spec = [(key, leaf.dtype, tuple(leaf.shape))
                     for key, leaf in leaves]
        packed = torch.cat([_flat(leaf).view(torch.uint8)
                            for _, leaf in leaves])
        self.event = None
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=torch.uint8,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(packed.device))
        else:
            self.host = packed

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        out, offset = {}, 0
        for key, dtype, shape in self.spec:
            size = math.prod(shape) * dtype.itemsize
            leaf = self.host[offset:offset + size].view(dtype).reshape(shape)
            offset += size
            out[key] = leaf.numpy().copy()
        return out


class Fetch:
    """The eval results of one dispatch on their way to the host in ONE
    device-to-host copy per device: each device's leaves packed into one
    uint8 buffer there, queued right after the work that makes them, then
    copied into pinned host memory without blocking. A
    ``parallel.Sharded`` leaf (a map held on several devices) goes with
    each device's copy and is joined in row order on the host.
    :meth:`result` waits for those copies only and unpacks the leaves as
    numpy arrays, in the tree's shape."""

    def __init__(self, tree):
        self.sharded = {}
        groups = {}
        for path, leaf in _flatten(tree):
            if isinstance(leaf, Sharded):
                self.sharded[path] = leaf._replace(parts=len(leaf.parts))
                parts = [((path, d), part)
                         for d, part in enumerate(leaf.parts)
                         if part is not None]
            else:
                parts = [((path, None), leaf)]
            for key, part in parts:
                part = part.detach().contiguous()
                groups.setdefault(part.device, []).append((key, part))
        self.copies = [_Copy(leaves) for leaves in groups.values()]

    def result(self) -> dict:
        leaves = {}
        for copy in self.copies:
            leaves.update(copy.result())
        out = {}
        for (path, part), value in leaves.items():
            if part is None:
                _put(out, path, value)
        for path, sharded in self.sharded.items():
            _put(out, path, sharded.join(
                [leaves.get((path, d)) for d in range(sharded.parts)]))
        return out


def _put(tree, path, value):
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value
