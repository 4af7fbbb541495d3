"""Device helpers shared by the port's entry points (the direct eval, the
test and train loops, the inference service): the float32 policy and the
one-copy fetch of a dispatch's results."""
from __future__ import annotations

import contextlib
import math

import torch


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


@contextlib.contextmanager
def full_float32():
    """cuDNN and matmul TF32 off within the block; the caller's flags come
    back afterwards, also on error."""
    switches = fp32_switches()
    saved = [getattr(holder, name) for holder, name, _ in switches]
    for holder, name, value in switches:
        setattr(holder, name, value)
    try:
        yield
    finally:
        for (holder, name, _), value in zip(switches, saved):
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


class Fetch:
    """The eval results of one dispatch on their way to the host in ONE
    device-to-host copy: every leaf's bytes packed into one uint8 buffer
    on the device, queued right after the work that makes them, then
    copied into pinned host memory without blocking (on the CPU the packed
    buffer is the host copy). :meth:`result` waits for that copy only and
    unpacks the leaves as numpy arrays, in the tree's shape."""

    def __init__(self, tree):
        # the widest leaves first: every leaf then starts at a multiple of
        # its own element size in the buffer
        leaves = sorted(((path, leaf.detach().contiguous())
                         for path, leaf in _flatten(tree)),
                        key=lambda pl: -pl[1].element_size())
        self.spec = [(path, leaf.dtype, tuple(leaf.shape))
                     for path, leaf in leaves]
        packed = torch.cat([_flat(leaf).view(torch.uint8)
                            for _, leaf in leaves])
        self.event = None
        if packed.device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=torch.uint8,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed

    def result(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        out, offset = {}, 0
        for path, dtype, shape in self.spec:
            size = math.prod(shape) * dtype.itemsize
            leaf = self.host[offset:offset + size].view(dtype).reshape(shape)
            offset += size
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf.numpy().copy()
        return out
