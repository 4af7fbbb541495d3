"""The epilogue of a U-Net ``ConvBnRelu`` site in eval mode: conv bias,
channel dropout, BatchNorm and ReLU in one hand-written CUDA pass
(``rcu_tpu_torch/csrc/convepilogue.cu``) over the f32 conv output, in place,
and its plain PyTorch version.

It replaces no TPU kernel (XLA fused the chain there). :func:`conv_epilogue`
launches the kernel and refuses anything it does not take, CPU tensors
included (a CPU site keeps the module's eager chain);
:func:`conv_epilogue_reference` is the plain version that the tests hold it
against. ``conv_epilogue.launches`` counts kernel launches (one a call).

On the card the kernel is bitwise its plain version: both take the
BatchNorm's constants from :func:`bn_constants`, and the kernel rounds
every step on its own, as the plain version's separate torch ops do.
"""
from __future__ import annotations

import ctypes
import functools

import torch

KERNEL = "rcu_conv_epilogue_kernel"  # the kernel's name in a device trace
BYTES_PER_ELEMENT = 8  # each element read once and written once, f32
_ALIGN = 16  # the kernel's float4 loads and stores


@functools.cache
def _library():
    from rcu_tpu_torch.ops.cuda import build
    lib = build.load("convepilogue")
    ptr = ctypes.c_void_p
    lib.rcu_conv_epilogue.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ptr]
    lib.rcu_conv_epilogue.restype = ctypes.c_int
    return lib


def bn_constants(bn):
    """(mean, scale, shift) of the eval-mode BatchNorm ``bn``: ``scale =
    weight * rsqrt(running_var + eps)``, computed at each call (as the
    benchmark's plain U-Net computes it), so that the weights may change
    between calls."""
    return (bn.running_mean, bn.weight * torch.rsqrt(bn.running_var + bn.eps),
            bn.bias)


def conv_epilogue_reference(y, bias, divisor=None, bn=None, relu=True):
    """Plain PyTorch version of the kernel, one op a step: ``y`` (N, C, H,
    W) plus ``bias`` (C), divided by ``divisor`` (N, C) where given,
    normalized by the eval-mode BatchNorm ``bn`` where given
    (:func:`bn_constants`), then ReLU where ``relu``. Returns a new
    tensor."""
    t = y + bias[:, None, None]
    if divisor is not None:
        t = t / divisor[:, :, None, None]
    if bn is not None:
        mean, scale, shift = bn_constants(bn)
        t = (t - mean[:, None, None]) * scale[:, None, None] \
            + shift[:, None, None]
    return torch.relu(t) if relu else t


def _check_cuda_inputs(y, bias, divisor, constants):
    if y.dtype != torch.float32:
        raise TypeError(f"conv_epilogue takes float32, got {y.dtype}")
    if y.dim() != 4:
        raise ValueError(f"y must be (N, C, H, W), got shape {tuple(y.shape)}")
    if not y.is_contiguous():
        raise ValueError("y must be NCHW-contiguous")
    if y.data_ptr() % _ALIGN:
        raise ValueError(f"y must be {_ALIGN}-byte aligned for the kernel's "
                         "vector loads")
    n, c = y.shape[:2]
    if y[0].numel() >= 2 ** 31:
        raise ValueError(f"a row of {y[0].numel()} elements; the kernel "
                         "takes fewer than 2^31")
    wanted = {"bias": (bias, (c,))}
    if divisor is not None:
        wanted["divisor"] = (divisor, (n, c))
    for name, x in zip(("mean", "scale", "shift"), constants):
        wanted[name] = (x, (c,))
    for name, (x, shape) in wanted.items():
        if x.device != y.device:
            raise ValueError(f"{name} is on {x.device}, y on {y.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got "
                             f"{tuple(x.shape)}")


def conv_epilogue(y, bias, divisor=None, bn=None, relu=True):
    """``conv_epilogue_reference(y, bias, divisor, bn, relu)`` in place on
    ``y`` by one kernel launch on the current stream, returning ``y``.

    ``y`` float32, (N, C, H, W) NCHW-contiguous, 16-byte aligned, on a CUDA
    device; ``bias`` (C), ``divisor`` (N, C) and ``bn``'s tensors (C)
    float32, contiguous, on ``y``'s device."""
    if y.device.type != "cuda":
        raise ValueError(f"conv_epilogue runs on cuda, not {y.device}")
    constants = () if bn is None else bn_constants(bn)
    _check_cuda_inputs(y, bias, divisor, constants)
    n, c, h, w = y.shape
    lib = _library()
    ptrs = [None if x is None else x.data_ptr()
            for x in (divisor, *(constants or (None,) * 3))]
    with torch.cuda.device(y.device):
        err = lib.rcu_conv_epilogue(
            y.data_ptr(), bias.data_ptr(), *ptrs, n, c, h * w, int(relu),
            torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_epilogue launch failed: cudaError {err}")
    conv_epilogue.launches += 1
    return y


conv_epilogue.launches = 0
