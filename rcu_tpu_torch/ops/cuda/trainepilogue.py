"""The epilogue of a U-Net ``ConvBnRelu`` site in train mode, forward and
backward: conv bias, channel dropout, flax's batch-statistics BatchNorm and
ReLU in four hand-written CUDA passes (``rcu_tpu_torch/csrc/
trainepilogue.cu``) over the f32 bias-free conv output, and its plain
PyTorch version.

It replaces no TPU kernel (XLA fused the chain and its gradient there).
:func:`train_epilogue` is a ``torch.autograd.Function`` whose forward is
two kernels (the per-channel sums of the batch, then normalize, shift and
ReLU) and whose backward is two (the per-channel sums of the gradient, then
the conv output's gradient with the conv bias's sums); between the two
forward kernels the per-channel constants and the running statistics come
from the (C)-sized torch ops of the eager chain (:func:`batch_constants`),
so that they are bitwise the eager chain's for the same sums. It refuses
anything the kernels do not take, CPU tensors included (a CPU site keeps
the module's eager chain); :func:`train_epilogue_reference` is the same
function with each kernel's formula written as plain torch ops, which the
tests hold against the eager chain's autograd and the kernels against.

``train_epilogue.launches`` counts kernel launches (two a forward, two a
backward). While a profiler runs, each launch adds the bytes it moves
(4 B an element for the sums, 8 to normalize, 8 for the gradient's sums,
12 for the gradient) to the counter ``unet.train_epilogue_bytes``.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from rcu_tpu_torch.utils import profiling

KERNEL = "rcu_train_epilogue_"  # the four kernels' common name prefix
_STATS, _APPLY, _GRAD_SUMS, _GRAD_APPLY = range(4)
# bytes an element of each stage: read c; read c, write y; read g and c;
# read g and c, write dc
_STAGE_BYTES = (4, 8, 8, 12)


class _Args(ctypes.Structure):
    """``TrainEpilogueArgs`` of ``csrc/trainepilogue.cu``, field for field."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "c", "g", "out", "bias", "divisor", "mean", "mul", "shift", "gamma",
        "rstd", "inner", "sg", "sgz")] + [
        ("chan", ctypes.c_void_p * 3), ("partials", ctypes.c_void_p),
        ("tickets", ctypes.c_void_p), ("rows", ctypes.c_longlong),
        ("channels", ctypes.c_longlong), ("plane", ctypes.c_longlong),
        ("inv_count", ctypes.c_float), ("relu", ctypes.c_int)]


@functools.cache
def _library():
    from rcu_tpu_torch.ops.cuda import build
    lib = build.load("trainepilogue")
    lib.rcu_train_epilogue.argtypes = [ctypes.c_int, ctypes.POINTER(_Args),
                                       ctypes.c_void_p]
    lib.rcu_train_epilogue.restype = ctypes.c_int
    return lib


def batch_constants(s1, s2, n, bn, update=True):
    """flax's train-mode ``nn.BatchNorm`` (``use_fast_variance``, momentum
    0.9) from the per-channel sums ``s1`` of x and ``s2`` of x^2 over ``n``
    values: ``(mean, inner, rstd, mul)`` with ``inner = E[x^2] - E[x]^2``
    (the variance before its clamp at 0), ``rstd = rsqrt(max(inner, 0) +
    eps)`` and ``mul = rstd * bn.weight``, in flax's order of operations.
    With ``update`` it updates ``bn``'s running statistics in place
    (outside autograd) as ``0.9 * running + 0.1 * batch``, with the biased
    variance. The eager chain (``models.unet.batch_norm_train``) and both
    versions here take their constants from it."""
    mean = s1 / n
    inner = s2 / n - mean * mean
    var = torch.clamp_min(inner, 0.0)
    if update:
        with torch.no_grad():
            bn.running_mean.mul_(0.9).add_(0.1 * mean)
            bn.running_var.mul_(0.9).add_(0.1 * var)
    rstd = torch.rsqrt(var + bn.eps)
    return mean, inner, rstd, rstd * bn.weight


# -- the plain version: each kernel's formula as torch ops ----------------

def _channel(v):
    return v[:, None, None]


def _z(c, bias, divisor):
    z = c + _channel(bias)
    return z if divisor is None else z / divisor[:, :, None, None]


def _masked(g, pre, relu):
    """relu's backward (``threshold_backward``): no gradient where the
    ReLU's input is <= 0."""
    return torch.where(pre <= 0, 0.0, g) if relu else g


class _Plain:
    """The four stages in plain torch ops (see ``csrc/trainepilogue.cu``)."""

    @staticmethod
    def stats(c, bias, divisor):
        z = _z(c, bias, divisor)
        return z.sum((0, 2, 3)), (z * z).sum((0, 2, 3))

    @staticmethod
    def apply(c, bias, divisor, mean, mul, shift, relu):
        pre = (_z(c, bias, divisor) - _channel(mean)) * _channel(mul) \
            + _channel(shift)
        return torch.relu(pre) if relu else pre

    @staticmethod
    def grad_sums(g, c, bias, divisor, mean, mul, shift, rstd, relu):
        t = _z(c, bias, divisor) - _channel(mean)
        gm = _masked(g, t * _channel(mul) + _channel(shift), relu)
        sg, sgz = gm.sum((0, 2, 3)), (gm * t).sum((0, 2, 3))
        return sg, sgz, sgz * rstd

    @staticmethod
    def grad_apply(g, c, bias, divisor, mean, mul, shift, gamma, rstd,
                   inner, sg, sgz, relu, with_bias):
        t = _z(c, bias, divisor) - _channel(mean)
        gm = _masked(g, t * _channel(mul) + _channel(shift), relu)
        count = c.numel() // c.shape[1]
        scale = (gamma * rstd).expand(c.shape[:2])
        if divisor is not None:
            scale = scale / divisor
        b = torch.where(inner >= 0, rstd * rstd * sgz / count, 0.0)
        dc = scale[:, :, None, None] * (gm - _channel(sg / count)
                                        - t * _channel(b))
        return dc, (dc.sum((0, 2, 3)) if with_bias else None)


# -- the kernels -----------------------------------------------------------

def _ptr(x):
    return None if x is None else x.data_ptr()


def _launch(stage, c, bias, divisor, *, g=None, out=None, mean=None,
            mul=None, shift=None, gamma=None, rstd=None, inner=None, sg=None,
            sgz=None, chan=(), relu=False):
    rows, channels, h, w = c.shape
    stream = torch.cuda.current_stream(c.device).cuda_stream
    args = _Args(*(_ptr(x) for x in (c, g, out, bias, divisor, mean, mul,
                                     shift, gamma, rstd, inner, sg, sgz)))
    for i, x in enumerate(chan):
        args.chan[i] = _ptr(x)
    if chan and chan[0] is not None:
        # the planes' partial sums, then the channels' tickets
        partials = rows * channels * (1 if stage == _GRAD_APPLY else 2)
        scratch = torch.empty(partials + channels, dtype=torch.float32,
                              device=c.device)
        args.partials = scratch.data_ptr()
        args.tickets = scratch.data_ptr() + 4 * partials
    args.rows, args.channels, args.plane = rows, channels, h * w
    args.inv_count = 1.0 / (rows * h * w)
    args.relu = int(relu)
    with torch.cuda.device(c.device):
        err = _library().rcu_train_epilogue(stage, ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"train_epilogue stage {stage} launch failed: "
                           f"cudaError {err}")
    train_epilogue.launches += 1
    profiling.count("unet.train_epilogue_bytes",
                    _STAGE_BYTES[stage] * c.numel())


def _vector(c):
    return torch.empty(c.shape[1], dtype=torch.float32, device=c.device)


class _Kernels:
    """The four stages as launches of ``csrc/trainepilogue.cu``."""

    @staticmethod
    def stats(c, bias, divisor):
        sums = torch.empty(2, c.shape[1], dtype=torch.float32, device=c.device)
        _launch(_STATS, c, bias, divisor, chan=sums.unbind())
        return sums.unbind()

    @staticmethod
    def apply(c, bias, divisor, mean, mul, shift, relu):
        y = torch.empty_like(c)
        _launch(_APPLY, c, bias, divisor, out=y, mean=mean, mul=mul,
                shift=shift, relu=relu)
        return y

    @staticmethod
    def grad_sums(g, c, bias, divisor, mean, mul, shift, rstd, relu):
        out = (_vector(c), _vector(c), _vector(c))
        _launch(_GRAD_SUMS, c, bias, divisor, g=g, mean=mean, mul=mul,
                shift=shift, rstd=rstd, chan=out, relu=relu)
        return out

    @staticmethod
    def grad_apply(g, c, bias, divisor, mean, mul, shift, gamma, rstd,
                   inner, sg, sgz, relu, with_bias):
        dc = torch.empty_like(c)
        dbias = _vector(c) if with_bias else None
        _launch(_GRAD_APPLY, c, bias, divisor, g=g, out=dc, mean=mean,
                mul=mul, shift=shift, gamma=gamma, rstd=rstd, inner=inner,
                sg=sg, sgz=sgz, chan=(dbias,), relu=relu)
        return dc, dbias


class _Epilogue(torch.autograd.Function):
    """The train-mode epilogue on ``c`` with ``stages`` (:class:`_Kernels`
    or :class:`_Plain`). It saves ``c`` and (C)-sized constants; the
    backward recomputes z and the ReLU's mask from ``c``."""

    @staticmethod
    def forward(ctx, c, bias, divisor, weight, shift, bn, relu, stages):
        s1, s2 = stages.stats(c, bias, divisor)
        mean, inner, rstd, mul = batch_constants(
            s1, s2, c.numel() // c.shape[1], bn)
        ctx.save_for_backward(c, bias, divisor, weight, shift, mean, mul,
                              rstd, inner)
        ctx.relu, ctx.stages = relu, stages
        return stages.apply(c, bias, divisor, mean, mul, shift, relu)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        c, bias, divisor, weight, shift, mean, mul, rstd, inner = \
            ctx.saved_tensors
        g = g.contiguous()
        sg, sgz, dweight = ctx.stages.grad_sums(
            g, c, bias, divisor, mean, mul, shift, rstd, ctx.relu)
        dc, dbias = ctx.stages.grad_apply(
            g, c, bias, divisor, mean, mul, shift, weight, rstd, inner, sg,
            sgz, ctx.relu, ctx.needs_input_grad[1])
        return dc, dbias, None, dweight, sg, None, None, None


def train_epilogue_reference(c, bias, divisor, bn, relu=True):
    """Plain PyTorch version of :func:`train_epilogue`, differentiable in
    ``c``, ``bias`` and ``bn``'s affine weights: ``c`` (N, C, H, W) plus
    ``bias`` (C), divided by ``divisor`` (N, C) where given, normalized
    with the batch statistics by the train-mode BatchNorm ``bn`` (whose
    running statistics it updates), then ReLU where ``relu``."""
    return _Epilogue.apply(c, bias, divisor, bn.weight, bn.bias, bn, relu,
                           _Plain)


def _check_cuda_inputs(c, bias, divisor, bn):
    if c.dtype != torch.float32:
        raise TypeError(f"train_epilogue takes float32, got {c.dtype}")
    if c.dim() != 4:
        raise ValueError(f"c must be (N, C, H, W), got shape {tuple(c.shape)}")
    if not c.is_contiguous():
        raise ValueError("c must be NCHW-contiguous")
    n, channels, h, w = c.shape
    if n * channels >= 2 ** 31 or h * w >= 2 ** 31 or c.numel() == 0:
        raise ValueError(f"shape {tuple(c.shape)}: the kernels take fewer "
                         "than 2^31 planes of fewer than 2^31 elements, and "
                         "no empty tensor")
    wanted = {"bias": (bias, (channels,))}
    if divisor is not None:
        wanted["divisor"] = (divisor, (n, channels))
    for name in ("weight", "bias", "running_mean", "running_var"):
        wanted[f"bn.{name}"] = (getattr(bn, name), (channels,))
    for name, (x, shape) in wanted.items():
        if x.device != c.device:
            raise ValueError(f"{name} is on {x.device}, c on {c.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape}, got "
                             f"{tuple(x.shape)}")


def train_epilogue(c, bias, divisor, bn, relu=True):
    """``train_epilogue_reference(c, bias, divisor, bn, relu)`` by the
    kernels on the current stream: two launches forward, two backward.

    ``c`` float32, (N, C, H, W) NCHW-contiguous, on a CUDA device;
    ``bias`` (C), ``divisor`` (N, C) and ``bn``'s tensors (C) float32,
    contiguous, on ``c``'s device."""
    if c.device.type != "cuda":
        raise ValueError(f"train_epilogue runs on cuda, not {c.device}")
    _check_cuda_inputs(c, bias, divisor, bn)
    return _Epilogue.apply(c, bias, divisor, bn.weight, bn.bias, bn, relu,
                           _Kernels)


train_epilogue.launches = 0
