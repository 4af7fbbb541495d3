"""The int8 convolution of the quantized U-Net sites: a hand-written CUDA
kernel (``rcu_tpu_torch/csrc/int8conv.cu``, an implicit GEMM on the tensor
cores) and its plain PyTorch version.

Port of ``rcu_tpu/ops/quant.py:int8_conv`` (an XLA convolution with int32
accumulation): NHWC int8 input, int8 weights laid out (Cout, kh, kw, Cin)
as ``ops.quant.quantize_weight`` gives them, stride 1, symmetric zero
padding, an optional lhs dilation of 2, NHWC int32 out. :func:`int8_conv`
launches the kernel for CUDA tensors and takes :func:`int8_conv_reference`
only for CPU tensors; anything else raises, and a failed build or launch
raises too. ``int8_conv.launches`` counts kernel launches and
``int8_conv.plain_calls`` the CPU calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

_LAYOUT = (128, 64, 32, 256)  # the kernel's BM, BN, BK, threads
_VECTOR = 16  # bytes of one vector load


@functools.cache
def _library():
    from rcu_tpu_torch.ops.cuda import build
    lib = build.load("int8conv")
    layout = (ctypes.c_int * 4)()
    lib.rcu_int8_conv_layout.argtypes = [ctypes.c_void_p]
    lib.rcu_int8_conv_layout(layout)
    if tuple(layout) != _LAYOUT:
        raise RuntimeError(f"int8conv.cu layout {tuple(layout)} does not "
                           "match the Python wrapper")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rcu_int8_conv.argtypes = [ptr, ptr, ptr] + [i32] * 10 + [ptr]
    lib.rcu_int8_conv.restype = ctypes.c_int
    return lib


def output_size(size: int, kernel: int, padding: int, lhs_dilation: int) -> int:
    """An output side: the dilated input, padded on both sides, less the
    kernel, plus one."""
    return (size - 1) * lhs_dilation + 1 + 2 * padding - kernel + 1


def dilate(x: torch.Tensor, lhs_dilation: int) -> torch.Tensor:
    """NHWC ``x`` with ``lhs_dilation - 1`` zeros between neighbouring rows
    and columns."""
    if lhs_dilation == 1:
        return x
    n, h, w, c = x.shape
    out = x.new_zeros((n, (h - 1) * lhs_dilation + 1,
                       (w - 1) * lhs_dilation + 1, c))
    out[:, ::lhs_dilation, ::lhs_dilation] = x
    return out


def int8_conv_reference(x_q, w_q, padding: int, lhs_dilation: int = 1):
    """Plain version: the zero-spread input, then ``F.conv2d`` in float64,
    which is exact (every product and partial sum is an integer below
    2^53), converted to int32."""
    x = dilate(x_q, lhs_dilation).permute(0, 3, 1, 2).double()
    w = w_q.permute(0, 3, 1, 2).double()
    y = F.conv2d(x, w, padding=padding)
    return y.to(torch.int32).permute(0, 2, 3, 1).contiguous()


def _check(x_q, w_q, lhs_dilation):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 tensors, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4 or x_q.shape[3] != w_q.shape[3]:
        raise ValueError(f"x (N, H, W, Cin) {tuple(x_q.shape)} and w (Cout, "
                         f"kh, kw, Cin) {tuple(w_q.shape)} do not match")
    if lhs_dilation not in (1, 2):
        raise ValueError(f"lhs_dilation is 1 or 2, got {lhs_dilation}")


def int8_conv(x_q, w_q, padding: int, lhs_dilation: int = 1):
    """``x_q`` (N, H, W, Cin) int8, ``w_q`` (Cout, kh, kw, Cin) int8 ->
    (N, Ho, Wo, Cout) int32, exact. On CUDA both must be contiguous."""
    _check(x_q, w_q, lhs_dilation)
    if x_q.device.type == "cpu":
        int8_conv.plain_calls += 1
        return int8_conv_reference(x_q, w_q, padding, lhs_dilation)
    if x_q.device.type != "cuda" or w_q.device != x_q.device:
        raise ValueError(f"int8_conv runs on cuda or cpu, not x on "
                         f"{x_q.device} and w on {w_q.device}")
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("int8_conv needs contiguous NHWC x and (Cout, kh, "
                         "kw, Cin) w on cuda")
    n, h, w, cin = x_q.shape
    cout, kh, kw, _ = w_q.shape
    ho = output_size(h, kh, padding, lhs_dilation)
    wo = output_size(w, kw, padding, lhs_dilation)
    if ho < 1 or wo < 1:
        raise ValueError(f"no output: {h}x{w} input, {kh}x{kw} kernel, "
                         f"padding {padding}, lhs dilation {lhs_dilation}")
    y = torch.empty((n, ho, wo, cout), dtype=torch.int32, device=x_q.device)
    vec = int(cin % _VECTOR == 0 and x_q.data_ptr() % _VECTOR == 0
              and w_q.data_ptr() % _VECTOR == 0)
    device = x_q.device.index if x_q.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().rcu_int8_conv(
            x_q.data_ptr(), w_q.data_ptr(), y.data_ptr(), n, h, w, cin, cout,
            kh, kw, padding, lhs_dilation, vec, stream)
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: cudaError {err}")
    int8_conv.launches += 1
    return y


int8_conv.launches = 0
int8_conv.plain_calls = 0
