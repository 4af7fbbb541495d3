"""The int8 convolution of the quantized U-Net sites: a hand-written CUDA
kernel (``rcu_tpu_torch/csrc/int8conv.cu``, an implicit GEMM on ``wgmma``
fed by TMA) and its plain PyTorch versions.

Two entry points run the one kernel:

- :func:`int8_conv`, the port of ``rcu_tpu/ops/quant.py:int8_conv`` (an
  XLA convolution with int32 accumulation): NHWC int8 input, int8 weights
  laid out (Cout, kh, kw, Cin) as ``ops.quant.quantize_weight`` gives them,
  stride 1, symmetric zero padding, an optional lhs dilation of 2, NHWC
  int32 out, exact;
- :func:`int8_conv_dequant`, a whole quantized conv site after its input
  is quantized (flax's ``_QuantConv``, the int8 branch of
  ``_SplitInputConv`` and ``_compensated_bias_add``): one input, or the two
  of a split pair, each with its int8 weights and its scale vector in the
  compute dtype, then the bias (or a folded site's two bias terms), out
  NHWC in the compute dtype, rounded as :func:`int8_conv_dequant_reference`
  rounds it. A split pair is two launches: the second adds its term to the
  first's output in place.

Each takes its plain version only for CPU tensors; on CUDA it launches the
kernel or raises (a failed build, tensor-map encode or launch too). The
kernel needs Cin a multiple of 16 and 16-byte aligned operands: the
wrapper pads the channels with zeros (the sums stay exact; to 32 at least)
or copies a misaligned view. ``int8_conv.launches`` counts the kernel's
launches from either entry point, ``int8_conv.plain_calls`` the plain int8
convolutions on the CPU (one per input of a site).
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.nn import functional as F

# the kernel's tile rows and columns, largest reduction step, threads,
# channel grain and operand alignment in bytes
_LAYOUT = (8, 16, 128, 288, 16, 16)
_GRAIN, _ALIGN = _LAYOUT[4:]
# narrower inputs are padded to 32 channels, the kernel's smaller step: a
# TMA box partly outside the tensor loads slower than a whole one
_MIN_CIN = 32
_OUT_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


@functools.cache
def _library():
    from rcu_tpu_torch.ops.cuda import build
    lib = build.load("int8conv")
    layout = (ctypes.c_int * len(_LAYOUT))()
    lib.rcu_int8_conv_layout.argtypes = [ctypes.c_void_p]
    lib.rcu_int8_conv_layout(layout)
    if tuple(layout) != _LAYOUT:
        raise RuntimeError(f"int8conv.cu layout {tuple(layout)} does not "
                           "match the Python wrapper")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rcu_int8_conv.argtypes = [ptr] * 7 + [i32] * 10 + [ptr]
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


def int8_conv_dequant_reference(terms, bias, padding: int,
                                lhs_dilation: int = 1, lo=None):
    """Plain version of :func:`int8_conv_dequant`, the eager chain of the
    quantized sites: each term's int32 conv to f32 (one rounding), to the
    compute dtype (a second one, as XLA and torch convert int32 to bf16),
    times its scale; the terms added in order; then ``+ bias`` and
    ``+ lo``, each op rounded to the compute dtype."""
    y = None
    for x_q, w_q, scale in terms:
        t = int8_conv_reference(x_q, w_q, padding, lhs_dilation).float() \
            .to(scale.dtype) * scale
        y = t if y is None else y + t
    if bias is not None:
        y = y + bias
    if lo is not None:
        y = y + lo
    return y


def _check(x_q, w_q, lhs_dilation):
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"int8_conv takes int8 tensors, got {x_q.dtype} and "
                        f"{w_q.dtype}")
    if x_q.dim() != 4 or w_q.dim() != 4 or x_q.shape[3] != w_q.shape[3]:
        raise ValueError(f"x (N, H, W, Cin) {tuple(x_q.shape)} and w (Cout, "
                         f"kh, kw, Cin) {tuple(w_q.shape)} do not match")
    if lhs_dilation not in (1, 2):
        raise ValueError(f"lhs_dilation is 1 or 2, got {lhs_dilation}")


def _out_shape(x_q, w_q, padding, lhs_dilation):
    n, h, w, _ = x_q.shape
    cout, kh, kw, _ = w_q.shape
    ho = output_size(h, kh, padding, lhs_dilation)
    wo = output_size(w, kw, padding, lhs_dilation)
    if ho < 1 or wo < 1 or padding < 0:
        raise ValueError(f"no output: {h}x{w} input, {kh}x{kw} kernel, "
                         f"padding {padding}, lhs dilation {lhs_dilation}")
    return n, ho, wo, cout


def _on_cuda(tensors):
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    devices = {t.device for t in tensors if t is not None}
    device = next(iter(devices))
    if len(devices) != 1 or device.type not in ("cpu", "cuda"):
        raise ValueError(f"int8_conv runs on cuda or cpu, all operands on "
                         f"one device, not {sorted(map(str, devices))}")
    return device.type == "cuda"


def _kernel_operands(x_q, w_q):
    """``x_q`` and ``w_q`` as the kernel takes them: Cin a multiple of 16
    and at least 32, 16-byte aligned; zero channels appended (the sums stay
    exact) and a misaligned view copied."""
    if not (x_q.is_contiguous() and w_q.is_contiguous()):
        raise ValueError("int8_conv needs contiguous NHWC x and (Cout, kh, "
                         "kw, Cin) w on cuda")
    cin = x_q.shape[3]
    extra = max(_MIN_CIN, -(-cin // _GRAIN) * _GRAIN) - cin

    def aligned(t):
        if extra:
            return F.pad(t, (0, extra))
        return t.clone() if t.data_ptr() % _ALIGN else t

    return aligned(x_q), aligned(w_q)


def _launch(x_q, w_q, y, padding, lhs_dilation, scale=None, bias=None,
            lo=None, prior=None):
    x_q, w_q = _kernel_operands(x_q, w_q)
    n, h, w, cin = x_q.shape
    cout, kh, kw, _ = w_q.shape
    vectors = [None if v is None else v.contiguous()
               for v in (scale, bias, lo)]
    address = [None if t is None else t.data_ptr()
               for t in (x_q, w_q, y, prior, *vectors)]
    device = y.device.index if y.device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = _library().rcu_int8_conv(
            *address, _OUT_KIND[y.dtype], n, h, w, cin, cout, kh, kw,
            padding, lhs_dilation, stream)
    if err == -1:
        raise RuntimeError("int8_conv: the CUDA driver has no "
                           "cuTensorMapEncodeTiled")
    if err <= -1000:
        raise RuntimeError(f"int8_conv: a TMA tensor map did not encode "
                           f"(CUresult {-1000 - err})")
    if err != 0:
        raise RuntimeError(f"int8_conv launch failed: cudaError {err}")
    int8_conv.launches += 1


def int8_conv(x_q, w_q, padding: int, lhs_dilation: int = 1):
    """``x_q`` (N, H, W, Cin) int8, ``w_q`` (Cout, kh, kw, Cin) int8 ->
    (N, Ho, Wo, Cout) int32, exact. On CUDA both must be contiguous."""
    _check(x_q, w_q, lhs_dilation)
    shape = _out_shape(x_q, w_q, padding, lhs_dilation)
    if not _on_cuda([x_q, w_q]):
        int8_conv.plain_calls += 1
        return int8_conv_reference(x_q, w_q, padding, lhs_dilation)
    y = torch.empty(shape, dtype=torch.int32, device=x_q.device)
    _launch(x_q, w_q, y, padding, lhs_dilation)
    return y


def int8_conv_dequant(terms, bias, padding: int, lhs_dilation: int = 1,
                      lo=None):
    """A quantized conv site: ``terms`` is one ``(x_q, w_q, scale)`` or the
    two of a split pair, with ``x_q`` (N, H, W, Cin) int8, ``w_q`` (Cout,
    kh, kw, Cin) int8 and ``scale`` the (Cout,) vector ``(w_scale *
    f32(a_scale))`` in the compute dtype (bf16 or f32); ``bias`` (Cout,)
    in that dtype or None; ``lo`` None, or in bf16 the second of a
    BN-folded site's two bias terms (``bias`` the first).
    Returns (N, Ho, Wo, Cout) in the compute dtype: the terms' dequantized
    products added in order, then ``+ bias``, then ``+ lo``, each op
    rounded as :func:`int8_conv_dequant_reference` rounds it."""
    if len(terms) not in (1, 2):
        raise ValueError(f"a site has one input or a split pair, got "
                         f"{len(terms)}")
    dtype = terms[0][2].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the compute dtype is bfloat16 or float32, got "
                        f"{dtype}")
    shape = None
    for x_q, w_q, scale in terms:
        _check(x_q, w_q, lhs_dilation)
        term_shape = _out_shape(x_q, w_q, padding, lhs_dilation)
        if shape is not None and term_shape != shape:
            raise ValueError(f"split pair outputs {shape} and {term_shape} "
                             "differ")
        shape = term_shape
        for name, v in (("scale", scale), ("bias", bias), ("lo", lo)):
            if v is not None and (v.dtype != dtype
                                  or tuple(v.shape) != (shape[3],)):
                raise ValueError(f"{name} must be ({shape[3]},) {dtype}, got "
                                 f"{tuple(v.shape)} {v.dtype}")
    if lo is not None and dtype != torch.bfloat16:
        raise ValueError(f"lo, a folded site's second bias term, is bf16 "
                         f"only; the compute dtype is {dtype}")
    if not _on_cuda([t for term in terms for t in term] + [bias, lo]):
        int8_conv.plain_calls += len(terms)
        return int8_conv_dequant_reference(terms, bias, padding,
                                           lhs_dilation, lo)
    y = torch.empty(shape, dtype=dtype, device=terms[0][0].device)
    last = len(terms) - 1
    for i, (x_q, w_q, scale) in enumerate(terms):
        _launch(x_q, w_q, y, padding, lhs_dilation, scale,
                bias if i == last else None, lo if i == last else None,
                y if i else None)
    return y


int8_conv.launches = 0
int8_conv.plain_calls = 0
