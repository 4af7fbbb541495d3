"""The 2D U-Net and PostNet of ``rcu_tpu.models.unet`` as PyTorch modules,
in float32 and in the JAX package's inference variants.

Modules are NCHW inside, as PyTorch's convolutions want; the public
functions around them (``engine.steps``, ``eval.pipeline``) take NHWC like
the JAX package. Both return a :class:`UNetOutput`, as the flax modules do.
Submodule names mirror flax's (U-Net: ``ConvBlock_0..2d``, or
``ConvResidualBlock_0..2d`` with their 1x1 ``Conv_0``, ``Conv_0..d-1``
up-convs, ``ConvBnRelu_0`` head, ``Conv_d`` class conv, and with the sigma
head ``ConvBnRelu_1`` and ``Conv_{d+1}``; PostNet: ``ConvBnRelu_0..n-1``
and the ``Conv_0`` head), so ``models.convert`` maps a flax tree onto
``state_dict`` by name.

Dropout is flax's channel dropout (``broadcast_dims=(1, 2)`` on NHWC): one
keep/drop draw per (image, channel), kept values divided by ``1 - p``. It
is active when the forward gets ``generators``, one ``torch.Generator`` per
MC sample: the input batch is ``T`` sample-major copies of the images, and
every dropout site draws sample ``t``'s ``(B, C)`` mask from
``generators[t]``. A sample's stream therefore does not depend on how many
other samples ride the same forward. BatchNorm always uses its running
statistics (eps 1e-5) in eval mode, under MC dropout as in flax. In
train mode (:meth:`UNet.train`, float32 or bfloat16 models without the
fold or int8) it is flax's ``nn.BatchNorm(momentum=0.9)``: the batch
statistics ``E[x]`` and ``E[x^2] - E[x]^2`` (clipped at 0), and the
running statistics updated with that biased variance
(:func:`batch_norm_train`; an f32 site on a card runs the same function in
the kernels of ``ops.cuda.trainepilogue``). A training step passes its one
generator as ``generators=[g]``; a bf16 model trains with float32
parameters, each conv casting its weights at the call (autograd casts
their gradients back to float32, as flax's ``promote_dtype`` does).

The inference variants keep flax's dtype islands and rewrites:
- ``dtype`` (compute dtype, ``torch.bfloat16`` or float32): the input is
  cast to it; convs run in it; BatchNorm normalizes in f32 against its f32
  statistics and returns the compute dtype; dropout runs in it; the class
  conv runs in it and only its output is cast to f32. The sigma head and
  the PostNet's ``Conv_0`` always run in f32, on their input cast to f32.
  Weights may stay f32 and are cast at each call, or be cast once at load
  (:func:`precast_params`) with bitwise the same outputs;
- ``split_decoder_concat``: a decoder block's first conv runs over the
  up-conv output and the skip as two convs over the kernel's input-channel
  halves, added, with no concatenation;
- ``fused_upsample``: ``conv3x3(nearest_up_2x(x))`` as one transposed conv
  with the 3x3 kernel folded into 4x4 (:func:`upsample_conv`): the
  upsample equals a 2x zero-stuffing followed by a 2x2 box filter, and
  the box folds into the kernel;
- ``fold_bn``: the BatchNorms were folded into their convs at load
  (``models.convert.fold_bn_params``), so no ConvBnRelu has a
  ``BatchNorm_0``; a folded conv's bias carries the BN centering term and
  is added with f32 precision as two terms (:func:`bias_terms`). Valid
  only without active dropout, so a folded model given generators raises;
- ``quant_scales`` (int8 PTQ, ``ops.quant``): every 3x3 trunk conv of the
  levels from ``quant_skip_levels`` on (down, bottom and up blocks, the
  up-convs, the head's ``ConvBnRelu_0``) quantizes its input with the
  site's calibrated scale and runs ``ops.cuda.int8conv.int8_conv_dequant``
  against int8 weights quantized per output channel: the int32 conv, then
  flax's dequantize into the compute dtype and the bias, rounded as flax
  rounds them (:func:`int8_conv_out`); dropout, BatchNorm and ReLU follow
  unchanged. A split pair quantizes each kernel half and
  each input on its own and adds the two dequantized products; a fused
  up-conv folds its kernel to 4x4 in f32, then quantizes it, and runs the
  lhs-dilated conv (padding 2, no flip). The 1x1 class and sigma heads and
  the PostNet stay unquantized. The int8 weights are quantized once at
  load from the weights as they are then (:func:`quantize_weights`, after
  the fold and the precast, as the JAX package's direct eval orders it).

The modules keep the memory format of their input; ``engine.steps`` hands
a bf16 model channels-last tensors (cuDNN's tensor-core convolutions
read NHWC, and an NCHW tensor costs a transpose on each side of each
conv) and an f32 model NCHW ones. A forward may take a
``ops.quant.SiteStats`` collector (``stats``): every conv site reports its
input to it under its flax key, for a calibration or clip pass.
"""
from __future__ import annotations

import typing

import torch
from torch import nn
from torch.nn import functional as F

from rcu_tpu_torch.engine import remat
from rcu_tpu_torch.ops import quant
from rcu_tpu_torch.ops.precision import CONV_SEARCH
from rcu_tpu_torch.ops.cuda.convepilogue import (BYTES_PER_ELEMENT,
                                                 conv_epilogue)
from rcu_tpu_torch.ops.cuda.int8conv import int8_conv_dequant
from rcu_tpu_torch.ops.cuda.trainepilogue import (batch_constants,
                                                  train_epilogue)
from rcu_tpu_torch.parallel.mesh import all_sum, current_part
from rcu_tpu_torch.utils import profiling

# the production bundle of checkpoint-compatible decoder rewrites
# (``rcu_tpu`` unet.py:483)
FAST_DECODER_KWARGS = {"split_decoder_concat": True, "fused_upsample": True}


class UNetOutput(typing.NamedTuple):
    """NCHW logits; the sigma head's output and the decoder features where
    the model has them."""
    logits: torch.Tensor
    sigma: torch.Tensor | None = None
    features: torch.Tensor | None = None


class ChannelDropout(nn.Module):
    """flax ``nn.Dropout(p, broadcast_dims=(1, 2))`` with explicit
    generators. Generators with ``rows=(start, stop, total)``
    (``engine.steps.ShardGenerators``, a mesh device's part of a batch)
    draw the whole batch's masks and keep those rows."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generators=None, inplace=True):
        divisor = self.divisor(x, generators)
        if divisor is None:
            return x
        # where(keep, x / keep_prob, 0) as flax computes it, in one pass: a
        # dropped channel divides by inf (x is finite), and its gradient,
        # 1 / inf, is 0. In place under autograd too: x is a conv output,
        # which no backward reads (not in place where x is a remat region's
        # input, which its rerun reads again)
        divisor = divisor[:, :, None, None]
        return x.div_(divisor) if inplace else x / divisor

    def divisor(self, x, generators=None):
        """The (rows, C) divisor of ``x`` in its dtype: keep_prob rounded to
        x's dtype as flax rounds it, inf for a dropped channel; None where
        no dropout is active."""
        if generators is None or self.p == 0.0:
            return None
        # drawn once: a remat rerun replays the forward's divisor
        divisor = remat.replayed(lambda: self._divisor(x, generators))
        return divisor.to(x.dtype)

    def _divisor(self, x, generators):
        keep = 1.0 - self.p
        n, c = x.shape[0] // len(generators), x.shape[1]
        start, stop, total = getattr(generators, "rows", (0, n, n))
        if stop - start != n:
            raise ValueError(f"generators for rows {start}:{stop} of a "
                             f"batch, but the input has {n} rows a sample")
        masks = [torch.rand((total, c), generator=g,
                            device=x.device)[start:stop] < keep
                 for g in generators]
        return torch.where(torch.cat(masks), keep, float("inf"))


def batch_norm_train(x, bn):
    """flax's train-mode ``nn.BatchNorm`` (``use_fast_variance``, momentum
    0.9) on the NCHW ``x`` with ``bn``'s affine weights: normalizes with
    the batch mean and ``max(E[x^2] - E[x]^2, 0)``, in at least f32 (as
    flax promotes), in flax's order of operations, and updates ``bn``'s
    running statistics in place (outside autograd) as ``0.9 * running +
    0.1 * batch``, with the biased variance (``nn.BatchNorm2d`` would
    take the unbiased one): the constants of
    :func:`ops.cuda.trainepilogue.batch_constants`, which the fused train
    epilogue takes too.

    In a part of a mesh train step (``parallel.mesh.current_part``) the
    per-channel sums of x and x^2 are added over the parts first
    (``parallel.mesh.all_sum``) and ``n`` is the global count: every part
    normalizes with the whole batch's moments.

    In a remat region's rerun (``engine.remat``) the sums and the count are
    the forward's, replayed, and the running statistics are left alone:
    they change once a step."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    s1, s2 = xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3))
    s1, s2, n = remat.replayed(
        lambda: _batch_sums(s1, s2, xf.numel() // xf.shape[1]))
    mean, _, _, mul = batch_constants(s1, s2, n, bn,
                                      update=not remat.replaying())
    y = (xf - mean[:, None, None]) * mul[:, None, None] + bn.bias[:, None, None]
    return y.to(x.dtype)


def _batch_sums(s1, s2, n):
    """The per-channel sums and count of the batch: over the parts of a
    mesh step (:func:`parallel.mesh.all_sum`), else this forward's."""
    part = current_part()
    if part is None:
        return s1, s2, n
    s1, s2 = all_sum(torch.stack([s1, s2])).unbind()
    return s1, s2, part.global_count(n)


def bias_terms(bias, dtype):
    """(hi, lo): a folded conv's f32 ``bias`` in ``dtype`` and what that
    rounding lost (``rcu_tpu`` ``_compensated_bias_add``'s two terms). The
    conv adds ``hi`` in its accumulator and ``lo`` after, so the BN
    centering term that the bias carries keeps its f32 precision."""
    hi = bias.to(dtype)
    return hi, (bias - hi.float()).to(dtype)


def _fold3to4(w, dim):
    """``A w`` along ``dim``, a size-3 axis of ``w``: the rows w0, w0+w1,
    w1+w2, w2 (``rcu_tpu`` unet.py:441-444's ``_UPSAMPLE_FOLD``)."""
    a, b, c = w.unbind(dim)
    return torch.stack([a, a + b, b + c, c], dim)


def upsample_conv(x, weight, bias):
    """``conv3x3(nearest_up_2x(x)) + bias`` as one transposed conv: the
    (O, I, 3, 3) ``weight`` folded into 4x4 as ``A w A^T`` (in f32, then
    x's dtype), flipped in both spatial axes and laid out (I, O, 4, 4).
    The 2h x 2w upsampled input is never written."""
    w4 = _fold3to4(_fold3to4(weight.float(), 2), 3).to(x.dtype)
    return conv2d(x, w4.flip(2, 3).transpose(0, 1), bias, stride=2,
                  padding=1, transposed=True)


def _site_scale(scales, key):
    """A quantized site's calibrated activation scale; a missing key means
    the calibration ran another decoder topology than this model."""
    if key not in scales:
        raise KeyError(
            f"no calibrated scale for conv site '{key}' — calibrate with "
            f"the same model flags (fast decoder, dtype) as the quantized "
            f"model (have: {sorted(scales)[:4]}...)")
    return scales[key]


def _new_int8_weights(conv, parts, fold):
    weight = conv.weight.detach().float()
    if fold:  # in f32 before quantizing, rows first as flax's einsum adds
        weight = _fold3to4(_fold3to4(weight, 2), 3)
    out, lo = [], 0
    for width in parts:
        out.append(quant.quantize_weight(weight[:, lo:lo + width]))
        lo += width
    return out


def int8_weights(conv, parts, fold=False):
    """[(int8 (O, kh, kw, I_part), (O,) f32 scale)] of ``conv``'s kernel cut
    into input-channel ``parts`` (folded to 4x4 first with ``fold``): the
    buffers that :func:`quantize_weights` stored at load, or quantized now
    from the weight as it is, as the JAX package does at trace time."""
    key = (tuple(parts), fold)
    if getattr(conv, "int8_key", None) != key:
        return _new_int8_weights(conv, parts, fold)
    return [(getattr(conv, f"int8_w{i}"), getattr(conv, f"int8_s{i}"))
            for i in range(len(parts))]


def _store_int8_weights(conv, parts, fold=False):
    for i, (w_q, w_scale) in enumerate(_new_int8_weights(conv, parts, fold)):
        conv.register_buffer(f"int8_w{i}", w_q, persistent=False)
        conv.register_buffer(f"int8_s{i}", w_scale, persistent=False)
    conv.int8_key = (tuple(parts), fold)


def _memory_format(x):
    return torch.channels_last \
        if x.is_contiguous(memory_format=torch.channels_last) \
        and not x.is_contiguous() else torch.contiguous_format


def quantize_nhwc(x, a_scale: float):
    """``x`` (N, C, H, W, any memory format) quantized with ``a_scale`` as a
    contiguous NHWC int8 tensor. A channels-last ``x`` (bf16 models)
    quantizes straight into NHWC; an NCHW one (f32 models) costs one int8
    copy to NHWC."""
    x_q = quant.quantize_activation(x, a_scale).permute(0, 2, 3, 1)
    return x_q if x_q.is_contiguous() else x_q.contiguous()


def int8_conv_out(inputs, scales, conv, fold=False, folded_bias=False):
    """An int8 conv site's output in the compute dtype of ``inputs`` (one
    tensor, or the two of a split pair, each with its own scale and kernel
    part; the dequantized products add in order), ``conv``'s bias added as
    flax adds it: in the compute dtype, or with ``folded_bias`` (a BN-folded
    site) as the two terms of :func:`bias_terms`. ``fold`` runs the fused
    up-conv (the 4x4 folded kernel over the input spread by 2, padding 2).
    One call of ``ops.cuda.int8conv.int8_conv_dequant``: the int8 conv
    with flax's dequantize (``y.astype(compute) * (w_scale *
    a_scale).astype(compute)``) and bias in its epilogue. Keeps the memory
    format of ``inputs[0]``."""
    dtype = inputs[0].dtype
    weights = int8_weights(conv, [t.shape[1] for t in inputs], fold)
    pad, dilation = (2, 2) if fold else (conv.padding[0], 1)
    terms = [(quantize_nhwc(t, a_scale), w_q,
              (w_scale * quant.f32_scalar(a_scale, w_scale.device)).to(dtype))
             for t, (w_q, w_scale), a_scale in zip(inputs, weights, scales)]
    lo = None
    if folded_bias and dtype != torch.float32:
        bias, lo = bias_terms(conv.bias, dtype)
    else:
        bias = conv.bias.to(dtype)
    y = int8_conv_dequant(terms, bias, pad, dilation, lo=lo)
    return y.permute(0, 3, 1, 2).contiguous(
        memory_format=_memory_format(inputs[0]))


def conv2d(x, weight, bias=None, stride=1, padding=0, transposed=False):
    """``F.conv2d`` (``F.conv_transpose2d`` where ``transposed``). Every
    conv of the U-Net, the PostNet and TransUNet runs here, so that inside
    ``eval.device.measured_conv_engines`` each call counts while a
    profiler runs: ``conv.measured`` a call, ``conv.new_shapes`` a conv
    key the block had not seen in this process (where cuDNN times its
    candidate engines)."""
    new = CONV_SEARCH.is_new(x, weight, stride, padding, transposed)
    if new is not None:
        profiling.count("conv.measured")
        if new:
            profiling.count("conv.new_shapes")
    if transposed:
        return F.conv_transpose2d(x, weight, bias, stride, padding)
    return F.conv2d(x, weight, bias, stride, padding)


def _split_conv(x, weight, bias, padding):
    """``conv(x)``, ``x`` a tensor or a pair ``(a, b)`` that stands for
    their channel concatenation: then the conv runs over the kernel's
    input-channel halves and adds (``split_decoder_concat``)."""
    if isinstance(x, tuple):
        a, b = x
        y = conv2d(a, weight[:, :a.shape[1]], None, padding=padding)
        y += conv2d(b, weight[:, a.shape[1]:], bias, padding=padding)
        return y
    return conv2d(x, weight, bias, padding=padding)


class ConvBnRelu(nn.Module):
    """conv (3x3, or 1x1 in the PostNet) -> [channel dropout] -> [batch
    norm] -> [relu], in the dtype of its input. ``bn=False`` has no batch
    norm; with ``fold_bn`` it is in the conv's weights (no ``BatchNorm_0``
    either; ``fold_bn`` is then this site's: a BN-free site has nothing
    folded). ``activation=False`` (the last conv of a residual block) ends
    without the relu. ``site`` is the module's flax path and
    ``quant_scales`` the scale dict of a quantized site (the owning U-Net
    sets both); ``split_input`` marks a conv that takes a pair at
    load-time quantization. ``bias=False`` builds the conv without a bias
    (a site whose BatchNorm follows it, as TransUNet's decoder has them).
    Under the ``'conv'`` remat policy (``engine.remat``) a train-mode site
    keeps its conv output and recomputes the epilogue in the backward pass.
    An f32 site in eval mode on a card runs its epilogue as one kernel
    (:meth:`fuses_epilogue`); an f32 BatchNorm site training on a card as
    two kernels forward and two backward (:meth:`fuses_train_epilogue`)."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float | None = None,
                 kernel: int = 3, fold_bn: bool = False, bn: bool = True,
                 activation: bool = True, bias: bool = True):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2,
                                bias=bias)
        if not bias:  # what the fused epilogue adds in place of a bias
            self.register_buffer("zero_bias", torch.zeros(out_ch),
                                 persistent=False)
        self.dropout = ChannelDropout(dropout) if dropout is not None else None
        self.fold_bn = fold_bn and bn
        self.activation = activation
        if bn and not fold_bn:
            self.BatchNorm_0 = nn.BatchNorm2d(out_ch, eps=1e-5)
        self.site = ""
        self.quant_scales = None
        self.split_input = False

    def int8_parts(self):
        """The input-channel parts of the kernel: the two halves of a split
        pair, else the whole."""
        width = self.Conv_0.in_channels
        return (width // 2, width - width // 2) if self.split_input \
            else (width,)

    def conv_out(self, x, stats=None, bias=True):
        """The conv's output, before dropout. ``x`` a tensor, or a pair
        ``(a, b)`` that stands for their channel concatenation: the conv
        then runs over the kernel's input-channel halves and adds
        (``split_decoder_concat``). A quantized site runs
        :func:`int8_conv_out`. ``bias=False`` leaves the bias out (an
        unquantized site whose epilogue adds it)."""
        conv = self.Conv_0
        inputs = x if isinstance(x, tuple) else (x,)
        dtype = inputs[0].dtype
        leaves = ("Conv_0_in_absmax_a", "Conv_0_in_absmax_b") \
            if isinstance(x, tuple) else ("Conv_0_in_absmax",)
        keys = [quant.site_key(self.site, leaf) for leaf in leaves]
        scales = [None] * len(keys) if self.quant_scales is None else \
            [_site_scale(self.quant_scales, key) for key in keys]
        if stats is not None:
            for key, value, scale in zip(keys, inputs, scales):
                stats.observe(key, value, scale)
        if self.quant_scales is not None:
            return int8_conv_out(inputs, scales, conv,
                                 folded_bias=self.fold_bn)
        lo = None
        if not bias or conv.bias is None:
            bias = None
        elif self.fold_bn and dtype != torch.float32:
            bias, lo = bias_terms(conv.bias, dtype)
        else:
            bias = conv.bias.to(dtype)
        y = _split_conv(x, conv.weight.to(dtype), bias, conv.padding)
        if lo is not None:
            y += lo[:, None, None]
        return y

    def fuses_epilogue(self, x) -> bool:
        """Whether this call's epilogue is one ``conv_epilogue`` kernel on
        the bias-free conv output: in eval mode, outside autograd, at an
        unquantized site whose conv output is an NCHW float32 CUDA tensor
        (``x``, or the first of a pair, is). Every other call keeps the
        eager chain of :meth:`epilogue`."""
        x = x[0] if isinstance(x, tuple) else x
        return (x.device.type == "cuda" and x.dtype == torch.float32
                and not self.training and self.quant_scales is None
                and not torch.is_grad_enabled()
                and _memory_format(x) == torch.contiguous_format)

    def fuses_train_epilogue(self, x) -> bool:
        """Whether this call's epilogue is ``train_epilogue`` on the
        bias-free conv output: in train mode under autograd, at an
        unquantized site with its own ``BatchNorm_0`` (not BN-free, not
        folded) whose conv output is an NCHW float32 CUDA tensor and whose
        BatchNorm parameters are float32 (a float64 model's f32 sigma head
        has neither), outside a remat policy and a remat region (whose
        reruns replay the sums and update no statistic) and a mesh part
        (whose sums add over the parts). Every other call keeps the eager
        chain of :meth:`epilogue`."""
        x = x[0] if isinstance(x, tuple) else x
        bn = getattr(self, "BatchNorm_0", None)
        return (x.device.type == "cuda" and x.dtype == torch.float32
                and self.training and torch.is_grad_enabled()
                and self.quant_scales is None
                and bn is not None and bn.weight.dtype == torch.float32
                and remat.policy() is None and not remat.in_region()
                and current_part() is None
                and _memory_format(x) == torch.contiguous_format)

    def _fused_input(self, x, generators, stats):
        """The bias-free conv output, its dropout divisor and the bias the
        fused epilogue adds."""
        y = self.conv_out(x, stats, bias=False)
        divisor = None if self.dropout is None \
            else self.dropout.divisor(y, generators)
        bias = self.zero_bias if self.Conv_0.bias is None \
            else self.Conv_0.bias.float()
        return y, divisor, bias

    def forward(self, x, generators=None, stats=None):
        if self.fuses_epilogue(x):
            y, divisor, bias = self._fused_input(x, generators, stats)
            profiling.count("unet.epilogue_fused")
            profiling.count("unet.epilogue_bytes",
                            BYTES_PER_ELEMENT * y.numel())
            return conv_epilogue(y, bias, divisor,
                                 getattr(self, "BatchNorm_0", None),
                                 self.activation)
        if self.fuses_train_epilogue(x):
            y, divisor, bias = self._fused_input(x, generators, stats)
            profiling.count("unet.train_epilogue_fused")
            return train_epilogue(y, bias, divisor, self.BatchNorm_0,
                                  self.activation)
        y = self.conv_out(x, stats)
        if y.is_cuda:
            profiling.count("unet.epilogue_eager")
        if self.training and remat.policy() == "conv":
            return remat.checkpoint(self.epilogue, y, generators, False)
        return self.epilogue(y, generators)

    def epilogue(self, y, generators=None, inplace=True):
        """Dropout, batch norm and relu on the conv output ``y``; in place
        on ``y`` where ``inplace`` (not on a remat region's input)."""
        if self.dropout is not None:
            dropped = self.dropout(y, generators, inplace)
            inplace = inplace or dropped is not y
            y = dropped
        bn = getattr(self, "BatchNorm_0", None)
        if bn is not None:
            inplace = True
            if self.training:
                y = batch_norm_train(y, bn)
            else:
                y = F.batch_norm(y, bn.running_mean, bn.running_var,
                                 bn.weight, bn.bias, False, 0.0, bn.eps)
        if not self.activation:
            return y
        # in place under autograd too: no backward reads the BatchNorm's
        # output or a conv's, and relu's own backward reads its result
        return F.relu_(y) if inplace else F.relu(y)


def _conv_dropout(dropout, dropout_mode, i, repetitions):
    """Which convs of a block carry dropout (``rcu_tpu`` unet.py:354-362)."""
    if dropout_mode == "all":
        return dropout
    if dropout_mode == "first" and i == 0:
        return dropout
    if dropout_mode == "last" and i == repetitions - 1:
        return dropout
    return None


def _block_dropout_mode(dropout_center, curr_depth, depth, is_down):
    """Dropout mode of a block at a given depth (``rcu_tpu`` unet.py:365-373)."""
    if dropout_center is None:
        return "all"
    if curr_depth == depth:
        return "no"
    if curr_depth + dropout_center >= depth:
        return "last" if is_down else "first"
    return "no"


class ConvBlock(nn.Module):
    """``repetitions`` stacked ConvBnRelu."""
    residual = False

    def __init__(self, in_ch: int, out_ch: int, dropout=None,
                 dropout_mode: str = "all", repetitions: int = 2,
                 fold_bn: bool = False, bn: bool = True):
        super().__init__()
        if self.residual:  # flax creates the 1x1 first: ``Conv_0``
            self.Conv_0 = nn.Conv2d(in_ch, out_ch, 1)
        self.layers = []
        for i in range(repetitions):
            layer = ConvBnRelu(in_ch if i == 0 else out_ch, out_ch,
                               _conv_dropout(dropout, dropout_mode, i,
                                             repetitions), fold_bn=fold_bn,
                               bn=bn, activation=not (
                                   self.residual and i == repetitions - 1))
            self.add_module(f"ConvBnRelu_{i}", layer)
            self.layers.append(layer)

    def forward(self, x, generators=None, stats=None):
        for layer in self.layers:
            x = layer(x, generators, stats)
        return x


class ConvResidualBlock(ConvBlock):
    """``rcu_tpu`` ``ConvResidualBlock``: the stacked ConvBnRelu, the last
    without its relu, plus a 1x1 conv ``Conv_0`` of the block's input (over
    a split pair: the two input-channel halves, added). The 1x1 is no
    int8 site: a residual U-Net refuses ``quant_scales``."""
    residual = True

    def forward(self, x, generators=None, stats=None):
        dtype = (x[0] if isinstance(x, tuple) else x).dtype
        residual = _split_conv(x, self.Conv_0.weight.to(dtype),
                               self.Conv_0.bias.to(dtype), 0)
        return super().forward(x, generators, stats) + residual


def _pad_to(up, target_hw):
    """Pad spatially to the skip's shape: diff//2 before, the rest after."""
    h_diff = target_hw[0] - up.shape[2]
    w_diff = target_hw[1] - up.shape[3]
    if h_diff == 0 and w_diff == 0:
        return up
    return F.pad(up, (w_diff // 2, w_diff - w_diff // 2,
                      h_diff // 2, h_diff - h_diff // 2))


def _conv(x, conv):
    """``conv`` applied in x's dtype, its weights cast where not precast."""
    return conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                  padding=conv.padding)


class _Trainable(nn.Module):
    """``train(True)`` for the models without the BN fold or int8, in
    float32, in bfloat16 (flax's mixed precision: the parameters, their
    gradients, the optimizer's moments and the BatchNorm statistics stay
    float32; the convs and dropout run in bf16, BatchNorm normalizes in
    f32, the logits are f32) and in float64 (which the tests hold against
    the JAX package's float64 gradients); the inference rewrites raise."""

    def train(self, mode: bool = True):
        if mode:
            if self.fold_bn or getattr(self, "quant_scales", None) is not None:
                raise NotImplementedError(
                    "fold_bn and int8 models are inference-only rewrites; "
                    "train the unfolded model")
            if self.dtype not in (torch.float32, torch.bfloat16,
                                  torch.float64):
                raise NotImplementedError(
                    f"training in {self.dtype} is not ported to "
                    "rcu_tpu_torch; train in float32 or bfloat16")
        return super().train(mode)

    def reset_parameters_like_flax(self, generator=None):
        """flax's initialization (``rcu_tpu`` unet.py ``conv_init``): conv
        kernels ``variance_scaling(1/3, fan_in, uniform)``, which is
        ``U(-sqrt(1/fan_in), sqrt(1/fan_in))``, drawn from ``generator``
        module by module in registration order; conv biases 0; BatchNorm
        scale 1, bias 0, running mean 0 and variance 1. Returns the
        model."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    bound = (1.0 / (m.weight[0].numel())) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.BatchNorm2d):
                    m.reset_parameters()
        return self

    def _check_fold_bn(self, generators):
        if self.fold_bn and generators is not None:
            raise ValueError(
                "fold_bn is a deterministic-inference rewrite: the BN fold "
                "does not commute with an active dropout between conv and "
                "BN (a dropped channel must still receive the BN shift); "
                "run MC-dropout protocols on the unfolded model")


class UNet(_Trainable):
    """Configurable 2D encoder-decoder; NCHW in, :class:`UNetOutput` out.

    ``sigma_out`` adds the aleatoric sigma head, ``provide_features``
    returns the decoder output that the heads read; ``dtype``,
    ``split_decoder_concat``, ``fused_upsample``, ``fold_bn`` and
    ``quant_scales`` with ``quant_skip_levels`` (the ``quant_skip_levels``
    finest resolution levels stay in the compute dtype) are the inference
    variants of the module doc. ``residual`` builds
    :class:`ConvResidualBlock` blocks (``ConvResidualBlock_0..2d``; no
    int8), ``bn=False`` ConvBnRelus without a batch norm.
    """

    def __init__(self, nb_classes: int, in_channels: int, depth: int = 4,
                 start_filters: int = 16, dropout: float | None = 0.2,
                 dropout_center: int | None = None, residual: bool = False,
                 sigma_out: bool = False, provide_features: bool = False,
                 bn: bool = True, dtype: torch.dtype = torch.float32,
                 split_decoder_concat: bool = False,
                 fused_upsample: bool = False, fold_bn: bool = False,
                 quant_scales: dict | None = None,
                 quant_skip_levels: int = 0):
        super().__init__()
        self.depth = depth
        self.residual = residual
        self.dropout = dropout
        self.dropout_center = dropout_center
        self.sigma_out = sigma_out
        self.provide_features = provide_features
        self.dtype = dtype
        self.split_decoder_concat = split_decoder_concat
        self.fused_upsample = fused_upsample
        self.fold_bn = fold_bn
        self.down_blocks, self.up_convs, self.up_blocks = [], [], []
        block_cls = ConvResidualBlock if residual else ConvBlock
        self.block_prefix = prefix = block_cls.__name__
        ch_in, ch = in_channels, start_filters
        for i in range(depth):
            mode = _block_dropout_mode(dropout_center, i, depth, True)
            block = block_cls(ch_in, ch, dropout, mode, fold_bn=fold_bn, bn=bn)
            self.add_module(f"{prefix}_{i}", block)
            self.down_blocks.append(block)
            ch_in, ch = ch, ch * 2
        mode = _block_dropout_mode(dropout_center, depth, depth, True)
        self.add_module(f"{prefix}_{depth}", block_cls(
            ch_in, ch, dropout, mode, fold_bn=fold_bn, bn=bn))
        for k in range(depth):
            up_conv = nn.Conv2d(ch, ch // 2, 3, padding=1)
            self.add_module(f"Conv_{k}", up_conv)
            self.up_convs.append(up_conv)
            mode = _block_dropout_mode(dropout_center, depth - 1 - k, depth,
                                       False)
            block = block_cls(ch, ch // 2, dropout, mode, fold_bn=fold_bn,
                              bn=bn)
            self.add_module(f"{prefix}_{depth + 1 + k}", block)
            self.up_blocks.append(block)
            ch //= 2
        self.ConvBnRelu_0 = ConvBnRelu(ch, ch, dropout, fold_bn=fold_bn, bn=bn)
        self.add_module(f"Conv_{depth}", nn.Conv2d(ch, nb_classes, 1))
        if sigma_out:
            self.ConvBnRelu_1 = ConvBnRelu(ch, ch, dropout, fold_bn=fold_bn,
                                           bn=bn)
            self.add_module(f"Conv_{depth + 1}", nn.Conv2d(ch, nb_classes, 1))
        _zero_biases(self)
        _name_sites(self)
        for block in self.up_blocks:
            block.layers[0].split_input = split_decoder_concat
        self._set_quantization(quant_scales, quant_skip_levels)
        self.train(False)

    def _set_quantization(self, scales, skip_levels):
        if scales is not None and self.residual:
            raise NotImplementedError(
                "int8 quantization does not cover residual=True models "
                "(the 1x1 residual convs are unquantized sites); use the "
                "plain block variant")
        if not 0 <= skip_levels <= self.depth + 1:
            raise ValueError(f"quant_skip_levels must be in [0, depth+1="
                             f"{self.depth + 1}], got {skip_levels}")
        self.quant_scales = scales
        self.quant_skip_levels = skip_levels
        # the k-th up block (and up-conv) writes level depth-1-k, the head
        # level 0
        levels = [(block, i) for i, block in enumerate(self.down_blocks)]
        levels.append((self.bottom_block, self.depth))
        levels += [(block, self.depth - 1 - k)
                   for k, block in enumerate(self.up_blocks)]
        for block, level in levels:
            for layer in block.layers:
                layer.quant_scales = self._level_scales(level)
        self.ConvBnRelu_0.quant_scales = self._level_scales(0)

    def quantize(self, scales: dict, skip_levels: int = 0):
        """Make this model, in place, the int8 model of ``scales`` (from
        ``ops.quant.calibrate_scales`` on it as it is, with its dtype and
        decoder flags), keeping the ``skip_levels`` finest levels in the
        compute dtype; quantizes the weights as they are now
        (:func:`quantize_weights`). Returns the model."""
        self._set_quantization(scales, skip_levels)
        return quantize_weights(self)

    @property
    def bottom_block(self):
        return getattr(self, f"{self.block_prefix}_{self.depth}")

    def _level_scales(self, level: int):
        """``quant_scales`` for a module at resolution level ``level`` (0 =
        finest), None where ``quant_skip_levels`` keeps it unquantized."""
        if self.quant_scales is None or level < self.quant_skip_levels:
            return None
        return self.quant_scales

    def _up(self, k, x, stats):
        """The k-th up-conv on ``x``, at the upsampled size: int8 where its
        output level is quantized."""
        conv, key = self.up_convs[k], f"Conv_{k}_in_absmax"
        scales = self._level_scales(self.depth - 1 - k)
        scale = None if scales is None else _site_scale(scales, key)
        if not self.fused_upsample:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        if stats is not None:  # nearest upsampling keeps the absmax
            stats.observe(key, x, scale)
        if scale is not None:
            return int8_conv_out([x], [scale], conv, fold=self.fused_upsample)
        if self.fused_upsample:
            return upsample_conv(x, conv.weight.to(x.dtype),
                                 conv.bias.to(x.dtype))
        return _conv(x, conv)

    @property
    def mc_shared_blocks(self) -> int:
        """Leading encoder blocks with no dropout site (``dropout_center``
        leaves the outer ``depth - dropout_center`` down blocks
        dropout-free); 0 when every block is stochastic."""
        if self.dropout is None or not self.dropout_center:
            return 0
        return max(0, self.depth - self.dropout_center)

    def forward(self, x, generators=None, stats=None):
        """``generators``: one per MC sample riding the batch (sample-major),
        or None for the deterministic forward; ``stats`` an
        ``ops.quant.SiteStats`` collector for a calibration or clip pass."""
        self._check_fold_bn(generators)
        x, skips = self._down(x.to(self.dtype), [], 0, generators,
                              stats=stats)
        return self._finish(x, skips, generators, stats)

    def encode_shared(self, x):
        """The dropout-free encoder prefix (``mc_shared_blocks`` down
        blocks), run once on the images before :meth:`decode_rest` fans
        out over the MC samples. Returns (pooled, skips)."""
        return self._down(x.to(self.dtype), [], 0, None,
                          stop=self.mc_shared_blocks)

    def decode_rest(self, x, skips, generators=None):
        """Continue from :meth:`encode_shared` (its outputs repeated per
        sample): the remaining down blocks, bottom, decoder and heads. The
        prefix has no dropout site, so every generator draws at the same
        sites as in the full forward, and the outputs equal it."""
        self._check_fold_bn(generators)
        x, skips = self._down(x, skips, len(skips), generators)
        return self._finish(x, skips, generators)

    def _down(self, x, skips, start, generators, stop=None, stats=None):
        """Down blocks ``start..stop-1`` (to the bottom by default),
        appending their outputs to ``skips``."""
        skips = list(skips)
        for block in self.down_blocks[start:stop]:
            x = block(x, generators, stats)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        return x, skips

    def _finish(self, x, skips, generators, stats=None):
        """Bottom, decoder and heads from the pooled features and skips."""
        x = self.bottom_block(x, generators, stats)
        for k, block in enumerate(self.up_blocks):
            skip = skips.pop()  # drop each skip as soon as it is consumed
            up = _pad_to(self._up(k, x, stats), skip.shape[2:])
            x = block((up, skip) if self.split_decoder_concat
                      else torch.cat([up, skip], dim=1), generators, stats)
            del up, skip
        # both heads read the decoder output x, and the sigma head does not
        # read the class head's; no op after this point writes into x in
        # place (each ConvBnRelu's in-place ops act on its conv's output),
        # so the features returned are the tensor the heads saw. The class
        # conv runs in the compute dtype and casts its narrow output to f32
        logits = _conv(self.ConvBnRelu_0(x, generators, stats),
                       getattr(self, f"Conv_{self.depth}")).float()
        sigma = None
        if self.sigma_out:  # in f32 whatever the compute dtype
            sigma = _conv(self.ConvBnRelu_1(x.float(), generators, stats),
                          getattr(self, f"Conv_{self.depth + 1}"))
        return UNetOutput(logits, sigma, x if self.provide_features else None)


class PostNet(_Trainable):
    """The auxiliary confidence net on a segmenter's features
    (``rcu_tpu.models.unet.PostNet``): ``nb_convs`` 1x1 ConvBnRelu at the
    input width in the compute dtype, then the 1x1 class conv ``Conv_0``
    in f32. flax infers the input width; here it is ``in_channels``."""

    def __init__(self, nb_classes: int, in_channels: int, nb_convs: int = 3,
                 dropout: float | None = None,
                 dtype: torch.dtype = torch.float32, fold_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        self.fold_bn = fold_bn
        self.layers = []
        for i in range(nb_convs):
            layer = ConvBnRelu(in_channels, in_channels, dropout, kernel=1,
                               fold_bn=fold_bn)
            self.add_module(f"ConvBnRelu_{i}", layer)
            self.layers.append(layer)
        self.Conv_0 = nn.Conv2d(in_channels, nb_classes, 1)
        _zero_biases(self)
        _name_sites(self)
        self.train(False)

    def forward(self, x, generators=None):
        self._check_fold_bn(generators)
        x = x.to(self.dtype)
        for layer in self.layers:
            x = layer(x, generators)
        return UNetOutput(_conv(x.float(), self.Conv_0))


def f32_head_keys(model) -> frozenset:
    """Top-level modules that compute in f32 whatever the compute dtype:
    the U-Net's sigma head and the PostNet's confidence head."""
    if isinstance(model, UNet) and model.sigma_out:
        return frozenset({"ConvBnRelu_1", f"Conv_{model.depth + 1}"})
    if isinstance(model, PostNet):
        return frozenset({"Conv_0"})
    return frozenset()


def precast_params(model):
    """Cast the conv weights and biases of a non-f32 model to its compute
    dtype once, in place (``rcu_tpu`` ``precast_params``), then quantize
    the int8 sites' weights from the cast ones (:func:`quantize_weights`);
    returns the model.

    Kept f32: every BatchNorm tensor (it normalizes in f32), the modules of
    :func:`f32_head_keys`, and in a folded model every conv bias (the BN
    centering term, see :func:`bias_terms`). The outputs
    are bitwise those of casting the same weights at every call."""
    if model.dtype != torch.float32:
        keep = f32_head_keys(model)
        for name, module in model.named_modules():
            if not isinstance(module, nn.Conv2d) or name.split(".")[0] in keep:
                continue
            module.weight.data = module.weight.data.to(model.dtype)
            if not model.fold_bn:
                module.bias.data = module.bias.data.to(model.dtype)
    return quantize_weights(model)


def quantize_weights(model):
    """Store the int8 weights and f32 per-channel scales of every quantized
    site of a U-Net as buffers outside the state_dict (checkpoints are
    unchanged), from its weights as they are now: after the BN fold and
    the precast, so a bf16 model's int8 weights come from its
    bf16-rounded kernels, as the JAX package's direct eval quantizes them.
    A model without ``quant_scales`` is returned as it is."""
    if getattr(model, "quant_scales", None) is None:
        return model
    for module in model.modules():
        if isinstance(module, ConvBnRelu) and module.quant_scales is not None:
            _store_int8_weights(module.Conv_0, module.int8_parts())
    for k, conv in enumerate(model.up_convs):
        if model._level_scales(model.depth - 1 - k) is not None:
            _store_int8_weights(conv, [conv.in_channels], model.fused_upsample)
    return model


def _name_sites(model):
    """Give each ConvBnRelu its flax path, the prefix of its site keys."""
    for name, module in model.named_modules():
        if isinstance(module, ConvBnRelu):
            module.site = name.replace(".", "/")


def _zero_biases(module):
    """flax's zero bias init (kernels: the same U(+-1/sqrt(fan_in)) as
    torch's)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.zeros_(m.bias)
