"""Post-training int8 quantization (PTQ) of the U-Net trunk, as plain
functions on tensors (``rcu_tpu.ops.quant`` counterpart, same meaning and
rounding).

- Weights: per output channel, symmetric int8, ``max(absmax, 1e-12) / 127``
  in f32, round half to even, clip to +-127 (:func:`quantize_weight`).
  The port's kernels are (O, I, kh, kw); the int8 result is laid out
  (O, kh, kw, I), the reduction dimension contiguous, as the int8
  convolution (``ops.cuda.int8conv``) reads it.
- Activations: per conv site, symmetric int8 with a scale from a
  calibration pass (:func:`calibrate_scales`) over the plain model.
- Scale dict keys are the JAX package's flax paths letter for letter
  (``ConvBlock_1/ConvBnRelu_0/Conv_0_in_absmax``, ``..._a``/``..._b`` for
  a split pair, ``Conv_2_in_absmax`` for an up-conv), so a dict
  calibrated by either package drives the other.

Where flax sows into a mutable collection, the port passes an explicit
:class:`SiteStats` collector through the forward
(``model(x, generators, stats=...)``); nothing here keeps state between
calls.
"""
from __future__ import annotations

import logging

import torch

from rcu_tpu_torch.engine.steps import to_model_layout

# headroom on the calibrated absmax: MC dropout rescales surviving channels
# by 1/(1-p), and later batches may run hotter than the calibration batch
DEFAULT_MARGIN = 1.1
# the number of finest resolution levels kept in the compute dtype by default
DEFAULT_SKIP_LEVELS = 1

_INT8_MAX = 127.0


def activation_scale(absmax, margin: float = DEFAULT_MARGIN) -> float:
    """Symmetric per-tensor scale of an activation site (a Python float);
    a dead site (absmax <= 0) takes absmax 1."""
    absmax = float(absmax)
    if absmax <= 0.0:
        absmax = 1.0
    return absmax * margin / _INT8_MAX


def f32_scalar(value: float, device) -> torch.Tensor:
    """A Python float as JAX rounds a weak-typed scalar against f32."""
    return torch.tensor(value, dtype=torch.float32, device=device)


def quantize_activation(x: torch.Tensor, scale: float) -> torch.Tensor:
    """``round(f32(x) * f32(1 / scale))``, half to even, clipped to +-127,
    as int8; keeps ``x``'s memory format."""
    q = torch.round(x.float() * f32_scalar(1.0 / scale, x.device))
    return torch.clamp(q, -_INT8_MAX, _INT8_MAX).to(torch.int8)


def quantize_weight(kernel: torch.Tensor):
    """Per-output-channel symmetric int8 weights.

    ``kernel`` (O, I, kh, kw), any float dtype -> (int8 (O, kh, kw, I)
    contiguous, (O,) f32 scales)."""
    kernel = kernel.float()
    absmax = torch.amax(torch.abs(kernel), dim=(1, 2, 3))
    scale = torch.clamp_min(absmax, 1e-12) / _INT8_MAX
    q = torch.clamp(torch.round(kernel / scale[:, None, None, None]),
                    -_INT8_MAX, _INT8_MAX)
    return q.to(torch.int8).permute(0, 2, 3, 1).contiguous(), scale


def site_key(path: str, leaf: str) -> str:
    """A conv site's key: the sowing module's flax path and the leaf name."""
    return f"{path}/{leaf}" if path else leaf


def clamp_skip_levels(model, skip_levels) -> int:
    """``None`` -> :data:`DEFAULT_SKIP_LEVELS`; values outside ``[0, depth
    + 1]`` are clamped with a warning (``rcu_tpu`` ``clamp_skip_levels``)."""
    if skip_levels is None:
        skip_levels = DEFAULT_SKIP_LEVELS
    depth = getattr(model, "depth", 0)
    clamped = max(0, min(int(skip_levels), depth + 1))
    if clamped != int(skip_levels):
        logging.warning(
            "quantize_skip=%s is outside [0, %d] for a depth-%d model; "
            "clamped to %d (%s)", skip_levels, depth + 1, depth, clamped,
            "no trunk level will be quantized" if clamped == depth + 1
            else "all levels quantized" if clamped == 0 else "partial")
    return clamped


def clipped_fraction(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The f32 fraction of ``x`` that saturates int8 at ``scale``: ``|x| >
    127.5 * scale`` (values up to that round to 127 without loss). The
    count is exact; it is multiplied by the f32 reciprocal of the element
    count, as XLA turns the mean's division by a constant."""
    line = f32_scalar((_INT8_MAX + 0.5) * scale, x.device)
    count = torch.count_nonzero(torch.abs(x.float()) > line)
    one = f32_scalar(1.0, x.device)
    return count.float() * (one / f32_scalar(float(x.numel()), x.device))


class SiteStats:
    """What a calibration (``kind="absmax"``) or clip (``kind="clip"``)
    pass records per conv site: the input's absmax at every site, or the
    clipped fraction at every quantized site; the max over calls. Passed
    to the forward as ``stats``; ``values`` is ``{site key: float}``."""

    def __init__(self, kind: str):
        if kind not in ("absmax", "clip"):
            raise ValueError(f"unknown site statistic '{kind}'")
        self.kind = kind
        self.values = {}

    def observe(self, key: str, x: torch.Tensor, scale) -> None:
        if self.kind == "absmax":
            value = float(torch.amax(torch.abs(x)).float())
        elif scale is None:
            return
        else:
            value = float(clipped_fraction(x, scale))
        self.values[key] = max(self.values.get(key, 0.0), value)


def _site_pass(model, batches, kind, generators, mc_dropout):
    """The model over ``batches`` (NHWC tensors) with a ``kind`` collector;
    batch ``i`` draws its one dropout sample from ``generators[i]``."""
    if mc_dropout and (generators is None or len(generators) < len(batches)):
        raise ValueError("an MC-dropout pass needs one torch.Generator per "
                         "batch")
    stats = SiteStats(kind)
    with torch.inference_mode():
        for i, images in enumerate(batches):
            gens = [generators[i]] if mc_dropout else None
            model(to_model_layout(images, model), gens, stats=stats)
    return stats.values


def clip_report(model, batches, mc_dropout: bool = True,
                generators=None) -> dict:
    """``{site key: max clipped fraction over batches}`` of the QUANTIZED
    ``model`` (``quant_scales`` set) on ``batches``; 0.0 means no clipping.
    A site hotter than its calibration shows a nonzero rate."""
    report = _site_pass(model, batches, "clip", generators, mc_dropout)
    if not report:
        raise ValueError(
            "clip_report sowed no quant_clip stats — pass the QUANTIZED "
            "model (quant_scales set); unquantized sites sow nothing")
    return report


def calibrate_scales(model, batches, generators=None, mc_dropout: bool = True,
                     margin: float = DEFAULT_MARGIN) -> dict:
    """The PLAIN ``model`` (no ``quant_scales``; the production dtype and
    decoder flags set) over calibration ``batches`` (NHWC tensors) ->
    ``{site key: activation scale}``. ``mc_dropout`` calibrates batch ``i``
    under one dropout sample drawn from ``generators[i]``, so the 1/(1-p)
    rescale is in the measured range."""
    agg = _site_pass(model, batches, "absmax", generators, mc_dropout)
    if not agg:
        raise ValueError(
            "calibration pass sowed no quant_stats — the model has no "
            "instrumented conv sites")
    return {key: activation_scale(val, margin) for key, val in agg.items()}


def calibrate_and_quantize(members, batch, dropout_seed=None,
                           skip_levels=None) -> tuple:
    """Make the plain ``members`` (one model, or an ensemble's) int8 models
    in place, calibrated on ``batch`` (NHWC on their device, in their
    compute dtype): each member runs its own calibration pass, under one
    dropout sample drawn from a generator seeded with ``dropout_seed``
    where one is given and deterministically otherwise, and the members'
    scales merge by max (the union); every member then keeps its own int8
    weights of the one scale dict. ``skip_levels`` (None:
    :data:`DEFAULT_SKIP_LEVELS`) is clamped to the first member's levels.
    The direct eval's and the service's calibration both come here.
    Returns (the scales, the clamped skip levels)."""
    scales = None
    for member in members:
        generators = None
        if dropout_seed is not None:
            generators = [torch.Generator(device=batch.device)]
            generators[0].manual_seed(dropout_seed)
        member_scales = calibrate_scales(member, [batch], generators,
                                         mc_dropout=generators is not None)
        if scales is None:
            scales = member_scales
            continue
        if set(member_scales) != set(scales):
            raise ValueError(
                "ensemble members sowed different quant sites — the "
                "stacked members must share one architecture")
        for key, val in member_scales.items():
            scales[key] = max(scales[key], val)
    skip_levels = clamp_skip_levels(members[0], skip_levels)
    for member in members:
        member.quantize(scales, skip_levels)
    return scales, skip_levels
