"""The port's int8 PTQ (``rcu_tpu_torch.ops.quant`` and the quantized
sites of ``models.unet``) against the JAX package's (``rcu_tpu.ops.quant``
and the flax ``_QuantConv`` / ``_SplitInputConv`` sites), on the CPU.

- The quant ops bitwise: weights and their scales, activations at halves,
  at saturation and through the f32 reciprocal, scales, clipped fractions,
  the skip-level clamp and its warning.
- One quantized site (a conv, a split pair, an up-conv fused and plain) on
  the same input and scale as flax's module: int32 equal, the dequantized
  output bitwise in f32 and bf16, the BN-folded ``(y + hi) + lo`` too; the
  int8 weights of a bf16 model are quantized from its bf16-rounded kernel.
- The calibrated dict of a deterministic pass: flax's key set, values at
  rtol 1e-5; the ensemble's union is the max.
- A whole quantized U-Net given the JAX package's dict: softmax within
  5e-3 of flax's quantized forward (the JAX package's own int8 bar,
  ``tests/test_quant.py:60``); the quantized sites per skip level are
  flax's; skipping every level is the plain model bitwise; the guards.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu.models import precast_params as jax_precast_params
from rcu_tpu.models.unet import _QuantConv, _SplitInputConv
from rcu_tpu.ops import quant as jax_quant
from rcu_tpu_torch.eval.direct import _calibrated_quant_model, model_from_flax
from rcu_tpu_torch.models import FAST_DECODER_KWARGS, get_model
from rcu_tpu_torch.models.convert import fold_bn_params
from rcu_tpu_torch.models.unet import (ConvBnRelu, int8_conv_out,
                                       int8_weights, quantize_nhwc)
from rcu_tpu_torch.ops import quant
from rcu_tpu_torch.ops.cuda import int8conv
from tests.test_torch_unet import flax_net
from tests.test_torch_variants import nchw, port_net

KW = dict(nb_classes=2, in_channels=4, depth=3, start_filters=8,
          dropout=0.05)  # tests/test_quant.py's U-Net
SOFTMAX_BAR = 5e-3  # tests/test_quant.py:60
DTYPES = {"f32": (torch.float32, jnp.float32, None),
          "bf16": (torch.bfloat16, jnp.bfloat16, "bfloat16")}


def bits(x):
    """A float tensor or array as its f32 bit pattern (bf16 widens
    exactly), so that equality is bitwise, -0 and NaN included."""
    x = torch.as_tensor(np.asarray(x, np.float32)) if not torch.is_tensor(x) \
        else x.float()
    return x.contiguous().view(torch.int32)


# ----------------------------------------------------------------- quant ops

@pytest.mark.parametrize("shape,bf16_origin,dead_channel", [
    ((3, 3, 8, 16), False, False),
    ((3, 3, 4, 32), True, False),
    ((4, 4, 16, 8), False, True),
    ((1, 1, 5, 3), True, True)])
def test_quantize_weight_is_jax_s(shape, bf16_origin, dead_channel):
    rng = np.random.RandomState(sum(shape))
    kernel = (rng.randn(*shape) * rng.rand(shape[-1]) * 3).astype(np.float32)
    if dead_channel:
        kernel[..., 0] = 0.0
    if bf16_origin:
        kernel = np.asarray(jnp.asarray(kernel).astype(jnp.bfloat16)
                            .astype(jnp.float32))
    want_q, want_s = jax_quant.quantize_weight(jnp.asarray(kernel))
    got_q, got_s = quant.quantize_weight(
        torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    assert got_q.dtype == torch.int8 and got_q.is_contiguous()
    # (O, kh, kw, I) against HWIO
    assert np.array_equal(got_q.numpy().transpose(1, 2, 3, 0),
                          np.asarray(want_q))
    assert torch.equal(bits(got_s), bits(want_s))
    assert np.abs(got_q.numpy()).max() == 127


@pytest.mark.parametrize("scale", [0.1, 1.0 / 10, 0.0123, 3.0, 1e-3,
                                   0.0078125, 2.2e-5])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_activation_is_jax_s(scale, dtype):
    """Halves of the step (which round to even), values next to them, the
    reciprocal's f32 rounding, saturation at both ends."""
    rng = np.random.RandomState(int(scale * 1e4) % 97)
    k = np.arange(-130, 131, dtype=np.float64)
    halves = ((k + 0.5) * scale).astype(np.float32)
    near = np.concatenate([np.nextafter(halves, np.float32(np.inf)),
                           np.nextafter(halves, np.float32(-np.inf))])
    x = np.concatenate([halves, near, (k * scale).astype(np.float32),
                        np.float32([1e9, -1e9, 0.0, -0.0]),
                        (rng.randn(500) * 60 * scale).astype(np.float32)])
    t_dtype, j_dtype, _ = DTYPES[dtype]
    want = np.asarray(jax_quant.quantize_activation(
        jnp.asarray(x).astype(j_dtype), scale))
    got = quant.quantize_activation(torch.from_numpy(x).to(t_dtype), scale)
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)
    assert got.min() == -127 and got.max() == 127  # saturates, never wraps


def test_quantize_activation_keeps_the_memory_format():
    x = torch.randn(2, 5, 4, 3).contiguous(memory_format=torch.channels_last)
    got = quant.quantize_activation(x, 0.05)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert got.permute(0, 2, 3, 1).is_contiguous()


@pytest.mark.parametrize("absmax,margin", [
    (3.7, quant.DEFAULT_MARGIN), (0.0, quant.DEFAULT_MARGIN),
    (-1.0, 1.1), (1e-7, 1.0), (np.float32(12.25), 1.25)])
def test_activation_scale_is_jax_s(absmax, margin):
    got = quant.activation_scale(absmax, margin)
    assert isinstance(got, float)
    assert got == jax_quant.activation_scale(absmax, margin)


def test_defaults_are_jax_s():
    assert quant.DEFAULT_MARGIN == jax_quant.DEFAULT_MARGIN
    assert quant.DEFAULT_SKIP_LEVELS == jax_quant.DEFAULT_SKIP_LEVELS
    assert quant.site_key("ConvBlock_1/ConvBnRelu_0", "x") \
        == jax_quant.site_key(("ConvBlock_1", "ConvBnRelu_0"), "x")
    assert quant.site_key("", "Conv_2_in_absmax") \
        == jax_quant.site_key((), "Conv_2_in_absmax")


@pytest.mark.parametrize("scale", [1.0 / 127.0, 0.01, 0.05, 1.0])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_clipped_fraction_is_jax_s(scale, dtype):
    rng = np.random.RandomState(5)
    x = (rng.randn(7, 33, 5) * 1.5).astype(np.float32)
    x.reshape(-1)[:8] = np.float32(127.5 * scale)  # at the line: not counted
    t_dtype, j_dtype, _ = DTYPES[dtype]
    want = jax_quant.clipped_fraction(jnp.asarray(x).astype(j_dtype), scale)
    got = quant.clipped_fraction(torch.from_numpy(x).to(t_dtype), scale)
    assert got.dtype == torch.float32
    assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("skip", [None, -1, 0, 2, 4, 5, 9])
def test_clamp_skip_levels_is_jax_s(skip, caplog):
    """The clamp and its warning, word for word (depth 3: levels 0..4)."""
    model = get_model("unet", KW)
    with caplog.at_level(logging.WARNING):
        got = quant.clamp_skip_levels(model, skip)
    port_log = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = jax_quant.clamp_skip_levels(flax_get_model("unet", KW), skip)
    assert got == want
    assert port_log == [r.getMessage() for r in caplog.records]
    assert bool(port_log) == (skip is not None and skip != got)


# ---------------------------------------------------------- one quantized site

def flax_conv_params(rng, k, cin, cout):
    return {"kernel": (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32),
            "bias": (rng.randn(cout) * 0.5).astype(np.float32)}


def port_conv(params, dtype, folded):
    """An nn.Conv2d with the flax params, its weight (and, unfolded, its
    bias) cast to the compute dtype as ``precast_params`` leaves it."""
    kernel = params["kernel"]
    conv = torch.nn.Conv2d(kernel.shape[2], kernel.shape[3], kernel.shape[0],
                           padding=kernel.shape[0] // 2)
    conv.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    conv.bias.data = torch.from_numpy(params["bias"])
    conv.weight.data = conv.weight.data.to(dtype)
    if not folded:
        conv.bias.data = conv.bias.data.to(dtype)
    return conv


def flax_precast(params, j_dtype, folded):
    """The flax params as the JAX direct eval holds them by then."""
    out = {"kernel": np.asarray(jnp.asarray(params["kernel"]).astype(j_dtype))}
    out["bias"] = params["bias"] if folded else \
        np.asarray(jnp.asarray(params["bias"]).astype(j_dtype))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("folded", [False, True])
def test_quant_conv_site_is_flax_s(dtype, folded):
    """A ConvBnRelu's int8 conv against flax's ``_QuantConv`` (f32 bias
    with ``folded``): int32 equal, output bitwise."""
    t_dtype, j_dtype, name = DTYPES[dtype]
    rng = np.random.RandomState(11)
    params = flax_conv_params(rng, 3, 12, 10)
    x = (rng.randn(2, 9, 7, 12) * 2).astype(np.float32)
    scale = float(np.abs(x).max()) * 1.1 / 127 * 0.8  # some saturate
    jp = flax_precast(params, j_dtype, folded)
    want = _QuantConv(10, dtype=j_dtype if name else None,
                      f32_bias=folded).apply(
        {"params": jp}, jnp.asarray(x).astype(j_dtype), a_scale=scale)
    layer = ConvBnRelu(12, 10, fold_bn=folded)
    layer.Conv_0 = port_conv(params, t_dtype, folded)
    layer.site, layer.quant_scales = "S", {"S/Conv_0_in_absmax": scale}
    got = layer.conv_out(nchw(x).to(t_dtype))
    assert got.dtype == t_dtype
    assert torch.equal(bits(got.permute(0, 2, 3, 1)), bits(want))
    # the int32 sums
    x_q = jax_quant.quantize_activation(jnp.asarray(x).astype(j_dtype), scale)
    k_q, _ = jax_quant.quantize_weight(jnp.asarray(jp["kernel"]))
    ((w_q, _),) = int8_weights(layer.Conv_0, [12])
    y = int8conv.int8_conv(quantize_nhwc(nchw(x).to(t_dtype), scale), w_q, 1)
    assert np.array_equal(y.numpy(),
                          np.asarray(jax_quant.int8_conv(x_q, k_q, 1)))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("folded", [False, True])
def test_split_pair_site_is_flax_s(dtype, folded):
    """A split pair: each half quantizes on its own with its own scale; the
    two dequantized products add, then the bias (``_SplitInputConv``)."""
    t_dtype, j_dtype, name = DTYPES[dtype]
    rng = np.random.RandomState(12)
    params = flax_conv_params(rng, 3, 16, 8)
    a = (rng.randn(2, 6, 10, 8) * 2).astype(np.float32)
    b = (rng.randn(2, 6, 10, 8) * 0.3).astype(np.float32)
    sa = float(np.abs(a).max()) * 1.1 / 127
    sb = float(np.abs(b).max()) * 1.1 / 127
    jp = flax_precast(params, j_dtype, folded)
    want = _SplitInputConv(8, dtype=j_dtype if name else None,
                           f32_bias=folded).apply(
        {"params": jp}, jnp.asarray(a).astype(j_dtype),
        jnp.asarray(b).astype(j_dtype), a_scale=sa, b_scale=sb)
    layer = ConvBnRelu(16, 8, fold_bn=folded)
    layer.Conv_0 = port_conv(params, t_dtype, folded)
    layer.site = "ConvBlock_4/ConvBnRelu_0"
    layer.quant_scales = {"ConvBlock_4/ConvBnRelu_0/Conv_0_in_absmax_a": sa,
                          "ConvBlock_4/ConvBnRelu_0/Conv_0_in_absmax_b": sb}
    got = layer.conv_out((nchw(a).to(t_dtype), nchw(b).to(t_dtype)))
    assert torch.equal(bits(got.permute(0, 2, 3, 1)), bits(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("hw", [(5, 7), (8, 8)])
def test_up_conv_site_is_flax_s(dtype, fused, hw):
    """The quantized up-conv: fused, the 3x3 kernel folded to 4x4 in f32
    (rows first, as flax's einsum adds), quantized, then the lhs-dilated
    conv with padding 2 and no flip; plain, the 3x3 conv of the upsampled
    input. int8 weights equal flax's, output bitwise."""
    t_dtype, j_dtype, name = DTYPES[dtype]
    rng = np.random.RandomState(hw[0])
    params = flax_conv_params(rng, 3, 16, 8)
    x = np.abs(rng.randn(2, *hw, 16)).astype(np.float32)  # after a ReLU
    if not fused:
        x = np.repeat(np.repeat(x, 2, axis=1), 2, axis=2)
    scale = float(np.abs(x).max()) * 1.1 / 127
    jp = flax_precast(params, j_dtype, False)
    want = _QuantConv(8, dtype=j_dtype if name else None,
                      fold_upsample=fused).apply(
        {"params": jp}, jnp.asarray(x).astype(j_dtype), a_scale=scale)
    conv = port_conv(params, t_dtype, False)
    got = int8_conv_out([nchw(x).to(t_dtype)], [scale], conv, fold=fused)
    assert got.shape[2:] == want.shape[1:3]
    assert torch.equal(bits(got.permute(0, 2, 3, 1)), bits(want))
    kf = jnp.asarray(jp["kernel"]).astype(jnp.float32)
    if fused:
        from rcu_tpu.models.unet import _UPSAMPLE_FOLD
        fold = jnp.asarray(_UPSAMPLE_FOLD, jnp.float32)
        kf = jnp.einsum("ai,bj,ijco->abco", fold, fold, kf)
    want_q, want_s = jax_quant.quantize_weight(kf)
    ((w_q, w_s),) = int8_weights(conv, [16], fused)
    assert np.array_equal(w_q.numpy().transpose(1, 2, 3, 0), np.asarray(want_q))
    assert torch.equal(bits(w_s), bits(want_s))


@pytest.mark.parametrize("fold", [False, True])
def test_bf16_int8_weights_come_from_the_precast_kernel(fold):
    """Under bf16 the JAX direct eval quantizes the BN-folded, bf16-rounded
    kernel (``_load_model_state`` precasts, then the quantized model is
    built). The port's load-time int8 weights are bitwise those; the f32
    checkpoint kernel would give others."""
    params = dict(KW, **FAST_DECODER_KWARGS)
    _, flax_params, stats = flax_net("unet", params, (16, 16), seed=4)
    tree = fold_bn_params(flax_params, stats) if fold \
        else (flax_params, stats)
    record = dict(params, quant_scales={"unused": 1.0})
    model = model_from_flax("unet", record, flax_params, stats, "cpu",
                            dtype="bfloat16", fold_bn=fold)
    layer = model.ConvBlock_2.ConvBnRelu_1
    jax_kernel = np.asarray(jnp.asarray(
        tree[0]["ConvBlock_2"]["ConvBnRelu_1"]["Conv_0"]["kernel"])
        .astype(jnp.bfloat16).astype(jnp.float32))
    want_q, want_s = jax_quant.quantize_weight(jnp.asarray(jax_kernel))
    stored_q, stored_s = layer.Conv_0.int8_w0, layer.Conv_0.int8_s0
    assert np.array_equal(stored_q.numpy().transpose(1, 2, 3, 0),
                          np.asarray(want_q))
    assert torch.equal(bits(stored_s), bits(want_s))
    f32_q, _ = jax_quant.quantize_weight(jnp.asarray(
        tree[0]["ConvBlock_2"]["ConvBnRelu_1"]["Conv_0"]["kernel"]))
    assert not np.array_equal(np.asarray(f32_q), np.asarray(want_q))
    # the split halves of an up block and each up-conv are stored too
    up = model.ConvBlock_4.ConvBnRelu_0.Conv_0
    assert up.int8_key == ((32, 32), False)
    assert model.Conv_0.int8_key == ((64,), True)
    assert "int8_w0" not in dict(model.state_dict())  # checkpoints unchanged


# ---------------------------------------------------------------- calibration

def flax_vars(params, x, seed=0):
    model = flax_get_model("unet", params)
    v = model.init({"params": jax.random.PRNGKey(seed)}, jnp.asarray(x),
                   train=False)
    return model, jax.tree_util.tree_map(np.asarray, v["params"]), \
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])


@pytest.mark.parametrize("options", [{}, FAST_DECODER_KWARGS,
                                     {"sigma_out": True}])
def test_calibrated_scales_match_jax(options):
    """A deterministic calibration pass: flax's key set letter for letter,
    the values at rtol 1e-5."""
    params = {**KW, **options}
    x = np.random.RandomState(1).randn(2, 32, 32, 4).astype(np.float32)
    model, flax_params, stats = flax_vars(params, x)
    want = jax_quant.calibrate_scales(
        model, {"params": flax_params, "batch_stats": stats},
        [jnp.asarray(x)], mc_dropout=False)
    got = quant.calibrate_scales(port_net("unet", params, flax_params, stats),
                                 [torch.from_numpy(x)], mc_dropout=False)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-5), key
    assert "ConvBlock_1/ConvBnRelu_0/Conv_0_in_absmax" in got
    assert "Conv_2_in_absmax" in got
    if options.get("split_decoder_concat"):
        assert "ConvBlock_6/ConvBnRelu_0/Conv_0_in_absmax_a" in got
        assert "ConvBlock_6/ConvBnRelu_0/Conv_0_in_absmax_b" in got


def test_mc_calibration_needs_generators_and_uses_them():
    params = {**KW, "dropout": 0.5}
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 16, 4)
                         .astype(np.float32))
    model = get_model("unet", params)
    with pytest.raises(ValueError, match="Generator"):
        quant.calibrate_scales(model, [x])

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    one = quant.calibrate_scales(model, [x], [gen(0)])
    assert one == quant.calibrate_scales(model, [x], [gen(0)])
    assert one != quant.calibrate_scales(model, [x], [gen(1)])
    assert one != quant.calibrate_scales(model, [x], mc_dropout=False)


class Volumes:
    """Three subjects in memory, the last the first ``hot`` times over."""

    def __init__(self, hot=1.0, shape=(6, 16, 16)):
        rng = np.random.RandomState(2)
        self.subjects = ["a", "b", "c"]
        self._images = {s: rng.randn(*shape, 4).astype(np.float32)
                        for s in self.subjects[:2]}
        self._images["c"] = hot * self._images["a"]

    def read_volume(self, subject, category):
        return self._images[subject]


def test_ensemble_union_is_the_max():
    """Each member calibrates deterministically on the centre slices of
    the first subject; the union dict is the per-site max and drives every
    member, each with its own int8 weights."""
    dataset = Volumes()
    members = [get_model("unet", KW) for _ in range(2)]
    batch = torch.from_numpy(dataset.read_volume("a", "images")[1:5])
    own = [quant.calibrate_scales(m, [batch], mc_dropout=False)
           for m in members]
    out = _calibrated_quant_model(members, dataset, batch_size=4, seed=20,
                                  ensemble=True, skip_levels=0)
    assert out == members
    union = members[0].quant_scales
    assert union is members[1].quant_scales
    assert set(union) == set(own[0]) == set(own[1])
    for key, value in union.items():
        assert value == max(own[0][key], own[1][key])
    assert not torch.equal(members[0].ConvBlock_1.ConvBnRelu_0.Conv_0.int8_w0,
                           members[1].ConvBlock_1.ConvBnRelu_0.Conv_0.int8_w0)
    other = [get_model("unet", KW), get_model("unet", {**KW, "depth": 2})]
    with pytest.raises(ValueError, match="different quant sites"):
        _calibrated_quant_model(other, dataset, 4, 20, ensemble=True)


def test_clip_debug_names_the_hotter_last_subject(monkeypatch, caplog):
    """``RCU_QUANT_CLIP_DEBUG``: the last subject 4x hotter than the one
    calibrated on gives a warning that names it; the same subject again
    clips nothing (no dropout here, so the two passes see the same
    activations)."""
    monkeypatch.setenv("RCU_QUANT_CLIP_DEBUG", "1")
    torch.manual_seed(0)
    params = {**KW, "dropout": None}
    for hot, level in ((4.0, "WARNING"), (1.0, "INFO")):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            _calibrated_quant_model(get_model("unet", params), Volumes(hot),
                                    4, 20)
        (record,) = [r for r in caplog.records
                     if "int8 clip report" in r.getMessage()]
        assert record.levelname == level
        assert "'c'" in record.getMessage()
    caplog.clear()
    with caplog.at_level(logging.INFO):
        _calibrated_quant_model(get_model("unet", KW), Volumes(4.0), 4, 20,
                                skip_levels=KW["depth"] + 1)
    assert any("clip report skipped" in r.getMessage()
               for r in caplog.records)


def test_clip_report_needs_a_quantized_model():
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 16, 16, 4)
                         .astype(np.float32))
    model = get_model("unet", KW)
    with pytest.raises(ValueError, match="quant_clip"):
        quant.clip_report(model, [x], mc_dropout=False)
    scales = quant.calibrate_scales(model, [x], mc_dropout=False)
    model.quantize(scales)
    calm = quant.clip_report(model, [x], mc_dropout=False)
    assert set(calm) == set(scales) and max(calm.values()) == 0.0
    hot = quant.clip_report(model, [2.5 * x], mc_dropout=False)
    assert max(hot.values()) > 0.01


# --------------------------------------------------------- the whole U-Net

def jax_quantized(params, flax_params, stats, x, skip, scales=None):
    """The JAX package's quantized forward as its direct eval runs it:
    precast params, the dict of a deterministic calibration (or
    ``scales``)."""
    model = flax_get_model("unet", params)
    jp, js = jax_precast_params(model, flax_params, stats)
    variables = {"params": jp, "batch_stats": js}
    if scales is None:
        scales = jax_quant.calibrate_scales(model, variables,
                                            [jnp.asarray(x)],
                                            mc_dropout=False)
    quantized = flax_get_model("unet", {**params, "quant_scales": scales,
                                        "quant_skip_levels": skip})
    return scales, np.asarray(quantized.apply(variables,
                                              jnp.asarray(x)).logits)


def softmax(logits):
    return np.asarray(jax.nn.softmax(logits, -1))


@pytest.mark.parametrize("skip", [0, 1])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("options", [{}, FAST_DECODER_KWARGS])
def test_quantized_unet_matches_flax(options, dtype, skip):
    """Depth 3, 8 filters (``tests/test_quant.py``'s model and inputs),
    given the JAX package's dict: softmax within 5e-3 of flax's quantized
    forward, and the forward went through int8."""
    name = DTYPES[dtype][2]
    params = {**KW, **options, **({"dtype": name} if name else {})}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32, 4)))
    _, flax_params, stats = flax_vars(params, x)
    scales, want = jax_quantized(params, flax_params, stats, x, skip)
    model = port_net("unet", {**params, "quant_scales": scales,
                              "quant_skip_levels": skip}, flax_params, stats)
    plain = int8conv.int8_conv.plain_calls
    with torch.no_grad():
        got = model(nchw(x)).logits.permute(0, 2, 3, 1).numpy()
    assert int8conv.int8_conv.plain_calls > plain
    assert got.dtype == np.float32
    assert np.abs(softmax(got) - softmax(want)).max() < SOFTMAX_BAR


@pytest.mark.parametrize("skip", [0, 1])
def test_quantized_unet_f32_matches_flax_on_perturbed_weights(skip):
    """Perturbed weights with random BatchNorm statistics, where int8 moves
    the softmax far from the plain model's: in f32 the port still tracks
    flax's quantized forward (every int32 sum exact, one rounding each)."""
    params = {**KW, **FAST_DECODER_KWARGS}
    _, flax_params, stats = flax_net("unet", params, (32, 32), seed=3)
    x = np.random.RandomState(1).randn(2, 32, 32, 4).astype(np.float32)
    scales, want = jax_quantized(params, flax_params, stats, x, skip)
    model = port_net("unet", {**params, "quant_scales": scales,
                              "quant_skip_levels": skip}, flax_params, stats)
    with torch.no_grad():
        got = model(nchw(x)).logits.permute(0, 2, 3, 1).numpy()
    assert np.abs(softmax(got) - softmax(want)).max() < 1e-5


def jax_quantized_sites(params, variables, x, skip, scales):
    model = flax_get_model("unet", {**params, "quant_scales": scales,
                                    "quant_skip_levels": skip})
    _, aux = model.apply(variables, jnp.asarray(x), train=False,
                         mutable=[jax_quant.CLIP_COLLECTION])
    return set(jax_quant._flatten_stats(
        aux.get(jax_quant.CLIP_COLLECTION, {})))


@pytest.mark.parametrize("options", [{}, FAST_DECODER_KWARGS])
def test_quantized_sites_per_skip_level_are_jax_s(options):
    """The quantized sites at skip 0, 1, 2 and depth+1 are flax's; the
    fast decoder's level 0 holds 7 of them (``tests/test_quant.py:145``);
    skipping every level is the plain model, bitwise."""
    params = {**KW, **options}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32, 4)))
    model, flax_params, stats = flax_vars(params, x)
    variables = {"params": flax_params, "batch_stats": stats}
    scales = jax_quant.calibrate_scales(model, variables, [jnp.asarray(x)],
                                        mc_dropout=False)
    sites, calls = {}, {}
    for skip in (0, 1, 2, KW["depth"] + 1):
        port = port_net("unet", {**params, "quant_scales": scales,
                                 "quant_skip_levels": skip},
                        flax_params, stats)
        stats_pass = quant.SiteStats("clip")
        before = int8conv.int8_conv.plain_calls
        with torch.no_grad():
            port(nchw(x), stats=stats_pass)
        calls[skip] = int8conv.int8_conv.plain_calls - before
        sites[skip] = set(stats_pass.values)
        assert sites[skip] == jax_quantized_sites(params, variables, x, skip,
                                                  scales)
        assert calls[skip] == len(sites[skip])
    if options:
        assert calls[0] - calls[1] == 7
    assert calls[KW["depth"] + 1] == 0
    plain = port_net("unet", params, flax_params, stats)
    skipped = port_net("unet", {**params, "quant_scales": scales,
                                "quant_skip_levels": KW["depth"] + 1},
                       flax_params, stats)
    gens = [torch.Generator().manual_seed(2)]
    with torch.no_grad():
        assert torch.equal(plain(nchw(x)[:1], gens).logits,
                           skipped(nchw(x)[:1], [
                               torch.Generator().manual_seed(2)]).logits)


def test_port_dict_drives_flax_and_back():
    """Keys letter for letter: a dict calibrated by the port runs flax's
    quantized model, and flax's the port's."""
    params = {**KW, **FAST_DECODER_KWARGS}
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32, 4)))
    _, flax_params, stats = flax_vars(params, x)
    port_scales = quant.calibrate_scales(
        port_net("unet", params, flax_params, stats), [torch.from_numpy(x)],
        mc_dropout=False)
    _, from_port = jax_quantized(params, flax_params, stats, x, 0,
                                 scales=port_scales)
    jax_scales, _ = jax_quantized(params, flax_params, stats, x, 0)
    model = port_net("unet", {**params, "quant_scales": jax_scales},
                     flax_params, stats)
    with torch.no_grad():
        got = model(nchw(x)).logits.permute(0, 2, 3, 1).numpy()
    assert np.abs(softmax(got) - softmax(from_port)).max() < SOFTMAX_BAR


def test_guards():
    """Residual models and an out-of-range skip raise as in flax; a dict
    of another decoder topology raises a KeyError that says calibrate."""
    with pytest.raises(NotImplementedError, match="residual"):
        get_model("unet", {**KW, "residual": True, "quant_scales": {"x": 1.0}})
    for skip in (-1, KW["depth"] + 2):
        with pytest.raises(ValueError, match="quant_skip_levels"):
            get_model("unet", {**KW, "quant_scales": {"x": 1.0},
                               "quant_skip_levels": skip})
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 32, 32, 4)
                         .astype(np.float32))
    scales = quant.calibrate_scales(get_model("unet", KW), [x],
                                    mc_dropout=False)
    wrong = get_model("unet", {**KW, **FAST_DECODER_KWARGS,
                               "quant_scales": scales})
    with pytest.raises(KeyError, match="calibrate"):
        wrong(x.permute(0, 3, 1, 2))
    # the sigma head and the PostNet stay unquantized
    sigma = get_model("unet", {**KW, "sigma_out": True,
                               "quant_scales": scales})
    assert sigma.ConvBnRelu_1.quant_scales is None
    assert sigma.ConvBnRelu_0.quant_scales is scales
