"""The port's inference variants against the JAX package's: the fast
decoder in f32, one fused upsample conv, the bf16 compute dtype (logits,
sigma, PostNet confidence), precast weights and the registry; and the
helpers and weights of the direct eval end to end in bf16 with the fast
decoder (``tests/test_torch_variants_e2e.py``,
``tests/test_torch_variants_ensemble.py``) and with the fold
(``tests/test_torch_fold_bn_e2e.py``, ``tests/test_torch_fold_bn_ensemble.py``).

Model-level forwards use perturbed flax init weights with random BN
statistics (``tests.test_torch_unet.flax_net``). The end-to-end runs use
weights whose bf16 noise is that of a trained model rather than of a
random one (:func:`e2e_net`): BatchNorm statistics of the test images, the
class heads spread and centred, and antisymmetric, so that both logits are
half the logit difference. Each family of ``rcu_tpu.eval.direct`` runs
with the same flags on the same flax checkpoints and store; per-subject
ECE and Dice must stay within the JAX package's bf16 gate
(``tests/test_bf16_parity.py``: 1e-3, 2e-3 for the sigma protocol).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from rcu_tpu.data import h5
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu.models.unet import _fused_upsample_conv
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.models import (FAST_DECODER_KWARGS, get_model,
                                  precast_params)
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.models.unet import upsample_conv
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_direct import make_store, read_dir
from tests.test_torch_strategies import (apply, make_wpred_store,
                                         spread_head, write_config,
                                         write_model)
from tests.test_torch_unet import flax_net

BAR = dict(rtol=1e-3, atol=2e-4)  # the f32 bar of test_model_weight_parity
F32_ATOL = 0.15  # bf16 against f32, tests/test_mixed_precision.py:31-41
BF16_STEP = 2.0 ** -8  # a bf16 value's relative step (8 significant bits)
GATE = 1e-3  # ECE/Dice, tests/test_bf16_parity.py:46
SIGMA_ENVELOPE = 2e-3  # the sigma protocol's, tests/test_bf16_parity.py:47
E2E_SHAPE = (96, 32, 32)
UNET = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
            dropout=0.2)
TEST_SUBJECTS = ("s02", "s03")


def roundings(depth, split=False, nb_convs=None):
    """The bf16 roundings on the way from the input to a U-Net's logits
    (or, with ``nb_convs``, a PostNet's): the input cast, each ConvBnRelu's
    conv and BatchNorm outputs (4 depth + 3 of them), each up-conv and,
    split, each decoder add, the class conv."""
    if nb_convs is not None:
        return 1 + 2 * nb_convs
    return 1 + 2 * (4 * depth + 3) + depth * (2 if split else 1) + 1


def bf16_bar(n_roundings, scale):
    """Port and flax round at different points (cuDNN and oneDNN add a
    conv's bias before rounding its output, XLA after it), so each rounding
    may put them one step apart; the normalised trunk passes a relative
    error on without growing it. Two bf16 outputs of scale ``scale`` thus
    differ by at most this much."""
    return n_roundings * BF16_STEP * scale


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2) \
        .contiguous()


def port_net(model_type, params, flax_params, stats, precast=True):
    model = get_model(model_type, params)
    model.load_state_dict(state_dict_from_flax(flax_params, stats))
    return precast_params(model) if precast else model


def port_out(model, x):
    with torch.no_grad():
        out = model(nchw(x))
    return {k: v.permute(0, 2, 3, 1).numpy() for k, v in out._asdict().items()
            if v is not None}


def flax_out(model_type, params, flax_params, stats, x):
    out = flax_get_model(model_type, params).apply(
        {"params": flax_params, "batch_stats": stats}, x)
    return {k: np.asarray(v, np.float32) for k, v in out._asdict().items()
            if v is not None}


@pytest.mark.parametrize("depth,start,hw,options", [
    (2, 8, (32, 32), FAST_DECODER_KWARGS),
    (3, 4, (45, 53), FAST_DECODER_KWARGS),  # odd sides: _pad_to pads
    (3, 4, (45, 53), {"split_decoder_concat": True}),
    (3, 4, (45, 53), {"fused_upsample": True}),
    (2, 4, (16, 24), {**FAST_DECODER_KWARGS, "sigma_out": True}),
])
def test_f32_fast_decoder_matches_flax(depth, start, hw, options):
    params = dict(nb_classes=2, in_channels=3, depth=depth,
                  start_filters=start, dropout=0.2, **options)
    _, flax_params, stats = flax_net("unet", params, hw, seed=depth)
    x = np.random.RandomState(5).rand(2, *hw, 3).astype(np.float32)
    want = flax_out("unet", params, flax_params, stats, x)
    got = port_out(port_net("unet", params, flax_params, stats), x)
    assert got.keys() == want.keys()
    assert np.abs(want["logits"]).max() > 0.05  # a forward that says something
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, **BAR)


@pytest.mark.parametrize("hw", [(4, 4), (5, 7), (12, 9)])
def test_fused_upsample_layer_is_conv_of_upsample(hw):
    """One layer: the folded, flipped, transposed 4x4 kernel against
    ``conv3x3(nearest_up_2x(x))``, and against the JAX package's
    ``_fused_upsample_conv`` on the same weights."""
    rng = np.random.RandomState(hw[0])
    x = rng.randn(2, 6, *hw).astype(np.float32)
    weight = rng.randn(5, 6, 3, 3).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    xt, wt, bt = map(torch.from_numpy, (x, weight, bias))
    got = upsample_conv(xt, wt, bt)
    want = F.conv2d(F.interpolate(xt, scale_factor=2, mode="nearest"), wt, bt,
                    padding=1)
    assert got.shape == want.shape == (2, 5, 2 * hw[0], 2 * hw[1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    flax = _fused_upsample_conv(jnp.asarray(x.transpose(0, 2, 3, 1)),
                                jnp.asarray(weight.transpose(2, 3, 1, 0)),
                                jnp.asarray(bias), None)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(flax), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("depth,start,hw,options", [
    (2, 8, (32, 32), {}),
    (2, 8, (32, 32), FAST_DECODER_KWARGS),
    (3, 4, (45, 53), {**FAST_DECODER_KWARGS, "sigma_out": True}),
    (2, 4, (16, 24), {"sigma_out": True}),
])
def test_bf16_unet_matches_flax_bf16(depth, start, hw, options):
    """Logits (and sigma): port bf16 against flax bf16 within
    :func:`bf16_bar`, each within 0.15 of its own f32 forward."""
    params = dict(nb_classes=2, in_channels=3, depth=depth,
                  start_filters=start, dropout=0.2, **options)
    _, flax_params, stats = flax_net("unet", params, hw, seed=depth)
    x = np.random.RandomState(5).rand(2, *hw, 3).astype(np.float32)
    bf16 = {**params, "dtype": "bfloat16"}
    want32 = flax_out("unet", params, flax_params, stats, x)
    want = flax_out("unet", bf16, flax_params, stats, x)
    got = port_out(port_net("unet", bf16, flax_params, stats), x)
    got32 = port_out(port_net("unet", params, flax_params, stats), x)
    n = roundings(depth, params.get("split_decoder_concat", False))
    for key in want:
        assert got[key].dtype == np.float32
        scale = np.abs(want32[key]).max()
        assert np.abs(got[key] - want[key]).max() <= bf16_bar(n, scale), key
        assert np.abs(want[key] - want32[key]).max() <= F32_ATOL, key
        assert np.abs(got[key] - got32[key]).max() <= F32_ATOL, key
        assert not np.array_equal(got[key], got32[key])  # bf16 did run


@pytest.mark.parametrize("in_channels,nb_convs", [(4, 3), (8, 1)])
def test_bf16_postnet_confidence_matches_flax_bf16(in_channels, nb_convs):
    params = dict(nb_classes=2, in_channels=in_channels, nb_convs=nb_convs)
    _, flax_params, stats = flax_net("postnet", params, (16, 20), seed=3)
    x = np.abs(np.random.RandomState(3).randn(2, 16, 20, in_channels)) \
        .astype(np.float32)  # features after a ReLU
    bf16 = {**params, "dtype": "bfloat16"}
    want32 = flax_out("postnet", params, flax_params, stats, x)["logits"]
    want = flax_out("postnet", bf16, flax_params, stats, x)["logits"]
    got = port_out(port_net("postnet", bf16, flax_params, stats), x)["logits"]
    bar = bf16_bar(roundings(None, nb_convs=nb_convs), 1.0)
    conf = {k: np.asarray(jax.nn.softmax(v, -1))[..., 1]
            for k, v in (("got", got), ("want", want), ("want32", want32))}
    assert np.abs(conf["got"] - conf["want"]).max() <= bar
    assert np.abs(want - want32).max() <= F32_ATOL
    assert np.abs(got - want32).max() <= F32_ATOL


def leaf_dtypes(model):
    return {name: p.dtype for name, p in
            list(model.named_parameters()) + list(model.named_buffers())
            if p.is_floating_point()}


@pytest.mark.parametrize("model_type,params", [
    ("unet", dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
                  dropout=0.2)),
    ("unet", dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
                  dropout=0.2, sigma_out=True, **FAST_DECODER_KWARGS)),
    ("postnet", dict(nb_classes=2, in_channels=3))])
def test_precast_is_bitwise_the_cast_at_each_call(model_type, params):
    """Weights cast once at load give bitwise the outputs of f32 weights
    cast at every call; BatchNorm and the f32 heads stay f32."""
    bf16 = {**params, "dtype": "bfloat16"}
    _, flax_params, stats = flax_net(model_type, params, (16, 16), seed=1)
    x = np.random.RandomState(1).rand(2, 16, 16, 3).astype(np.float32)
    lazy = port_net(model_type, bf16, flax_params, stats, precast=False)
    cast = port_net(model_type, bf16, flax_params, stats)
    assert all(dt == torch.float32 for dt in leaf_dtypes(lazy).values())
    want, got = port_out(lazy, x), port_out(cast, x)
    assert want.keys() == got.keys()
    for key in want:
        assert np.array_equal(want[key], got[key]), key
    heads = ("ConvBnRelu_1.", "Conv_3.") if params.get("sigma_out") \
        else ("Conv_0.",) if model_type == "postnet" else ()
    for name, dt in leaf_dtypes(cast).items():
        f32 = "BatchNorm" in name or name.startswith(heads)
        assert dt == (torch.float32 if f32 else torch.bfloat16), name
    # a float32 model is left as it is
    plain = port_net(model_type, params, flax_params, stats, precast=False)
    before = leaf_dtypes(plain)
    assert precast_params(plain) is plain and leaf_dtypes(plain) == before


def test_registry_dtypes_and_unported_int8():
    """The compute dtypes; int8 ``quant_scales`` and ``quant_skip_levels``
    build a quantized U-Net (ported since the int8 slice), a bad skip
    raises as in flax."""
    params = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4)
    assert get_model("unet", {**params, "dtype": "bfloat16"}).dtype \
        == torch.bfloat16
    for neutral in (None, "float32"):
        assert get_model("unet", {**params, "dtype": neutral}).dtype \
            == torch.float32
    assert get_model("postnet", dict(nb_classes=2, in_channels=4,
                                     dtype="bfloat16")).dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="float16"):
        get_model("unet", {**params, "dtype": "float16"})
    quantized = get_model("unet", {**params, "quant_scales": {"site": 1.0},
                                   "quant_skip_levels": 1})
    assert quantized.quant_scales == {"site": 1.0}
    assert quantized.ConvBlock_1.ConvBnRelu_0.quant_scales == {"site": 1.0}
    assert quantized.ConvBlock_0.ConvBnRelu_0.quant_scales is None
    with pytest.raises(ValueError, match="quant_skip_levels"):
        get_model("unet", {**params, "quant_skip_levels": 4})


def calibrate(model_type, params, flax_params, stats, x):
    """BatchNorm statistics of ``x``, as a trained model's are: one
    train-mode apply without dropout (no gradient step) moves the running
    statistics to 0.9 old + 0.1 batch; solve for the batch's."""
    model = flax_get_model(model_type, {**params, "dropout": None})
    _, moved = model.apply({"params": flax_params, "batch_stats": stats}, x,
                           train=True, mutable=["batch_stats"])
    return jax.tree_util.tree_map(
        lambda new, old: (np.asarray(new) - np.float32(0.9) * old)
        / np.float32(0.1), moved["batch_stats"], stats)


def antisymmetric(flax_params, key):
    """The 2-class 1x1 conv ``key`` rewritten to give minus and plus half
    its logit difference: the same softmax, with no common part that bf16
    would round at the logits' size."""
    head = flax_params[key]
    k, b = head["kernel"], head["bias"]
    half = (k[..., 1] - k[..., 0]) / 2
    return {**flax_params, key: {
        "kernel": np.stack([-half, half], -1).astype(np.float32),
        "bias": np.float32([(b[0] - b[1]) / 2, (b[1] - b[0]) / 2])}}


def e2e_net(model_type, params, x, seed, head, std=4.0):
    """Seeded flax weights with :func:`calibrate`'d statistics and the head
    ``head`` spread (logit difference of std ``std`` and median 0 on
    ``x``) and made :func:`antisymmetric`."""
    fm, flax_params, stats = flax_net(model_type, params, x.shape[1:3], seed)
    stats = calibrate(model_type, params, flax_params, stats, x)
    flax_params = spread_head(fm, flax_params, stats, x, head, std=std)
    return fm, antisymmetric(flax_params, head), stats


def read_volumes(store):
    reader = h5.SubjectDataset(store)
    out = [(np.asarray(reader.read_volume(s, "images")),
            np.asarray(reader.read_volume(s, "labels"))) for s in TEST_SUBJECTS]
    reader.close()
    return out


def build_e2e_env(tmp):
    """{family: config file} over one (96, 32, 32) store and its
    [gt, baseline] twin: deterministic, mc (3 samples), a 3-member
    ensemble, segmenter + PostNet, a 5-channel error net and a sigma head."""
    store = make_store(tmp, E2E_SHAPE)
    wpred = make_wpred_store(tmp, store)
    split_file = str(tmp / "split.json")
    save_split(split_file, ["s00"], ["s01"], list(TEST_SUBJECTS))
    x = np.concatenate([v for v, _ in read_volumes(store)])
    configs = {}

    def config(name, model_dir, others, dataset=store):
        configs[name] = write_config(tmp / f"{name}.yaml", name, model_dir,
                                     split_file, dataset, others)

    _, p, stats = e2e_net("unet", UNET, x, 1, "Conv_2", std=2.0)
    plain = write_model(tmp / "plain", "unet", UNET, p, stats)
    config("deterministic", plain, {"mc": 0})
    config("mc", plain, {"mc": 3})
    members = [write_model(tmp / f"member{k}", "unet", UNET,
                           *e2e_net("unet", UNET, x, 10 + k, "Conv_2")[1:])
               for k in range(3)]
    config("ensemble", members[0], {"model_dir": members[1:],
                                    "test_at": "best"})
    features = {**UNET, "provide_features": True}
    fm, p, stats = e2e_net("unet", features, x, 20, "Conv_2")
    segmenter = write_model(tmp / "segmenter", "unet", UNET, p, stats)
    post = dict(nb_classes=2, in_channels=UNET["start_filters"])
    _, pp, pstats = e2e_net("postnet", post, np.asarray(
        apply(fm, p, stats, x).features), 21, "Conv_0")
    config("auxiliary_feat", write_model(tmp / "postnet", "postnet",
                                         {"nb_classes": 2}, pp, pstats),
           {"model_dir": segmenter, "test_at": "best"})
    error_net = {**UNET, "in_channels": 5}
    inputs = np.concatenate([
        np.concatenate([v, y[..., 1:].astype(np.float32)], -1)
        for v, y in read_volumes(wpred)])
    config("auxiliary_segm", write_model(
        tmp / "error_net", "unet", error_net,
        *e2e_net("unet", error_net, inputs, 30, "Conv_2")[1:]), {}, wpred)
    sigma = {**UNET, "sigma_out": True}
    fm, p, stats = e2e_net("unet", sigma, x, 40, "Conv_2")
    # a sigma range wide against bf16's noise, and above 0.5 (as in
    # test_torch_strategies.aleatoric_weights)
    p = {**p, "Conv_3": {k: np.float32(10) * v for k, v in p["Conv_3"].items()}}
    low = float(np.asarray(apply(fm, p, stats, x).sigma).min())
    p = {**p, "Conv_3": {**p["Conv_3"],
                         "bias": p["Conv_3"]["bias"] + np.float32(0.5 - low)}}
    config("aleatoric", write_model(tmp / "sigma", "unet", sigma, p, stats),
           {"is_log_sigma": False})
    return configs


def read_ece_dice(out_dir):
    rows = next(rows for name, rows in read_dir(out_dir).items()
                if name.startswith("eval_ece_"))
    ece, dice = rows[0].index("ece"), rows[0].index("dice")
    return {r[1]: (float(r[ece]), float(r[dice])) for r in rows[1:]}


def assert_within_gate(want_dir, got_dir, gate):
    """The same CSV files with the same headers and row keys; per-subject
    ECE and Dice within ``gate``."""
    want, got = read_dir(want_dir), read_dir(got_dir)
    assert got.keys() == want.keys()
    assert len(want) == 14  # calibration, ece, minmax + 11 thresholds
    for name, rows in want.items():
        keys = 1 if "minmax" in name else 2  # entry / (test_id, subject)
        assert [r[:keys] for r in got[name]] == [r[:keys] for r in rows], name
    want, got = read_ece_dice(want_dir), read_ece_dice(got_dir)
    assert want.keys() == got.keys() == set(TEST_SUBJECTS)
    for subject, (ece, dice) in want.items():
        assert abs(got[subject][0] - ece) <= gate, (subject, got, want)
        assert abs(got[subject][1] - dice) <= gate, (subject, got, want)
    return got


def run_both(config_file, out_dir, strategy, **flags):
    """The JAX package's and the port's direct eval with the same flags;
    the port launches its eval once per subject."""
    jax_evaluate_direct(jax_cfg.load(config_file, "test-config"),
                        str(out_dir / "jax"), run_id=strategy,
                        strategy=strategy, **flags)
    plain = evalstats.fused_eval_stats.plain_calls
    port_direct.evaluate_direct(port_cfg.load(config_file),
                                str(out_dir / "port"), run_id=strategy,
                                strategy=strategy, device="cpu", **flags)
    assert evalstats.fused_eval_stats.plain_calls == plain + 2
    return out_dir / "jax", out_dir / "port"
