"""The strategy families' model parts against flax, on carried weights: the
sigma head, the decoder features, the PostNet, the weight converter, the
aleatoric forward, and the ``ops.prepare`` rescale and fold.

Forwards hold the bar of tests/test_model_weight_parity.py (rtol 1e-3,
atol 2e-4); converted weights equal the flax arrays exactly; the prepare
ops are bit-equal, the division at most 1 ulp apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.engine import steps as jax_steps
from rcu_tpu.engine.config import ParametricNode as JaxNode
from rcu_tpu.models.unet import UNetOutput as FlaxOutput
from rcu_tpu.ops import prepare as jax_prepare
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval.direct import load_model
from rcu_tpu_torch.models import UNetOutput, get_model
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.ops import prepare
from tests.test_torch_checkpoint import _flat
from tests.test_torch_unet import flax_net

BAR = dict(rtol=1e-3, atol=2e-4)
SIGMA = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
             dropout=0.2, sigma_out=True)
FEATURES = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
                dropout=0.2, provide_features=True)
POSTNET = dict(nb_classes=2, in_channels=4)


def port_net(model_type, params, flax_params, stats):
    model = get_model(model_type, params)
    model.load_state_dict(state_dict_from_flax(flax_params, stats))
    return model


def nhwc(x):
    return x.permute(0, 2, 3, 1).numpy()


def port_forward(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())


@pytest.mark.parametrize("depth,hw", [(2, (16, 20)), (3, (45, 53))])
def test_sigma_unet_matches_flax(depth, hw):
    params = {**SIGMA, "depth": depth}
    fm, flax_params, stats = flax_net("unet", params, hw, seed=depth)
    x = np.random.RandomState(1).rand(2, *hw, 4).astype(np.float32)
    want = fm.apply({"params": flax_params, "batch_stats": stats}, x)
    got = port_forward(port_net("unet", params, flax_params, stats), x)
    assert np.abs(np.asarray(want.sigma)).max() > 0.05
    np.testing.assert_allclose(nhwc(got.logits), np.asarray(want.logits), **BAR)
    np.testing.assert_allclose(nhwc(got.sigma), np.asarray(want.sigma), **BAR)
    assert got.features is None


@pytest.mark.parametrize("params", [FEATURES, {**FEATURES, "sigma_out": True}])
def test_features_match_flax(params):
    fm, flax_params, stats = flax_net("unet", params, (16, 20), seed=5)
    x = np.random.RandomState(2).rand(2, 16, 20, 4).astype(np.float32)
    want = fm.apply({"params": flax_params, "batch_stats": stats}, x)
    got = port_forward(port_net("unet", params, flax_params, stats), x)
    np.testing.assert_allclose(nhwc(got.features), np.asarray(want.features),
                               **BAR)
    np.testing.assert_allclose(nhwc(got.logits), np.asarray(want.logits), **BAR)


def test_features_are_what_the_heads_read():
    """Both heads read the decoder output, and nothing writes into it
    afterwards: the features returned equal each head's input as it was
    when the head ran, also under MC dropout."""
    from rcu_tpu_torch.eval.pipeline import sample_generators
    params = {**FEATURES, "sigma_out": True}
    _, flax_params, stats = flax_net("unet", params, (16, 16), seed=6)
    model = port_net("unet", params, flax_params, stats)
    seen = {}
    for name in ("ConvBnRelu_0", "ConvBnRelu_1"):
        getattr(model, name).register_forward_pre_hook(
            lambda m, args, name=name: seen.__setitem__(name, args[0].clone()))
    x = torch.from_numpy(np.random.RandomState(3).rand(2, 4, 16, 16)
                         .astype(np.float32))
    for gens in (None, sample_generators((1, 0), 0, 1, "cpu")):
        with torch.no_grad():
            out = model(x, gens)
        assert torch.equal(seen["ConvBnRelu_0"], out.features)
        assert torch.equal(seen["ConvBnRelu_1"], out.features)


@pytest.mark.parametrize("in_channels,nb_convs", [(4, 3), (6, 1)])
def test_postnet_matches_flax(in_channels, nb_convs):
    params = dict(nb_classes=2, in_channels=in_channels, nb_convs=nb_convs)
    fm, flax_params, stats = flax_net("postnet", params, (16, 20), seed=7)
    x = np.random.RandomState(4).rand(2, 16, 20, in_channels).astype(np.float32)
    want = fm.apply({"params": flax_params, "batch_stats": stats}, x).logits
    got = port_forward(port_net("postnet", params, flax_params, stats), x)
    assert np.abs(np.asarray(want)).max() > 0.05
    np.testing.assert_allclose(nhwc(got.logits), np.asarray(want), **BAR)


@pytest.mark.parametrize("model_type,params", [
    ("unet", SIGMA), ("unet", FEATURES), ("postnet", POSTNET)])
def test_converter_loads_strict_and_exact(model_type, params):
    _, flax_params, stats = flax_net(model_type, params, (16, 16), seed=8)
    model = get_model(model_type, params)
    state = state_dict_from_flax(flax_params, stats)
    model.load_state_dict(state, strict=True)
    held = model.state_dict()
    for path, value in _flat(flax_params):
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
        want = value.transpose(3, 2, 0, 1) if path[-1] == "kernel" else value
        assert torch.equal(held[".".join(path[:-1] + (leaf,))],
                           torch.from_numpy(np.ascontiguousarray(want))), path
    for path, value in _flat(stats):
        leaf = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        assert torch.equal(held[".".join(path[:-1] + (leaf,))],
                           torch.from_numpy(value)), path
    if model_type == "unet" and params.get("sigma_out"):
        assert {"ConvBnRelu_1", "Conv_3"} <= set(flax_params)


@pytest.mark.parametrize("recorded", [None, 0, 4])
def test_postnet_in_channels_from_the_checkpoint(tmp_path, recorded):
    """flax infers the PostNet's width; a model.json without it (or with 0)
    loads with the checkpoint's."""
    _, flax_params, stats = flax_net("postnet", POSTNET, (8, 8), seed=9)
    record = {"nb_classes": 2}
    if recorded is not None:
        record["in_channels"] = recorded
    mf = jax_ckpt.ModelFiles.from_model_dir(str(tmp_path / "post"))
    jax_ckpt.backup_model_parameters(mf, JaxNode("postnet", record), None)
    jax_ckpt.save_checkpoint(mf, {"params": flax_params, "batch_stats": stats,
                                  "epoch": 1, "best_score": 0.5},
                             epoch=1, best=True)
    model = load_model(str(tmp_path / "post"), "best", "cpu")
    assert model.ConvBnRelu_0.Conv_0.in_channels == 4


class StubFlax:
    """A flax-like model that returns fixed NHWC logits and sigma."""

    def __init__(self, logits, sigma):
        self.out = FlaxOutput(jnp.asarray(logits), jnp.asarray(sigma))

    def apply(self, variables, images, train=False):
        return self.out


class StubTorch(torch.nn.Module):
    def __init__(self, logits, sigma):
        super().__init__()
        self.out = UNetOutput(torch.from_numpy(logits).permute(0, 3, 1, 2),
                              torch.from_numpy(sigma).permute(0, 3, 1, 2))

    def forward(self, x):
        return self.out


@pytest.mark.parametrize("is_log_sigma", [False, True])
def test_aleatoric_forward_matches_jax(is_log_sigma):
    """Same probabilities, sigma and predicted-class sigma; the prediction
    is the argmax of the probabilities: logits that softmax cannot tell
    apart (0.1 and its next f32) and equal ones tie, and go to class 0."""
    rng = np.random.RandomState(10)
    logits = rng.randn(2, 5, 6, 2).astype(np.float32)
    sigma = rng.randn(2, 5, 6, 2).astype(np.float32)
    logits[0, 0, 0] = [0.1, np.nextafter(np.float32(0.1), np.float32(1))]
    logits[0, 0, 1] = [0.3, 0.3]
    images = np.zeros((2, 5, 6, 1), np.float32)
    want = jax_steps.aleatoric_forward(StubFlax(logits, sigma), {}, images,
                                       is_log_sigma)
    got = steps.aleatoric_forward(StubTorch(logits, sigma),
                                  torch.from_numpy(images), is_log_sigma)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    assert np.asarray(want[2])[0, 0, 0] == got[2][0, 0, 0] == 0
    assert got[2][0, 0, 1] == 0
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _planes(seed):
    """Random f32 maps with spread, a constant map and a tiny range."""
    rng = np.random.RandomState(seed)
    return {"spread": (rng.randn(3, 7, 9) * 3).astype(np.float32),
            "constant": np.full((3, 7, 9), 0.25, np.float32),
            "narrow": (0.5 + 1e-4 * rng.rand(3, 7, 9)).astype(np.float32)}


def assert_ulp(got, want, maxulp):
    """Equal NaN positions; elsewhere at most ``maxulp`` f32 ulp apart."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_array_max_ulp(got[finite], want[finite], maxulp=maxulp)


@pytest.mark.parametrize("kind", ["spread", "constant", "narrow"])
def test_subject_rescale_and_fold_match_jax(kind):
    x = _planes(11)[kind]
    want = np.asarray(jax_prepare.rescale_subject_min_max(jnp.asarray(x)))
    got = prepare.rescale_subject_min_max(torch.from_numpy(x)).numpy()
    assert_ulp(got, want, 1)
    assert np.isnan(want).all() == (kind == "constant")
    prediction = (np.random.RandomState(12).rand(*x.shape) < 0.5) \
        .astype(np.uint8)
    folded_want = np.asarray(jax_prepare.uncertainty_to_foreground_probabilities(
        jnp.asarray(want), jnp.asarray(prediction)))
    folded_got = prepare.uncertainty_to_foreground_probabilities(
        torch.from_numpy(np.array(want)), torch.from_numpy(prediction)).numpy()
    assert_ulp(folded_got, folded_want, 0)


def test_global_rescale_matches_jax():
    """The aleatoric pass B rescale by f32 global bounds."""
    x = np.abs(_planes(13)["spread"])
    lo, hi = np.float32(x.min() - 0.1), np.float32(x.max() + 0.3)
    want = np.asarray(jax_prepare.rescale_linear(jnp.asarray(x), lo, hi))
    got = prepare.rescale_linear(torch.from_numpy(x), float(lo), float(hi))
    assert got.dtype == torch.float32
    assert_ulp(got.numpy(), want, 1)
    assert 0.0 < want.min() and want.max() < 1.0
