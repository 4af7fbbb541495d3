"""The PyTorch port's U-Net against the flax U-Net, on carried weights.

Deterministic forwards hold the bar of tests/test_model_weight_parity.py
(rtol 1e-3, atol 2e-4); MC dropout cannot share flax's random masks, so its
mean softmax over many samples is held to atol 0.02.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval.pipeline import sample_generators
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.models.convert import state_dict_from_flax


def _randomize_stats(tree, rng):
    """Running BN statistics away from the init's (0, 1), so the test sees
    the mean/var mapping."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = _randomize_stats(value, rng)
        elif key == "mean":
            out[key] = (0.05 * rng.randn(*value.shape)).astype(np.float32)
        else:
            out[key] = (0.5 + rng.rand(*value.shape)).astype(np.float32)
    return out


def flax_unet(params: dict, hw, seed: int = 0):
    """A flax UNet with perturbed init weights and random BN statistics.
    Returns (flax model, params, batch_stats) with numpy leaves."""
    return flax_net("unet", params, hw, seed)


def flax_net(model_type: str, params: dict, hw, seed: int = 0):
    """:func:`flax_unet` for any model type of the registry (a PostNet's
    input width is its ``in_channels``)."""
    model = flax_get_model(model_type, params)
    x0 = np.zeros((1, *hw, params["in_channels"]), np.float32)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, x0, train=False)
    rng = np.random.RandomState(seed)
    flax_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
        variables["params"])
    stats = _randomize_stats(jax.tree_util.tree_map(
        np.asarray, variables["batch_stats"]), rng)
    return model, flax_params, stats


def port_unet(params: dict, flax_params, stats):
    model = get_model("unet", params)
    model.load_state_dict(state_dict_from_flax(flax_params, stats))
    return model


def port_logits(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    return out.logits.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("depth,start,hw,dropout_center", [
    (2, 8, (32, 32), None),
    (3, 4, (45, 53), None),   # odd sides: max-pool floors, _pad_to pads
    (3, 4, (45, 53), 1),
    (2, 4, (16, 24), 2),
])
def test_deterministic_logits_match_flax(depth, start, hw, dropout_center):
    params = dict(nb_classes=2, in_channels=3, depth=depth,
                  start_filters=start, dropout=0.2,
                  dropout_center=dropout_center)
    fm, flax_params, stats = flax_unet(params, hw, seed=depth)
    x = np.random.RandomState(5).rand(2, *hw, 3).astype(np.float32)
    want = fm.apply({"params": flax_params, "batch_stats": stats}, x,
                    train=False, mc_dropout=False).logits
    got = port_logits(port_unet(params, flax_params, stats), x)
    assert np.abs(np.asarray(want)).max() > 0.05  # a forward that says something
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("dropout_center", [None, 1])
def test_mc_mean_matches_flax(dropout_center):
    params = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4,
                  dropout=0.3, dropout_center=dropout_center)
    fm, flax_params, stats = flax_unet(params, (16, 16), seed=3)
    # sharper logits, so that dropout moves the mean well past the bar
    flax_params["Conv_2"] = {k: 4 * v for k, v in flax_params["Conv_2"].items()}
    x = np.random.RandomState(3).rand(1, 16, 16, 2).astype(np.float32)
    T = 1000

    def one(key):
        out = fm.apply({"params": flax_params, "batch_stats": stats}, x,
                       train=False, mc_dropout=True, rngs={"dropout": key})
        return jax.nn.softmax(out.logits, -1)

    keys = jax.random.split(jax.random.PRNGKey(0), T)
    flax_mean = np.asarray(jnp.mean(jax.vmap(one)(keys), axis=0))
    model = port_unet(params, flax_params, stats)
    with torch.no_grad():
        probs = steps.mc_forward(model, torch.from_numpy(x),
                                 sample_generators((7, 0), 0, T, "cpu"))
    port_mean = steps.multi_prediction_summary(probs)["probabilities"].numpy()
    deterministic = np.asarray(jax.nn.softmax(fm.apply(
        {"params": flax_params, "batch_stats": stats}, x).logits, -1))
    # dropout moves the mean, so the bar below tests the dropout semantics
    assert np.abs(flax_mean - deterministic).max() > 0.04
    np.testing.assert_allclose(port_mean, flax_mean, atol=0.02)


def _mc_probs(model, x, rng, batch_index, mc_steps):
    with torch.no_grad():
        return steps.mc_forward(model, torch.from_numpy(x), sample_generators(
            rng, batch_index, mc_steps, "cpu"))


def test_mc_stream_is_seeded_and_per_sample():
    params = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4,
                  dropout=0.3)
    _, flax_params, stats = flax_unet(params, (16, 16), seed=4)
    model = port_unet(params, flax_params, stats)
    x = np.random.RandomState(4).rand(2, 16, 16, 2).astype(np.float32)
    a = _mc_probs(model, x, (20, 1), 0, 4)
    assert torch.equal(a, _mc_probs(model, x, (20, 1), 0, 4))
    # sample t's masks do not depend on how many samples ride the forward
    assert torch.equal(a[:2], _mc_probs(model, x, (20, 1), 0, 2))
    assert not torch.equal(a, _mc_probs(model, x, (20, 1), 1, 4))
    assert not torch.equal(a, _mc_probs(model, x, (20, 2), 0, 4))
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("option,neutral,value", [
    ("residual", False, True), ("split_decoder_concat", False, True),
    ("dtype", "float32", "bfloat16"), ("fused_upsample", False, True),
    ("fold_bn", False, True), ("bn", True, False)])
def test_unported_model_options_raise(option, neutral, value):
    """Options of later slices raise; the inference variants among them
    (bf16, the fast decoder, the BN fold) are ported now and build with
    the option set (tests/test_torch_variants.py holds them to flax)."""
    params = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4)
    get_model("unet", {**params, option: neutral})  # model.json records these
    if option in ("dtype", "split_decoder_concat", "fused_upsample",
                  "fold_bn"):
        model = get_model("unet", {**params, option: value})
        assert getattr(model, option) == \
            (torch.bfloat16 if option == "dtype" else value)
        return
    with pytest.raises(NotImplementedError):
        get_model("unet", {**params, option: value})


@pytest.mark.parametrize("model_type,params", [
    ("unet", dict(nb_classes=2, in_channels=2, depth=2, start_filters=4,
                  provide_features=True)),
    ("unet", dict(nb_classes=2, in_channels=2, depth=2, start_filters=4,
                  sigma_out=True)),
    ("postnet", dict(nb_classes=2, in_channels=4))])
def test_ported_heads_build(model_type, params):
    """The options that the strategy families need now build."""
    model = get_model(model_type, params)
    out = model(torch.zeros(1, params["in_channels"], 8, 8))
    assert out.logits.shape == (1, 2, 8, 8)
    assert (out.features is not None) == params.get("provide_features", False)
    assert (out.sigma is not None) == params.get("sigma_out", False)


def test_training_mode_is_refused():
    """Training mode is for the unfolded float32 models: the BN fold, int8
    and bf16 are inference variants and refuse it."""
    params = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4)
    model = get_model("unet", params)
    assert not model.training
    assert model.train() is model and model.training
    assert all(m.training for m in model.modules())
    model.eval()
    assert not model.training
    postnet = get_model("postnet", dict(nb_classes=2, in_channels=4))
    assert postnet.train().training
    for variant in ({"fold_bn": True}, {"dtype": "bfloat16"},
                    {"quant_scales": {}}):
        model = get_model("unet", {**params, **variant})
        with pytest.raises(NotImplementedError):
            model.train()
        assert not model.training
        model.eval()
    with pytest.raises(NotImplementedError):
        get_model("postnet", dict(nb_classes=2, in_channels=4,
                                  dtype="bfloat16")).train()
