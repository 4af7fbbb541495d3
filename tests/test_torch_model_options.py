"""The U-Net options ``residual`` and ``bn`` against the JAX package's, on
carried weights: residual blocks (the 1x1 ``Conv_0`` beside the stacked
convs, the last without its relu; over a split pair on the fast decoder)
and BatchNorm-free ConvBnRelus, in float32 (rtol 1e-3, atol 2e-4, the bar
of tests/test_model_weight_parity.py), with the fast decoder and the BN
fold (a no-op for ``bn=False``); and the refusals: int8 with
``residual``, and a PostNet that names either key. bf16 and training:
``tests/test_torch_model_options_train.py``."""
import jax
import numpy as np
import pytest
import torch

from rcu_tpu.models import fold_bn_params as jax_fold_bn_params
from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu_torch.eval.direct import model_from_flax
from rcu_tpu_torch.models import FAST_DECODER_KWARGS, get_model
from rcu_tpu_torch.models.convert import fold_bn_params, state_dict_from_flax
from tests.test_torch_unet import _randomize_stats

BAR = dict(rtol=1e-3, atol=2e-4)
HW = (16, 16)
OPTIONS = [{"residual": True}, {"bn": False},
           {"residual": True, "bn": False}]
IDS = ["residual", "bn_free", "residual_bn_free"]


def flax_variables(params: dict, hw, seed: int):
    """A flax U-Net's perturbed init weights and random BatchNorm
    statistics (none without BatchNorm), numpy leaves."""
    model = flax_get_model("unet", params)
    x0 = np.zeros((1, *hw, params["in_channels"]), np.float32)
    variables = model.init({"params": jax.random.PRNGKey(seed)}, x0,
                           train=False)
    rng = np.random.RandomState(seed)
    flax_params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
        variables["params"])
    stats = _randomize_stats(jax.tree_util.tree_map(
        np.asarray, variables.get("batch_stats", {})), rng)
    return flax_params, stats


def flax_logits(params, flax_params, stats, x):
    return np.asarray(flax_get_model("unet", params).apply(
        {"params": flax_params, "batch_stats": stats}, x).logits, np.float32)


def port_logits(model, x, channels_last=False):
    images = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last if channels_last
        else torch.contiguous_format)
    with torch.no_grad():
        return model(images).logits.permute(0, 2, 3, 1).numpy()


def roundings(depth, options, split=False):
    """bf16 roundings from the input to the logits: the input cast, each
    ConvBnRelu's conv (and BatchNorm) output, each up-conv and split add,
    each residual block's 1x1 conv and add (and split add), the class
    conv."""
    sites = 4 * depth + 3
    n = 1 + sites * (2 if options.get("bn", True) else 1) \
        + depth * (2 if split else 1) + 1
    if options.get("residual"):
        n += 2 * (2 * depth + 1) + (depth if split else 0)
    return n


def base(depth=2, start=4, **options):
    return dict(nb_classes=2, in_channels=3, depth=depth, start_filters=start,
                dropout=0.2, **options)


# ------------------------------------------------------------- forwards

@pytest.mark.parametrize("options", OPTIONS, ids=IDS)
@pytest.mark.parametrize("depth,start,hw", [(2, 8, (32, 32)),
                                            (3, 4, (45, 53))])
def test_f32_logits_match_flax(options, depth, start, hw):
    params = base(depth, start, **options)
    flax_params, stats = flax_variables(params, hw, seed=depth)
    model = get_model("unet", params)
    model.load_state_dict(state_dict_from_flax(flax_params, stats))
    if options.get("residual"):
        assert model.residual and hasattr(model, "ConvResidualBlock_0")
        assert not model.ConvResidualBlock_0.layers[-1].activation
    if not options.get("bn", True):
        assert not any("BatchNorm" in k for k in model.state_dict())
    x = np.random.RandomState(5).rand(2, *hw, 3).astype(np.float32)
    want = flax_logits(params, flax_params, stats, x)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(port_logits(model, x), want, **BAR)


@pytest.mark.parametrize("options", OPTIONS, ids=IDS)
@pytest.mark.parametrize("variant", ["fast", "fold", "fast_fold"])
def test_f32_variants_match_flax(options, variant):
    """The fast decoder (the residual 1x1 over the split pair too) and the
    BN fold, loaded as the direct eval loads them (``model_from_flax``),
    against flax's model of the same flags."""
    params = base(3, 4, **options)
    hw = (24, 20)
    flax_params, stats = flax_variables(params, hw, seed=7)
    flags = {"fast": FAST_DECODER_KWARGS, "fold": {"fold_bn": True},
             "fast_fold": {**FAST_DECODER_KWARGS, "fold_bn": True}}[variant]
    jp, js = flax_params, stats
    if "fold_bn" in flags:
        jp, js = jax_fold_bn_params(flax_params, stats)
        jp = jax.tree_util.tree_map(np.asarray, jp)
    x = np.random.RandomState(6).rand(2, *hw, 3).astype(np.float32)
    want = flax_logits({**params, **flags}, jp, js, x)
    model = model_from_flax("unet", params, flax_params, stats, "cpu",
                            fast_decoder="split_decoder_concat" in flags,
                            fold_bn="fold_bn" in flags)
    np.testing.assert_allclose(port_logits(model, x), want, **BAR)


@pytest.mark.parametrize("options", OPTIONS, ids=IDS)
def test_fold_bn_params(options):
    """The port's numpy fold equals the JAX package's leaf for leaf; it
    passes the residual 1x1s through and is a no-op without BatchNorm."""
    params = base(2, 4, **options)
    flax_params, stats = flax_variables(params, HW, seed=3)
    got = fold_bn_params(flax_params, stats)
    want = jax.tree_util.tree_map(np.asarray,
                                  jax_fold_bn_params(flax_params, stats))
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    if not options.get("bn", True):
        for a, b in zip(jax.tree_util.tree_leaves(got[0]),
                        jax.tree_util.tree_leaves(flax_params)):
            assert np.array_equal(a, b)
    if options.get("residual"):
        assert np.array_equal(got[0]["ConvResidualBlock_0"]["Conv_0"]["kernel"],
                              flax_params["ConvResidualBlock_0"]["Conv_0"]
                              ["kernel"])


# ------------------------------------------------------------ refusals

def test_residual_int8_raises_the_jax_text():
    params = base(2, 4, residual=True)
    with pytest.raises(NotImplementedError,
                       match="int8 quantization does not cover residual=True"):
        get_model("unet", {**params, "quant_scales": {}})
    model = get_model("unet", params)
    with pytest.raises(NotImplementedError, match="1x1 residual convs"):
        model.quantize({})
    with pytest.raises(NotImplementedError):
        flax_get_model("unet", {**params, "quant_scales": {}}).init(
            jax.random.PRNGKey(0), np.zeros((1, 8, 8, 3), np.float32))


@pytest.mark.parametrize("key,value", [("residual", True), ("residual", False),
                                       ("bn", False), ("bn", True)])
def test_postnet_refuses_unet_keys(key, value):
    """The JAX package's PostNet has neither field; the port's registry
    names the key."""
    with pytest.raises(ValueError, match=f'unknown postnet param "{key}"'):
        get_model("postnet", dict(nb_classes=2, in_channels=4, **{key: value}))
