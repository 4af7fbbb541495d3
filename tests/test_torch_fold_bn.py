"""The load-time BatchNorm fold of the port against the JAX package's
(``rcu_tpu.models.fold_bn_params``, ``fold_bn=True``): the folded arrays,
the folded models in f32 and bf16, the guards, the precast of a folded
model and the weights bridge back to a flax tree (the direct eval end to
end in bf16 with the fast decoder and the fold is
``tests/test_torch_fold_bn_e2e.py`` and ``tests/test_torch_fold_bn_ensemble.py``).

The fold is f32 algebra done once on the host, so the folded f32 model is
the same function as the unfolded one, held to the JAX package's bar
(``tests/test_fold_bn.py``: rtol 2e-4, atol 2e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcu_tpu.models import fold_bn_params as jax_fold_bn_params
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval.pipeline import sample_generators
from rcu_tpu_torch.models import FAST_DECODER_KWARGS, fold_bn_params
from rcu_tpu_torch.models.convert import (flax_from_state_dict,
                                          state_dict_from_flax)
from rcu_tpu_torch.models.unet import bias_terms
from tests.test_torch_unet import flax_net
from tests.test_torch_variants import (BAR, F32_ATOL, bf16_bar, flax_out,
                                       leaf_dtypes, port_net, port_out,
                                       roundings)

FOLD_BAR = dict(rtol=2e-4, atol=2e-5)  # tests/test_fold_bn.py:89-94
SIGMA_UNET = dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
                  dropout=0.2, sigma_out=True)
POSTNET = dict(nb_classes=2, in_channels=4, dropout=0.1)
NETS = [("unet", SIGMA_UNET, (16, 20)),
        ("unet", {**SIGMA_UNET, "depth": 3, **FAST_DECODER_KWARGS}, (45, 53)),
        ("postnet", POSTNET, (16, 20))]


def leaves(tree, prefix=""):
    out = {}
    for key, sub in dict(tree).items():
        if isinstance(sub, dict) or hasattr(sub, "items"):
            out.update(leaves(sub, f"{prefix}/{key}"))
        else:
            out[f"{prefix}/{key}"] = np.asarray(sub)
    return out


def inputs(model_type, params, hw, seed=9):
    rng = np.random.RandomState(seed)
    x = rng.rand(2, *hw, params["in_channels"]).astype(np.float32)
    return x + 0.5 if model_type == "postnet" else x


@pytest.mark.parametrize("model_type,params,hw", NETS)
def test_folded_arrays_equal_jax(model_type, params, hw):
    _, flax_params, stats = flax_net(model_type, params, hw, seed=2)
    got_p, got_s = fold_bn_params(flax_params, stats)
    want_p, want_s = jax_fold_bn_params(flax_params, stats)
    assert got_s == {} and dict(want_s) == {}
    got, want = leaves(got_p), leaves(want_p)
    assert got.keys() == want.keys()
    assert not any("BatchNorm" in path for path in got)
    for path, value in want.items():
        assert got[path].dtype == np.float32, path
        assert np.array_equal(got[path], value), path


@pytest.mark.parametrize("model_type,params,hw", NETS)
def test_folded_f32_model_is_the_same_function(model_type, params, hw):
    """Folded against unfolded in the port at the fold's bar, and against
    flax's folded model at the f32 bar; the folded model loads strict with
    no BatchNorm."""
    _, flax_params, stats = flax_net(model_type, params, hw, seed=2)
    x = inputs(model_type, params, hw)
    folded_p, folded_s = fold_bn_params(flax_params, stats)
    folded = port_net(model_type, {**params, "fold_bn": True}, folded_p,
                      folded_s)
    assert not any("BatchNorm" in k for k in folded.state_dict())
    got = port_out(folded, x)
    unfolded = port_out(port_net(model_type, params, flax_params, stats), x)
    want = flax_out(model_type, {**params, "fold_bn": True}, folded_p,
                    folded_s, x)
    assert got.keys() == unfolded.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], unfolded[key], **FOLD_BAR)
        np.testing.assert_allclose(got[key], want[key], **BAR)


@pytest.mark.parametrize("model_type,params,hw", NETS)
def test_folded_bf16_matches_flax_bf16(model_type, params, hw):
    """bf16 with the fold's compensated bias: port against flax within
    ``bf16_bar``, each within 0.15 of the unfolded f32 forward; the f32
    heads keep their folded f32 weights."""
    _, flax_params, stats = flax_net(model_type, params, hw, seed=2)
    x = inputs(model_type, params, hw)
    folded_p, folded_s = fold_bn_params(flax_params, stats)
    bf16 = {**params, "fold_bn": True, "dtype": "bfloat16"}
    model = port_net(model_type, bf16, folded_p, folded_s)
    got = port_out(model, x)
    want = flax_out(model_type, bf16, folded_p, folded_s, x)
    want32 = flax_out(model_type, params, flax_params, stats, x)
    n = roundings(None, nb_convs=3) if model_type == "postnet" else \
        roundings(params["depth"], params.get("split_decoder_concat", False))
    for key in want:
        scale = np.abs(want32[key]).max()
        assert np.abs(got[key] - want[key]).max() <= bf16_bar(n, scale), key
        assert np.abs(got[key] - want32[key]).max() <= F32_ATOL, key
        assert np.abs(want[key] - want32[key]).max() <= F32_ATOL, key
    dtypes = leaf_dtypes(model)
    assert all(dt == torch.float32 for k, dt in dtypes.items()
               if k.endswith("bias")), "a folded model keeps its biases f32"
    assert any(dt == torch.bfloat16 for dt in dtypes.values())


def test_folded_bias_terms_are_jax_s():
    """hi and lo are the two terms of the JAX package's
    ``_compensated_bias_add``; together
    they carry the f32 bias that hi alone rounds away."""
    bias = (np.random.RandomState(0).randn(64) * 3).astype(np.float32)
    hi, lo = bias_terms(torch.from_numpy(bias), torch.bfloat16)
    jax_hi = jnp.asarray(bias).astype(jnp.bfloat16)
    jax_lo = (jnp.asarray(bias) - jax_hi.astype(jnp.float32)) \
        .astype(jnp.bfloat16)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert np.array_equal(hi.float().numpy(), np.asarray(jax_hi, np.float32))
    assert np.array_equal(lo.float().numpy(), np.asarray(jax_lo, np.float32))
    two = np.abs(hi.double().numpy() + lo.double().numpy() - bias)
    one = np.abs(hi.double().numpy() - bias)
    assert (two <= one).all() and two.max() < one.max() / 64


@pytest.mark.parametrize("model_type,params,hw", NETS)
def test_folded_model_refuses_dropout(model_type, params, hw):
    _, flax_params, stats = flax_net(model_type, params, hw, seed=2)
    model = port_net(model_type, {**params, "fold_bn": True},
                     *fold_bn_params(flax_params, stats))
    x = torch.zeros(1, params["in_channels"], *hw)
    gens = sample_generators((0, 0), 0, 2, "cpu")
    with pytest.raises(ValueError, match="deterministic-inference"):
        model(x.repeat(2, 1, 1, 1), gens)
    if model_type == "unet":
        with pytest.raises(ValueError, match="deterministic-inference"):
            steps.mc_forward(model, x.permute(0, 2, 3, 1), gens)
    model(x)  # the deterministic forward runs


@pytest.mark.parametrize("model_type,params,hw", NETS)
def test_flax_tree_round_trip(model_type, params, hw):
    """``flax_from_state_dict`` inverts ``state_dict_from_flax`` exactly,
    folded or not."""
    _, flax_params, stats = flax_net(model_type, params, hw, seed=4)
    for tree in ((flax_params, stats), fold_bn_params(flax_params, stats)):
        state = state_dict_from_flax(*tree)
        back = flax_from_state_dict(state)
        for want, got in zip(tree, back):
            want, got = leaves(want), leaves(got)
            assert want.keys() == got.keys()
            for path, value in want.items():
                assert np.array_equal(got[path], value), path
        again = state_dict_from_flax(*back)
        assert all(torch.equal(again[k], v) for k, v in state.items())
