"""The port's fused eval statistics against the JAX package: the Pallas
kernel (interpret mode, as tests/test_pallas.py runs it) and the lax path.

Bars: counts exact; bin mean confidence and ECE at rtol 1e-4 / atol 1e-6
(the JAX kernel sums in float32); correction floats at rtol 1e-5. The CUDA
kernel against this plain path is tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from rcu_tpu.eval import kernels as lax_kernels
from rcu_tpu.ops.pallas import evalstats as jax_evalstats
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_cuda import EDGES, THRESHOLDS, make_subject, port_inputs

COUNT_KEYS = ("tpu", "tnu", "fpu", "fnu", "tp", "tn", "fp", "fn")


def jax_pallas(fg, target, prediction, unc, mask):
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    return jax_evalstats.fused_subject_eval(
        f32(fg), f32(target), f32(prediction), f32(unc),
        None if mask is None else f32(mask), THRESHOLDS, interpret=True)


def assert_bins_close(bins, want_bins):
    np.testing.assert_array_equal(
        bins["bins_count"].numpy(),
        np.asarray(want_bins["bins_count"]).astype(np.int64))
    np.testing.assert_array_equal(bins["bins_non_zero"].numpy(),
                                  np.asarray(want_bins["bins_non_zero"]))
    for key in ("bins_avg_confidence", "bins_positive_fraction"):
        np.testing.assert_allclose(bins[key].numpy(), np.asarray(want_bins[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(bins["ece"]), float(want_bins["ece"]),
                               rtol=1e-4, atol=1e-6)


def assert_correction_close(correction, want):
    for key in want:
        got = correction[key].numpy()
        ref = np.asarray(want[key])
        if key in COUNT_KEYS:
            np.testing.assert_array_equal(got.astype(np.int64),
                                          ref.astype(np.int64), err_msg=key)
        elif ref.dtype == np.bool_:
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                       err_msg=key)


@pytest.mark.parametrize("shape,masked", [((5, 41, 39), True),
                                          ((5, 41, 39), False),
                                          ((3, 17, 19), True)])
def test_reference_sums_match_pallas(shape, masked):
    fg, target, prediction, unc, mask = make_subject(1, shape, masked)
    weight = mask if masked else np.ones(shape, bool)
    f32 = lambda x: jnp.asarray(x, jnp.float32)  # noqa: E731
    want = jax_evalstats.fused_eval_stats(
        f32(fg), f32(target), f32(prediction), f32(unc), f32(weight),
        THRESHOLDS, interpret=True)
    got = evalstats.fused_eval_stats_reference(
        *port_inputs(fg, target, prediction, unc, weight)[:4],
        torch.from_numpy(weight.astype(np.uint8)), THRESHOLDS)
    for key in ("bins_count", "bins_true_sum", "thresh_counts"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]).astype(np.int64),
                                      err_msg=key)
    for key in ("tp", "tn", "fp", "fn"):
        assert int(got[key]) == int(want[key]), key
    np.testing.assert_allclose(got["bins_conf_sum"].numpy(),
                               np.asarray(want["bins_conf_sum"]), rtol=1e-4)


@pytest.mark.parametrize("masked", [True, False])
def test_subject_eval_matches_pallas_and_lax(masked):
    fg, target, prediction, unc, mask = make_subject(2, (5, 41, 39), masked)
    bins, confusion, correction = evalstats.fused_subject_eval(
        *port_inputs(fg, target, prediction, unc, mask), THRESHOLDS)
    want_bins, want_conf, want_corr = jax_pallas(fg, target, prediction, unc,
                                                 mask)
    assert_bins_close(bins, want_bins)
    for key in ("tp", "tn", "fp", "fn", "n"):
        assert int(confusion[key]) == int(want_conf[key]), key
    np.testing.assert_allclose(float(confusion["dice"]),
                               float(want_conf["dice"]), rtol=1e-5)
    assert_correction_close(correction, want_corr)

    lax_bins = lax_kernels.calibration_bins(
        jnp.asarray(fg), jnp.asarray(target, jnp.float32),
        jnp.asarray(prediction), None if mask is None else jnp.asarray(mask))
    assert_bins_close(bins, lax_bins)
    lax_corr = lax_kernels.correction_eval(
        jnp.asarray(prediction), jnp.asarray(target), jnp.asarray(unc),
        jnp.asarray(THRESHOLDS, jnp.float32))
    assert_correction_close(correction, lax_corr)


def test_all_masked_out_gives_nan_ece():
    fg, target, prediction, unc, _ = make_subject(3, (2, 9, 11))
    mask = np.zeros(fg.shape, bool)
    bins, confusion, _ = evalstats.fused_subject_eval(
        *port_inputs(fg, target, prediction, unc, mask), THRESHOLDS)
    want_bins, _, _ = jax_pallas(fg, target, prediction, unc, mask)
    assert np.isnan(float(bins["ece"])) and np.isnan(float(want_bins["ece"]))
    assert int(bins["bins_count"].sum()) == 0
    assert int(confusion["n"]) == fg.size  # the mask reaches the bins only


def test_cpu_tensors_take_the_plain_version():
    inputs = port_inputs(*make_subject(4, (2, 5, 7)))
    launches, plain = evalstats.fused_eval_stats.launches, \
        evalstats.fused_eval_stats.plain_calls
    evalstats.fused_subject_eval(*inputs, THRESHOLDS)
    assert evalstats.fused_eval_stats.plain_calls == plain + 1
    assert evalstats.fused_eval_stats.launches == launches
    with pytest.raises(ValueError, match="at most 23"):
        evalstats.fused_eval_stats(*inputs[:4], inputs[1], (0.5,) * 24)


SHAPES = [(1, 1, 7), (2, 13, 11), (4, 16, 16)]


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(st.integers(0, len(SHAPES) - 1), st.integers(0, 2 ** 31 - 1),
       st.booleans(), st.floats(0.0, 1.0), st.floats(0.0, 1.0))
def test_fuzz_against_lax(shape_index, seed, masked, target_rate, edge_rate):
    """Random contents at a few fixed shapes (the jitted lax path compiles
    once per shape): bin-edge salting, any target rate, mask or none."""
    shape = SHAPES[shape_index]
    rng = np.random.RandomState(seed)
    fg = rng.rand(*shape).astype(np.float32)
    salted = rng.rand(*shape) < edge_rate
    fg[salted] = rng.choice(EDGES, int(salted.sum()))
    target = rng.rand(*shape) < target_rate
    prediction = fg > 0.5
    unc = rng.rand(*shape).astype(np.float32)
    salted = rng.rand(*shape) < edge_rate
    unc[salted] = rng.choice(np.float32(THRESHOLDS), int(salted.sum()))
    mask = rng.rand(*shape) < 0.7 if masked else None
    bins, confusion, correction = evalstats.fused_subject_eval(
        *port_inputs(fg, target, prediction, unc, mask), THRESHOLDS)
    lax_bins = lax_kernels.calibration_bins(
        jnp.asarray(fg), jnp.asarray(target, jnp.float32),
        jnp.asarray(prediction), None if mask is None else jnp.asarray(mask))
    if np.isnan(float(lax_bins["ece"])):
        assert np.isnan(float(bins["ece"]))
        assert int(bins["bins_count"].sum()) == 0
    else:
        assert_bins_close(bins, lax_bins)
    assert_correction_close(correction, lax_kernels.correction_eval(
        jnp.asarray(prediction), jnp.asarray(target), jnp.asarray(unc),
        jnp.asarray(THRESHOLDS, jnp.float32)))
    p, t = prediction, target
    assert int(confusion["tn"]) == int(np.sum(~p & ~t))
