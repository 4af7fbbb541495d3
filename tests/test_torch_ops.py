"""The port's eval ops against ``rcu_tpu.ops``: bin ids identical, counts
exact, floats at rtol 1e-5, and the JAX package's inf/nan semantics."""
import numpy as np
import pytest
import torch

from rcu_tpu.ops import calibration as jax_cal
from rcu_tpu.ops import metrics as jax_metrics
from rcu_tpu.ops import uncertainty as jax_unc
from rcu_tpu_torch.ops import calibration as cal
from rcu_tpu_torch.ops import metrics
from rcu_tpu_torch.ops import uncertainty as unc

THRESHOLDS = np.asarray((0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                         0.95), np.float32)


def edge_values():
    """Every f32 bin edge 0.0, 0.1, ..., 1.0 and its two f32 neighbours."""
    edges = np.float32(np.linspace(0.0, 1.0, 11))
    return np.concatenate([edges, np.nextafter(edges, np.float32(-1)),
                           np.nextafter(edges, np.float32(2)),
                           np.float32([1e-8, 1.0 + 1e-7, -0.0])])


def probs_case(seed, shape=(3, 17, 19)):
    rng = np.random.RandomState(seed)
    probs = rng.rand(*shape).astype(np.float32)
    flat = probs.reshape(-1)
    salt = edge_values()
    flat[rng.choice(flat.size, salt.size, replace=False)] = salt
    target = rng.rand(*shape) < 0.4
    mask = rng.rand(*shape) < 0.7
    return probs, target, mask


def t(x):
    return torch.from_numpy(np.asarray(x))


def test_bin_ids_identical_at_every_edge():
    p = np.concatenate([edge_values(),
                        np.random.RandomState(0).rand(5000).astype(np.float32)])
    want = np.asarray(jax_cal.bin_ids(p))
    got = cal.bin_ids(t(p)).numpy()
    np.testing.assert_array_equal(got, want)
    digitize = np.digitize(p.astype(np.float64),
                           np.linspace(0, 1 + 1e-8, 11)) - 1
    np.testing.assert_array_equal(got, np.clip(digitize, 0, 9))


@pytest.mark.parametrize("weighting", ["proportion", "log_proportion",
                                       "power_proportion", "mean_proportion"])
@pytest.mark.parametrize("masked", [False, True])
def test_ece_binary_with_bins(weighting, masked):
    probs, target, mask = probs_case(1)
    mask = mask if masked else None
    ece_j, bins_j = jax_cal.ece_binary_with_bins(
        probs, target.astype(np.float32), mask, bin_weighting=weighting)
    ece_t, bins_t = cal.ece_binary_with_bins(
        t(probs), t(target), None if mask is None else t(mask),
        bin_weighting=weighting)
    np.testing.assert_array_equal(bins_t["bins_count"].numpy(),
                                  np.asarray(bins_j["bins_count"]).astype(np.int64))
    np.testing.assert_array_equal(bins_t["bins_non_zero"].numpy(),
                                  np.asarray(bins_j["bins_non_zero"]))
    for key in ("bins_avg_confidence", "bins_positive_fraction"):
        np.testing.assert_allclose(bins_t[key].numpy(), np.asarray(bins_j[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(float(ece_t), float(ece_j), rtol=1e-5, atol=1e-7)


def test_two_class_probabilities_use_the_foreground_column():
    probs, target, _ = probs_case(2)
    two = np.stack([1 - probs, probs], -1)
    ece_a, _ = cal.ece_binary_with_bins(t(two), t(target))
    ece_b, _ = cal.ece_binary_with_bins(t(probs), t(target))
    assert float(ece_a) == float(ece_b)


def test_all_masked_out_ece_is_nan():
    probs, target, _ = probs_case(3)
    none = np.zeros(probs.shape, bool)
    ece_j, _ = jax_cal.ece_binary_with_bins(probs, target.astype(np.float32), none)
    ece_t, bins = cal.ece_binary_with_bins(t(probs), t(target), t(none))
    assert np.isnan(float(ece_j)) and np.isnan(float(ece_t))
    assert int(bins["bins_count"].sum()) == 0


@pytest.mark.parametrize("masked", [False, True])
def test_confusion_counts_exact(masked):
    probs, target, mask = probs_case(4)
    prediction = probs > 0.5
    mask = mask if masked else None
    want = jax_metrics.confusion_counts(prediction, target, mask)
    got = metrics.confusion_counts(t(prediction), t(target),
                                   None if mask is None else t(mask))
    assert [int(g) for g in got] == [int(w) for w in want]


def test_dice_of_nothing_is_nan():
    zero = torch.tensor(0, dtype=torch.int64)
    assert torch.isnan(metrics.dice_from_counts(zero, zero, zero))
    f0 = np.float32(0.0)
    with np.errstate(invalid="ignore"):
        assert np.isnan(float(jax_metrics.dice_from_counts(f0, f0, f0)))


def test_entropy_matches_with_zero_probabilities():
    rng = np.random.RandomState(5)
    p = rng.rand(4, 9, 2).astype(np.float32)
    p[0, :3] = [0.0, 1.0]
    p /= p.sum(-1, keepdims=True)
    want = np.asarray(jax_metrics.entropy(p, axis=-1))
    got = metrics.entropy(t(p), dim=-1).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def correction_case(seed):
    probs, target, _ = probs_case(seed)
    prediction = probs > 0.5
    rng = np.random.RandomState(seed + 100)
    u = rng.rand(*probs.shape).astype(np.float32)
    flat = u.reshape(-1)
    flat[rng.choice(flat.size, 40, replace=False)] = rng.choice(THRESHOLDS, 40)
    return prediction, target, u


def assert_correction_equal(got, want):
    for key, value in want.items():
        value = np.asarray(value)
        have = np.asarray(got[key])
        if value.dtype == np.bool_:
            np.testing.assert_array_equal(have, value, err_msg=key)
        elif key in ("tp", "tn", "fp", "fn", "tpu", "tnu", "fpu", "fnu"):
            np.testing.assert_array_equal(have.astype(np.int64),
                                          value.astype(np.int64), err_msg=key)
        else:
            np.testing.assert_allclose(have, value, rtol=1e-5, atol=1e-7,
                                       err_msg=key)  # NaN == NaN here


@pytest.mark.parametrize("seed", range(4))
def test_correction_eval_matches(seed):
    prediction, target, u = correction_case(seed)
    want = jax_unc.correction_eval(prediction, target, u, THRESHOLDS)
    got = unc.correction_eval(t(prediction), t(target), t(u), THRESHOLDS)
    assert_correction_equal({k: v.numpy() for k, v in got.items()}, want)


def test_correction_inf_nan_semantics():
    """prediction == target: fp = fpu = 0, so tpu/fpu is inf or nan; an
    empty volume gives dice 0/0 = NaN."""
    _, target, u = correction_case(7)
    for prediction, tgt in ((target, target),
                            (np.zeros_like(target), np.zeros_like(target))):
        want = jax_unc.correction_eval(prediction, tgt, u, THRESHOLDS)
        got = unc.correction_eval(t(prediction), t(tgt), t(u), THRESHOLDS)
        assert_correction_equal({k: v.numpy() for k, v in got.items()}, want)
    assert np.isnan(got["dice"].numpy()).all()


def test_uncertainty_counts_with_mask():
    prediction, target, u = correction_case(8)
    mask = np.random.RandomState(8).rand(*u.shape) < 0.6
    want = jax_unc.uncertainty_counts(prediction, target, u > 0.5, mask)
    got = unc.uncertainty_counts(t(prediction), t(target), t(u > 0.5), t(mask))
    assert [int(g) for g in got] == [int(w) for w in want]
