"""The port's EvaluationStrategy API (``rcu_tpu_torch.ops.strategy``)
against ``rcu_tpu.ops.strategy``: every class on the same dicts gives the
same results dict, keys and Python types included (``int`` counts and
``bool`` flags equal, the bins' arrays of the same dtype with equal counts
and flags); the floats within rtol 1e-5 (the port computes the ECE's bins
in float64, JAX in float32). The port takes tensors as well as numpy
arrays, with the same results; and the three ops it added
(``calibration.threshold_range_mask``, ``calibration.ece_binary``,
``metrics.accuracy``) against JAX's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcu_tpu.ops import calibration as jax_cal
from rcu_tpu.ops import metrics as jax_metrics
from rcu_tpu.ops import strategy as jst
from rcu_tpu_torch.ops import calibration as cal
from rcu_tpu_torch.ops import metrics
from rcu_tpu_torch.ops import strategy as pst


def entries(seed, shape=(24, 20)):
    rng = np.random.RandomState(seed)
    probs = rng.rand(*shape).astype(np.float32)
    return {"prediction": (rng.rand(*shape) < 0.4).astype(np.uint8),
            "target": (rng.rand(*shape) < probs).astype(np.uint8),
            "probabilities": probs,
            "probabilities_2": np.stack([1 - probs, probs], -1),
            "uncertainty": rng.rand(*shape).astype(np.float32),
            "mask": rng.rand(*shape) < 0.8,
            "target_border": (rng.rand(*shape) < 0.3).astype(np.uint8)}


def cases():
    """(id, strategy class name, constructor args, kwargs, the dict's
    renames)."""
    return [
        ("empty", "EmptyEvaluation", (), {}, {}),
        ("lambda", "LambdaEvaluation",
         (lambda p: float(np.asarray(p).min()), ("probabilities",), "min"),
         {}, {}),
        ("smooth_dice", "SmoothDice", (), {}, {}),
        ("nll", "Nll", (), {}, {"probabilities": "probabilities_2"}),
        ("nll_no_log", "Nll", (), {"do_log": False,
                                   "result_entry": "nll_raw"},
         {"probabilities": "probabilities_2"}),
        ("log_loss", "LogLoss", (), {}, {}),
        ("log_loss_2", "LogLoss", (), {}, {"probabilities":
                                           "probabilities_2"}),
        ("dice", "Dice", (), {}, {}),
        ("confusion", "ConfusionMatrix", (), {}, {}),
        ("confusion_names", "ConfusionMatrix",
         (("a", "b", "c", "d", "e"),), {}, {}),
        ("ece", "EceBinary", (), {}, {}),
        ("ece_bins", "EceBinary", (), {"return_bins": True}, {}),
        ("ece_two_class", "EceBinary", (), {"return_bins": True},
         {"probabilities": "probabilities_2"}),
        ("ece_mask_range", "EceBinary", (),
         {"with_mask": True, "threshold_range": (0.2, 0.8),
          "return_bins": True, "n_bins": 5}, {}),
        ("ece_log_weighting", "EceBinary", (),
         {"bin_weighting": "log_proportion", "result_entry": "ece_log"}, {}),
        ("error_dice", "UncertaintyErrorDice", (0.5,),
         {"result_prefix": "th05"}, {}),
        ("error_dice_border", "UncertaintyErrorDice", (0.3,),
         {"with_mask": True}, {}),
        ("error_dice_boarder", "UncertaintyErrorDice", (0.3,),
         {"with_mask": True}, {"target_boarder": "target_border"}),
        ("correction", "UncertaintyAndCorrectionEval", (0.5,), {}, {}),
    ]


def build(seed, renames):
    d = entries(seed)
    for new, old in renames.items():
        d[new] = d[old]
    if "target_boarder" in renames:
        del d["target_border"]
    return d


def assert_same_results(got, want):
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert type(g) is type(w), (key, type(g), type(w))
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            if w.dtype.kind in "biu":
                assert np.array_equal(g, w), key
            else:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                           err_msg=key)
        elif isinstance(w, float):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7,
                                       err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", cases(), ids=[c[0] for c in cases()])
def test_strategy_results_equal_jax(case, seed):
    _, name, args, kwargs, renames = case
    d = build(seed, renames)
    want, got = {"kept": 1}, {"kept": 1}
    getattr(jst, name)(*args, **kwargs)(d, want)
    getattr(pst, name)(*args, **kwargs)(d, got)
    assert_same_results(got, want)
    # the port's strategies take tensors too
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in d.items()}
    if name == "LambdaEvaluation":
        return
    from_tensors = {"kept": 1}
    getattr(pst, name)(*args, **kwargs)(tensors, from_tensors)
    assert_same_results(from_tensors, got)


def test_compose_runs_in_order():
    d = entries(3)
    want, got = {}, {}
    for module, out in ((jst, want), (pst, got)):
        module.ComposeEvaluation([
            module.ConfusionMatrix(), module.Dice(),
            module.EceBinary(return_bins=True),
            module.UncertaintyErrorDice(0.25, result_prefix="a"),
            module.LambdaEvaluation(lambda t: int(np.sum(t)), ("target",),
                                    "n_fg"),
        ])(d, out)
    assert_same_results(got, want)
    with pytest.raises(TypeError):
        pst.EvaluationStrategy()


@pytest.mark.parametrize("threshold_range", [(0.2, 0.8), (0.0, 1.0),
                                             (0.5, 0.5)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_threshold_range_and_ece_binary(threshold_range, with_mask):
    d = entries(4)
    probs, target = d["probabilities_2"], d["target"]
    mask = d["mask"] if with_mask else None
    want = np.asarray(jax_cal.threshold_range_mask(
        jnp.asarray(probs), jnp.asarray(target), threshold_range,
        None if mask is None else jnp.asarray(mask)))
    got = cal.threshold_range_mask(
        torch.from_numpy(probs), torch.from_numpy(target), threshold_range,
        None if mask is None else torch.from_numpy(mask))
    assert np.array_equal(got.numpy(), want)
    want_ece = float(jax_cal.ece_binary(
        jnp.asarray(probs), jnp.asarray(target),
        None if mask is None else jnp.asarray(mask),
        threshold_range=threshold_range))
    got_ece = float(cal.ece_binary(
        torch.from_numpy(probs), torch.from_numpy(target),
        None if mask is None else torch.from_numpy(mask),
        threshold_range=threshold_range))
    np.testing.assert_allclose(got_ece, want_ece, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("with_mask", [False, True])
def test_accuracy(with_mask):
    d = entries(5)
    mask = d["mask"] if with_mask else None
    want = float(jax_metrics.accuracy(
        jnp.asarray(d["prediction"]), jnp.asarray(d["target"]),
        None if mask is None else jnp.asarray(mask)))
    got = metrics.accuracy(torch.from_numpy(d["prediction"]),
                           torch.from_numpy(d["target"]),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and float(got) == want
