"""The port's training losses, the train step's valid-masked reductions and
the validation metrics against the JAX package, on the same numpy inputs
(class axis last in JAX, 1 in the port)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rcu_tpu.engine import steps as jax_steps
from rcu_tpu.ops import losses as jax_losses
from rcu_tpu.ops import metrics as jax_metrics
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.ops import losses, metrics


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.fixture
def batch():
    rng = np.random.RandomState(3)
    logits = (2 * rng.randn(3, 8, 8, 2)).astype(np.float32)
    sigma = (0.5 * rng.rand(3, 8, 8, 2) + 0.1).astype(np.float32)
    target = (rng.rand(3, 8, 8) < 0.4).astype(np.int32)
    return logits, sigma, target


def test_ce_log_probs_and_cross_entropy(batch):
    logits, _, target = batch
    want = np.asarray(jax_losses.ce_log_probs(logits, target))
    got = losses.ce_log_probs(nchw(logits), torch.from_numpy(target)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(losses.cross_entropy(nchw(logits), torch.from_numpy(target))),
        float(jax_losses.cross_entropy(logits, target)), rtol=1e-6)


@pytest.mark.parametrize("is_log_sigma", [False, True])
def test_aleatoric_log_probs_with_jax_noise(batch, is_log_sigma):
    """JAX's draws (``normal(rng, (T,) + logits.shape)``) passed in as the
    port's noise give the same per-pixel log probabilities."""
    logits, sigma, target = batch
    if is_log_sigma:
        sigma = np.log(sigma)
    rng = jax.random.PRNGKey(7)
    want = np.asarray(jax_losses.aleatoric_log_probs(
        rng, logits, sigma, target, is_log_sigma, nb_samples=5))
    noise = np.asarray(jax.random.normal(rng, (5,) + logits.shape,
                                         jnp.float32))
    got = losses.aleatoric_log_probs(
        nchw(logits), nchw(sigma), torch.from_numpy(target), is_log_sigma,
        nb_samples=5, noise=torch.from_numpy(np.moveaxis(noise, -1, 2).copy()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    mean = -float(losses.aleatoric_loss(
        nchw(logits), nchw(sigma), torch.from_numpy(target), is_log_sigma,
        nb_samples=5, noise=torch.from_numpy(np.moveaxis(noise, -1, 2).copy())))
    np.testing.assert_allclose(mean, float(np.mean(want)), rtol=1e-6)


def test_aleatoric_noise_from_the_generator(batch):
    logits, sigma, target = batch
    args = (nchw(logits), nchw(sigma), torch.from_numpy(target), False, 4)
    a = losses.aleatoric_log_probs(*args, torch.Generator().manual_seed(1))
    b = losses.aleatoric_log_probs(*args, torch.Generator().manual_seed(1))
    c = losses.aleatoric_log_probs(*args, torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    noise = losses.aleatoric_noise(4, args[0], torch.Generator().manual_seed(1))
    assert torch.equal(losses.aleatoric_log_probs(*args, noise=noise), a)


def test_masked_mean_ignores_padded_items(batch):
    logits, _, target = batch
    per_px = np.array(jax_losses.ce_log_probs(logits, target))
    valid = np.float32([1, 1, 0])
    want = float(jax_steps._masked_mean(per_px, valid))
    got = float(steps._masked_mean(torch.from_numpy(per_px),
                                   torch.from_numpy(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, per_px[:2].mean(), rtol=1e-6)
    np.testing.assert_allclose(
        float(steps._masked_ce(nchw(logits), torch.from_numpy(target),
                               torch.from_numpy(valid))),
        float(jax_steps._masked_ce(logits, target, valid)), rtol=1e-6)


def test_batch_smooth_dice(batch):
    logits, _, target = batch
    valid = np.float32([1, 0, 1])
    want = float(jax_steps._batch_smooth_dice(logits, target, valid))
    got = float(steps._batch_smooth_dice(nchw(logits), torch.from_numpy(target),
                                         torch.from_numpy(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("empty", [False, True])
def test_validation_metrics_match_jax(empty):
    rng = np.random.RandomState(11)
    probs = rng.rand(4, 8, 8, 2).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    target = (rng.rand(4, 8, 8) < 0.3).astype(np.uint8)
    prediction = probs.argmax(-1)
    if empty:  # 0/0 dice is NaN in both
        prediction = target = np.zeros_like(target)
    for name in ("dice", "smooth_dice"):
        want = float(getattr(jax_metrics, name)(prediction, target))
        np.testing.assert_allclose(getattr(metrics, name)(prediction, target),
                                   want, rtol=1e-6, equal_nan=True)
    np.testing.assert_allclose(metrics.nll(probs, target),
                               float(jax_metrics.nll(probs, target)), rtol=1e-6)
    for p in (probs.reshape(-1, 2), probs[..., 1]):  # classes or foreground
        np.testing.assert_allclose(metrics.log_loss(p, target),
                                   float(jax_metrics.log_loss(p, target)),
                                   rtol=1e-6)
    with pytest.raises(ValueError, match="shapes disagree"):
        metrics.log_loss(probs.reshape(-1, 2)[:-3], target)
