"""The port's training pieces against the JAX package on carried weights:
flax's train-mode BatchNorm, the gradients of the CE and aleatoric steps
against ``jax.grad`` of the JAX steps' own loss functions, optax's adam
and sgd on the same gradients, channel dropout's gradient, flax's
initialization and the steps' refusals (the auxiliary steps, the
train-time predicts and a 3-step trajectory:
``tests/test_torch_train_aux.py``).

The JAX loss functions are taken from the closures of the jitted steps
that ``rcu_tpu.engine.steps`` builds, so that the reference is the code the
JAX package trains with.

The gradients are held to rtol 1e-4, atol 1e-6 x the tensor's max in
float64 (both packages' steps run with float64 weights and inputs): in
float32, JAX's own gradients lie 2-7e-6 x max from its float64 ones, so
two float32 implementations cannot meet that bar with each other. In
float32 the port's gradients must lie no farther from JAX's float64
gradients than JAX's float32 ones do (plus rtol 1e-4). The conv biases
before a BatchNorm have a gradient that is zero in exact arithmetic (the
BatchNorm removes the mean); they are held below 1e-6 x their conv
kernel's gradient max."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from rcu_tpu.engine import steps as jax_steps
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.engine.state import TrainState, create_train_state
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.models.optim import SGD, Adam
from rcu_tpu_torch.models.unet import ChannelDropout, batch_norm_train
from tests.test_torch_unet import flax_unet

UNET = dict(nb_classes=2, in_channels=3, depth=2, start_filters=8,
            dropout=0.0)
HW = (16, 16)


def scaled_close(got, want, rtol, scale):
    """``|got - want| <= rtol * |want| + scale * max|want|``."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * float(np.abs(want).max()))


def jax_loss_fn(jitted_step):
    """The ``loss_fn`` that a jitted JAX train step closes over."""
    fn = jitted_step.__wrapped__
    return dict(zip(fn.__code__.co_freevars,
                    fn.__closure__))["loss_fn"].cell_contents


PRE_BN_BIAS = re.compile(r"ConvBnRelu_\d+\.Conv_0\.bias$")


def to64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64)
        if np.asarray(a).dtype == np.float32 else a, tree)


def make_batch(seed, n=4, channels=3, labels_channels=None, valid=None):
    rng = np.random.RandomState(seed)
    images = rng.randn(n, *HW, channels).astype(np.float32)
    shape = (n, *HW) + ((labels_channels,) if labels_channels else ())
    labels = (rng.rand(*shape) < 0.4).astype(np.uint8)
    valid = np.float32(valid if valid is not None else [1] * n)
    return {"images": images, "labels": labels, "valid": valid}


def torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


class GradRecorder:
    """An optimizer that records the gradients and updates nothing."""

    def init(self, params):
        return {}

    def step(self, params, state):
        self.grads = {k: p.grad.clone() for k, p in params.items()}


def port_model(model_type, params, flax_params, stats, dtype=torch.float32):
    model = get_model(model_type, params)
    model.load_state_dict(state_dict_from_flax(flax_params, stats))
    if dtype == torch.float64:
        model.double().dtype = torch.float64
    return model


def port_state(model_type, params, flax_params, stats, optimizer=None,
               dtype=torch.float32):
    model = port_model(model_type, params, flax_params, stats, dtype)
    optimizer = optimizer or GradRecorder()
    return TrainState(model, optimizer,
                      optimizer.init(dict(model.named_parameters())))


def run_both(jax_loss, jax_args, port_run):
    """The JAX loss's value_and_grad and the port's step (``port_run(dtype)``
    -> (metrics, state)), in float32 and in float64. -> {dtype: (jax (loss,
    aux, grads), port (metrics, state))}."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        args = jax_args if dtype == torch.float32 else to64(jax_args)
        with jax.enable_x64(dtype == torch.float64):
            (loss, aux), grads = jax.jit(jax.value_and_grad(
                jax_loss, has_aux=True))(*args)
            jax_out = (float(loss), jax.tree_util.tree_map(np.asarray, aux),
                       state_dict_from_flax(to64(grads), {}))
        out[dtype] = (jax_out, port_run(dtype))
    return out


def port_batch(batch, dtype):
    return torch_batch(to64(batch) if dtype == torch.float64 else batch)


def assert_steps_match(out):
    """Loss (rtol 1e-5), the gradients (see the module doc) and the
    BatchNorm running statistics (as the gradients) of :func:`run_both`."""
    (_, _, g32), (m32, s32) = out[torch.float32]
    (loss64, aux64, g64), (m64, s64) = out[torch.float64]
    np.testing.assert_allclose(float(m64["loss"]), loss64, rtol=1e-5)
    np.testing.assert_allclose(float(m32["loss"]), loss64, rtol=1e-5)
    port32, port64 = s32.optimizer.grads, s64.optimizer.grads
    assert set(port32) == set(port64) == set(g64)
    for name, want in g64.items():
        want = want.numpy()
        if PRE_BN_BIAS.search(name):
            kernel = np.abs(g64[name[:-len("bias")] + "weight"].numpy()).max()
            for got in (port32[name], port64[name]):
                assert float(got.abs().max()) <= 1e-6 * kernel, name
            continue
        scaled_close(port64[name].numpy(), want, 1e-4, 1e-6)
        reference = np.abs(g32[name].numpy() - want).max()
        excess = np.abs(port32[name].double().numpy() - want) \
            - 1e-4 * np.abs(want)
        assert excess.max() <= reference, (name, excess.max(), reference)
    stats = state_dict_from_flax({}, aux64[0])
    for model in (s32.model, s64.model):
        for name, value in model.state_dict().items():
            if "running" in name:
                scaled_close(value.double().numpy(), stats[name].numpy(),
                             1e-4, 1e-6)
    return aux64


# ----------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("padded", [False, True])
def test_train_batch_norm_matches_flax(padded):
    """Batch statistics E[x], E[x^2] - E[x]^2 and the biased variance in
    the running update; with the loader's padding (the last item repeated)
    both count the copies."""
    rng = np.random.RandomState(1)
    x = (1.5 * rng.randn(3, 8, 8, 6) + 2 * rng.randn(6)).astype(np.float32)
    if padded:
        x = np.concatenate([x, x[-1:], x[-1:]])
    scale = (rng.rand(6) + 0.5).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    stats = {"mean": rng.randn(6).astype(np.float32),
             "var": (rng.rand(6) + 0.5).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    want, mutated = bn.apply({"params": {"scale": scale, "bias": bias},
                              "batch_stats": stats}, x,
                             mutable=["batch_stats"])
    port = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        for name, value in (("weight", scale), ("bias", bias),
                            ("running_mean", stats["mean"]),
                            ("running_var", stats["var"])):
            getattr(port, name).copy_(torch.from_numpy(value))
    got = batch_norm_train(torch.from_numpy(x).permute(0, 3, 1, 2), port)
    scaled_close(got.detach().permute(0, 2, 3, 1).numpy(), want, 1e-5, 1e-5)
    scaled_close(port.running_mean.numpy(), mutated["batch_stats"]["mean"],
                 1e-6, 1e-6)
    scaled_close(port.running_var.numpy(), mutated["batch_stats"]["var"],
                 1e-6, 1e-6)
    flat = x.reshape(-1, 6)
    np.testing.assert_allclose(  # the biased variance, not torch's unbiased
        port.running_var.numpy(), 0.9 * stats["var"] + 0.1 * flat.var(0),
        rtol=1e-5)


# ----------------------------------------------------------- the steps

@pytest.mark.parametrize("valid", [[1, 1, 1, 1], [1, 1, 0, 0]])
def test_ce_step_gradients_match_jax(valid):
    fm, flax_params, stats = flax_unet(UNET, HW, seed=2)
    batch = make_batch(3, valid=valid)
    loss_fn = jax_loss_fn(jax_steps.make_train_step(fm, optax.adam(1e-3)))

    def port_run(dtype):
        state = port_state("unet", UNET, flax_params, stats, dtype=dtype)
        metrics = steps.make_train_step()(
            state, port_batch(batch, dtype), torch.Generator().manual_seed(0))
        assert state.model.training
        return metrics, state

    out = run_both(loss_fn, (flax_params, stats, batch,
                             jax.random.PRNGKey(0)), port_run)
    _, score = assert_steps_match(out)
    np.testing.assert_allclose(float(out[torch.float64][1][0]["dice"]),
                               float(score), rtol=1e-5)


@pytest.mark.parametrize("is_log_sigma", [False, True])
def test_aleatoric_step_with_injected_noise(is_log_sigma):
    params = {**UNET, "sigma_out": True}
    fm, flax_params, stats = flax_unet(params, HW, seed=4)
    batch = make_batch(5, valid=[1, 1, 1, 0])
    loss_fn = jax_loss_fn(jax_steps.make_train_step(
        fm, optax.adam(1e-3), loss_kind="aleatoric",
        is_log_sigma=is_log_sigma, nb_samples=4))
    rng = jax.random.PRNGKey(9)
    step = steps.make_train_step("aleatoric", is_log_sigma=is_log_sigma,
                                 nb_samples=4)

    # JAX draws the noise from fold_in(rng, 1) in the logits' dtype, which
    # is float32 in both runs: the class head casts its output to it
    noise = np.asarray(jax.random.normal(jax.random.fold_in(rng, 1),
                                         (4, 4, *HW, 2), jnp.float32))

    def port_run(dtype):
        state = port_state("unet", params, flax_params, stats, dtype=dtype)
        metrics = step(state, port_batch(batch, dtype),
                       torch.Generator().manual_seed(0),
                       noise=torch.from_numpy(np.moveaxis(noise, -1, 2).copy()))
        return metrics, state

    assert_steps_match(run_both(loss_fn, (flax_params, stats, batch, rng),
                                port_run))


@pytest.mark.parametrize("name,params", [("adam", {"lr": 1e-3}),
                                         ("sgd", {"lr": 1e-2}),
                                         ("sgd", {"lr": 1e-2, "momentum": 0.9})])
def test_optimizer_matches_optax_on_the_same_gradients(name, params):
    """3 updates from the same gradients: parameters rtol 1e-6; adam's
    count and moments (sgd's trace) equal."""
    _, flax_params, stats = flax_unet(UNET, HW, seed=16)
    tx = getattr(optax, name)(learning_rate=params["lr"],
                              **{k: v for k, v in params.items() if k != "lr"})

    @jax.jit
    def update(grads, opt_state, params):  # as the JAX train step applies it
        updates, opt_state = tx.update(grads, opt_state, params)
        return jax.tree_util.tree_map(lambda p, u: p + u, params, updates), \
            opt_state

    jp, opt_state = flax_params, tx.init(flax_params)
    state = port_state("unet", UNET, flax_params, stats,
                       get_optimizer(name, params))
    rng = np.random.RandomState(17)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (1e-2 * rng.randn(*a.shape)).astype(np.float32),
            flax_params)
        jp, opt_state = update(grads, opt_state, jp)
        torch_grads = state_dict_from_flax(grads, {})
        for key, p in state.model.named_parameters():
            p.grad = torch_grads[key]
        state.step()
        assert all(p.grad is None for p in state.model.parameters())
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp), {})
    for key, p in state.model.named_parameters():
        scaled_close(p.detach().numpy(), want[key].numpy(), 1e-6, 1e-7)
    got = state.optimizer.to_flax(state.opt_state, state.params)
    want = jax.tree_util.tree_map(np.asarray, opt_state[0]._asdict())
    assert jax.tree_util.tree_structure(got["0"]) == \
        jax.tree_util.tree_structure(want) and got["1"] == {}
    for a, b in zip(jax.tree_util.tree_leaves(got["0"]),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------ pieces, refusals

def test_channel_dropout_train_gradient():
    """A dropped (image, channel) gets zero gradient, a kept one 1/keep."""
    x = torch.randn(3, 8, 5, 5, requires_grad=True)
    y = ChannelDropout(0.5)(x * 1.0, [torch.Generator().manual_seed(3)])
    y.sum().backward()
    dropped = (y == 0).all(-1).all(-1)
    assert dropped.any() and (~dropped).any()
    assert torch.all(x.grad[dropped] == 0)
    assert torch.all(x.grad[~dropped] == 2.0)


@pytest.mark.parametrize("model_type,params", [
    ("unet", UNET), ("unet", {**UNET, "sigma_out": True}),
    ("postnet", dict(nb_classes=2, in_channels=8))])
def test_flax_initialization(model_type, params):
    model = create_train_state(get_model(model_type, params),
                               Adam(), 20, "cpu").model
    again = create_train_state(get_model(model_type, params),
                               Adam(), 20, "cpu").model
    for (name, value), other in zip(model.state_dict().items(),
                                    again.state_dict().values()):
        assert torch.equal(value, other), name  # seeded
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            bound = (1.0 / m.weight[0].numel()) ** 0.5
            assert torch.all(m.bias == 0), name
            assert float(m.weight.abs().max()) <= bound
            assert float(m.weight.abs().max()) > 0.5 * bound
        elif isinstance(m, torch.nn.BatchNorm2d):
            for tensor, value in ((m.weight, 1), (m.bias, 0),
                                  (m.running_mean, 0), (m.running_var, 1)):
                assert torch.all(tensor == value), name


def test_step_refusals():
    """An unknown loss kind or remat policy raises; the remat policies
    ``'conv'`` and ``'full'`` build steps (tests/test_torch_train_bf16.py
    holds them bitwise to no remat)."""
    with pytest.raises(ValueError, match="unknown loss_kind"):
        steps.make_train_step("mse")
    with pytest.raises(ValueError, match="unknown remat"):
        steps.make_train_step(remat="some")
    with pytest.raises(ValueError, match="unknown remat"):
        steps.make_auxiliary_train_step(remat="some")
    for kwargs in ({"remat": "conv"}, {"remat": "full"}):
        assert isinstance(steps.make_train_step(**kwargs), steps.TrainStep)
        assert isinstance(steps.make_auxiliary_train_step(**kwargs),
                          steps.TrainStep)


def test_get_optimizer_takes_optax_names():
    adam = get_optimizer("adam", {"lr": 1e-4, "b1": 0.8, "eps": 1e-6})
    assert (adam.lr, adam.b1, adam.b2, adam.eps, adam.eps_root) == \
        (1e-4, 0.8, 0.999, 1e-6, 0.0)
    assert get_optimizer("adam", {}).lr == 1e-3
    sgd = get_optimizer("sgd", {})
    assert isinstance(sgd, SGD) and sgd.lr == 1e-2 and sgd.momentum is None
    with pytest.raises(ValueError, match="unknown adam params"):
        get_optimizer("adam", {"lr": 1e-3, "betas": (0.9, 0.99)})
    with pytest.raises(ValueError, match="unknown optimizer"):
        get_optimizer("rmsprop", {})
