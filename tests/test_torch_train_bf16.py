"""bf16 training and the remat policies of the port's train steps.

bf16 (flax's mixed precision, ``tests/test_mixed_precision.py``): the
parameters, their gradients and the BatchNorm statistics stay float32, the
convs and dropout run in bf16, the logits are float32. A bf16 step is held
against the JAX package's bf16 step on the same weights and batch: the
loss within one bf16 step (2^-8 relative) of JAX's, and each gradient
tensor within 4x the distance of JAX's own bf16 gradient from its f32 one
(the size of bf16's rounding noise on that tensor; on these weights the
port reads up to 2.7x), with a floor of one bf16 step of the tensor's max
where JAX's bf16 and f32 happen to agree.

Remat (``engine.remat``): ``'conv'`` and ``'full'`` recompute in the
backward pass with the forward's dropout masks and BatchNorm sums
replayed, so that on the CPU a step is bitwise the step without remat:
the loss, every gradient, the updated parameters and the BatchNorm
running statistics, with dropout active, on one device and on a 2-entry
CPU mesh (whose BatchNorm sums over the parts are replayed, not made
again)."""
import copy

import jax
import numpy as np
import optax
import pytest
import torch

from rcu_tpu.engine import steps as jax_steps
from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu_torch.engine import remat, steps
from rcu_tpu_torch.engine.state import TrainState
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.models.optim import SGD
from rcu_tpu_torch.parallel import Mesh
from tests.test_torch_model_options import flax_variables
from tests.test_torch_train_step import (jax_loss_fn, make_batch, port_state,
                                         torch_batch)

HW = (16, 16)
BF16_STEP = 2.0 ** -8
GRAD_NOISE_FACTOR = 4.0
UNET = dict(nb_classes=2, in_channels=3, depth=2, start_filters=8,
            dropout=0.0)


def jax_value_and_grad(params, flax_params, stats, batch):
    loss_fn = jax_loss_fn(jax_steps.make_train_step(
        flax_get_model("unet", params), optax.adam(1e-3)))
    (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        flax_params, stats, batch, jax.random.PRNGKey(0))
    return float(loss), state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, grads), {})


@pytest.mark.parametrize("options", [{}, {"residual": True}, {"bn": False}],
                         ids=["plain", "residual", "bn_free"])
def test_bf16_step_matches_jax_bf16_step(options):
    f32 = {**UNET, **options}
    bf16 = {**f32, "dtype": "bfloat16"}
    flax_params, stats = flax_variables(f32, HW, seed=2)
    batch = make_batch(3, valid=[1, 1, 1, 0])
    loss32, grads32 = jax_value_and_grad(f32, flax_params, stats, batch)
    loss16, grads16 = jax_value_and_grad(bf16, flax_params, stats, batch)
    state = port_state("unet", bf16, flax_params, stats)
    metrics = steps.make_train_step()(state, torch_batch(batch),
                                      torch.Generator().manual_seed(0))
    assert state.model.training and state.model.dtype == torch.bfloat16
    assert metrics["loss"].dtype == torch.float32
    assert abs(float(metrics["loss"]) - loss16) <= BF16_STEP * abs(loss16)
    got = state.optimizer.grads
    assert set(got) == set(grads16)
    for name, want in grads16.items():
        assert got[name].dtype == torch.float32, name
        want = want.numpy()
        noise = np.abs(grads32[name].numpy() - want).max()
        bar = max(GRAD_NOISE_FACTOR * noise,
                  BF16_STEP * np.abs(want).max())
        err = np.abs(got[name].numpy() - want).max()
        assert err <= bar, (name, err, bar)
    for name, value in state.model.state_dict().items():
        if value.is_floating_point():
            assert value.dtype == torch.float32, name


@pytest.mark.parametrize("model_type", ["unet", "postnet"])
def test_bf16_training_learns_with_f32_parameters(model_type):
    """15 adam steps of a bf16 model (dropout on): the parameters, the
    BatchNorm statistics and the optimizer's moments stay float32, and the
    loss falls (``tests/test_mixed_precision.py``'s test of the JAX
    package)."""
    from rcu_tpu_torch.engine.state import create_train_state
    if model_type == "unet":
        record = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4,
                      dropout=0.1, dtype="bfloat16")
    else:
        record = dict(nb_classes=2, in_channels=2, nb_convs=2, dropout=0.1,
                      dtype="bfloat16")
    state = create_train_state(get_model(model_type, record),
                               get_optimizer("adam", {"lr": 1e-3}), 0, "cpu")
    rng = np.random.RandomState(0)
    labels = np.zeros((8, 16, 16), np.uint8)
    labels[:, 4:12, 4:12] = 1
    images = rng.rand(8, 16, 16, 2).astype(np.float32) * 0.1
    images[..., 0] += labels
    batch = torch_batch({"images": images, "labels": labels,
                         "valid": np.ones(8, np.float32)})
    step = steps.make_train_step()
    if model_type == "postnet":  # an error net over the image and an
        # empty baseline (auxiliary_segm): its target is the lesion
        step = steps.make_auxiliary_train_step()
        batch["labels"] = torch.stack([batch["labels"],
                                       torch.zeros_like(batch["labels"])], -1)
        batch["images"] = batch["images"][..., :1]
    losses = [float(step(state, batch, steps.step_generator(0, 0, i, "cpu"))
                    ["loss"]) for i in range(15)]
    assert losses[-1] < losses[0]
    for name, value in state.model.state_dict().items():
        if value.is_floating_point():
            assert value.dtype == torch.float32, name
    assert state.opt_state["mu"].dtype == torch.float32


# ---------------------------------------------------------------- remat

class RecordingSGD(SGD):
    """SGD that keeps a copy of each step's gradients."""

    def step(self, params, state):
        self.grads = {k: p.grad.clone() for k, p in params.items()}
        super().step(params, state)


REMAT_CASES = {
    "ce": dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
               dropout=0.3),
    "ce_residual_bn_free": dict(nb_classes=2, in_channels=3, depth=2,
                                start_filters=4, dropout=0.3, residual=True,
                                bn=False),
    "ce_bf16": dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
                    dropout=0.3, dtype="bfloat16"),
    "aleatoric": dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
                      dropout=0.3, sigma_out=True),
    "auxiliary_segm": dict(nb_classes=2, in_channels=4, depth=2,
                           start_filters=4, dropout=0.3),
}


def remat_case(kind, policy, mesh):
    record = REMAT_CASES[kind]
    if kind == "aleatoric":
        step = steps.make_train_step("aleatoric", is_log_sigma=True,
                                     nb_samples=3, remat=policy, mesh=mesh)
    elif kind == "auxiliary_segm":
        step = steps.make_auxiliary_train_step(remat=policy, mesh=mesh)
    else:
        step = steps.make_train_step(remat=policy, mesh=mesh)
    batch = make_batch(4, n=4, labels_channels=2 if kind == "auxiliary_segm"
                       else None)
    return record, step, torch_batch(batch)


def remat_state(record):
    torch.manual_seed(5)
    model = get_model("unet", record)
    optimizer = RecordingSGD(lr=0.1)
    return TrainState(model, optimizer,
                      optimizer.init(dict(model.named_parameters())))


@pytest.mark.parametrize("mesh_parts", [1, 2])
@pytest.mark.parametrize("policy", ["conv", "full"])
@pytest.mark.parametrize("kind", list(REMAT_CASES))
def test_remat_is_bitwise_no_remat(kind, policy, mesh_parts):
    mesh = None if mesh_parts == 1 else Mesh([torch.device("cpu")] * 2)
    record, step, batch = remat_case(kind, None, mesh)
    _, remat_step, _ = remat_case(kind, policy, mesh)
    want_state = remat_state(record)
    got_state = copy.deepcopy(want_state)
    generator = lambda: steps.step_generator(3, 0, 1, "cpu")  # noqa: E731
    want = step(want_state, batch, generator())
    reruns = remat.counter.reruns
    got = remat_step(got_state, batch, generator())
    assert remat.counter.reruns > reruns  # the backward recomputed
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["dice"], want["dice"])
    grads = got_state.optimizer.grads
    assert grads.keys() == want_state.optimizer.grads.keys()
    for name, g in want_state.optimizer.grads.items():
        assert torch.equal(grads[name], g), name
    for (name, a), b in zip(got_state.model.state_dict().items(),
                            want_state.model.state_dict().values()):
        assert torch.equal(a, b), name
    moved = [n for n, v in got_state.model.state_dict().items()
             if "running_mean" in n and torch.any(v != 0)]
    assert moved or not record.get("bn", True)  # the statistics moved once


def test_remat_policy_refusals():
    for factory in (steps.make_train_step, steps.make_auxiliary_train_step):
        with pytest.raises(ValueError, match="unknown remat policy 'some'; "
                                             "choose None, 'conv' or 'full'"):
            factory(remat="some")
