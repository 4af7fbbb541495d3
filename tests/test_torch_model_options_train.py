"""The U-Net options ``residual`` and ``bn`` (continued from
``tests/test_torch_model_options.py``, whose helpers and bars these use):
bf16 against flax's bf16 model at the bf16 bar, extended by a residual
block's roundings (its 1x1 conv, its add, the split add on the fast
decoder) and with one rounding a BN-free site; a train step's gradients
and BatchNorm statistics against ``jax.grad`` of the JAX step's loss
(``tests/test_torch_train_step.py``'s bars); a mesh step against the
single step."""
import copy

import jax
import numpy as np
import optax
import pytest
import torch

from rcu_tpu.engine import steps as jax_steps
from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu.models.unet import precast_params as jax_precast_params
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval.direct import model_from_flax
from rcu_tpu_torch.models import FAST_DECODER_KWARGS, get_model
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.parallel import Mesh
from tests.test_torch_model_options import (HW, IDS, OPTIONS, base,
                                            flax_logits, flax_variables,
                                            port_logits, roundings)
from tests.test_torch_train_step import (PRE_BN_BIAS, jax_loss_fn, make_batch,
                                         port_batch, port_state, run_both,
                                         scaled_close)
from tests.test_torch_variants import BF16_STEP


@pytest.mark.parametrize("options", OPTIONS, ids=IDS)
@pytest.mark.parametrize("fast", [False, True])
def test_bf16_matches_flax(options, fast):
    """bf16 (precast, channels-last as the steps hand it) against flax's
    bf16 model on the same weights, at the bf16 bar of the f32 logits'
    scale; the precast casts every conv (the residual 1x1s too) and leaves
    BatchNorm in f32, and its logits are bitwise the per-call cast's."""
    params = base(2, 4, **options)
    hw = (24, 24)
    flax_params, stats = flax_variables(params, hw, seed=11)
    flags = FAST_DECODER_KWARGS if fast else {}
    x = np.random.RandomState(12).rand(2, *hw, 3).astype(np.float32)
    bf16 = {**params, **flags, "dtype": "bfloat16"}
    want = flax_logits(bf16, *jax_precast_params(
        flax_get_model("unet", bf16), flax_params, stats), x)
    model = model_from_flax("unet", params, flax_params, stats, "cpu",
                            dtype="bfloat16", fast_decoder=fast)
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if "BatchNorm" in name
                           else torch.bfloat16), name
    got = port_logits(model, x, channels_last=True)
    per_call = get_model("unet", {**bf16})
    per_call.load_state_dict(state_dict_from_flax(flax_params, stats))
    assert np.array_equal(port_logits(per_call, x, channels_last=True), got)
    scale = float(np.abs(flax_logits(params, flax_params, stats, x)).max())
    bar = roundings(2, options, split=fast) * BF16_STEP * scale
    err = float(np.abs(got - want).max())
    assert err <= bar, (err, bar)


# ------------------------------------------------------------ training

def assert_grads_match(out, bn: bool):
    """``test_torch_train_step.assert_steps_match``'s bars; the conv bias
    before a BatchNorm (zero gradient in exact arithmetic) only where the
    model has BatchNorm."""
    (_, _, g32), (m32, s32) = out[torch.float32]
    (loss64, aux64, g64), (m64, s64) = out[torch.float64]
    np.testing.assert_allclose(float(m64["loss"]), loss64, rtol=1e-5)
    np.testing.assert_allclose(float(m32["loss"]), loss64, rtol=1e-5)
    port32, port64 = s32.optimizer.grads, s64.optimizer.grads
    assert set(port32) == set(port64) == set(g64)
    for name, want in g64.items():
        want = want.numpy()
        if bn and PRE_BN_BIAS.search(name):
            kernel = np.abs(g64[name[:-len("bias")] + "weight"].numpy()).max()
            for got in (port32[name], port64[name]):
                assert float(got.abs().max()) <= 1e-6 * kernel, name
            continue
        scaled_close(port64[name].numpy(), want, 1e-4, 1e-6)
        reference = np.abs(g32[name].numpy() - want).max()
        excess = np.abs(port32[name].double().numpy() - want) \
            - 1e-4 * np.abs(want)
        assert excess.max() <= reference, (name, excess.max(), reference)
    stats = {k: v for k, v in state_dict_from_flax({}, aux64[0]).items()
             if "running" in k}
    for model in (s32.model, s64.model):
        running = {k: v for k, v in model.state_dict().items()
                   if "running" in k}
        assert set(running) == set(stats)
        for name, value in running.items():
            scaled_close(value.double().numpy(), stats[name].numpy(),
                         1e-4, 1e-6)


@pytest.mark.parametrize("options", OPTIONS, ids=IDS)
def test_train_step_matches_jax(options):
    params = dict(nb_classes=2, in_channels=3, depth=2, start_filters=8,
                  dropout=0.0, **options)
    flax_params, stats = flax_variables(params, HW, seed=2)
    batch = make_batch(3, valid=[1, 1, 1, 0])
    loss_fn = jax_loss_fn(jax_steps.make_train_step(
        flax_get_model("unet", params), optax.adam(1e-3)))

    def port_run(dtype):
        state = port_state("unet", params, flax_params, stats, dtype=dtype)
        metrics = steps.make_train_step()(
            state, port_batch(batch, dtype), torch.Generator().manual_seed(0))
        return metrics, state

    assert_grads_match(run_both(loss_fn, (flax_params, stats, batch,
                                          jax.random.PRNGKey(0)), port_run),
                       options.get("bn", True))


@pytest.mark.parametrize("options", OPTIONS, ids=IDS)
def test_mesh_step_equals_single_step(options):
    """One SGD step with dropout on a 2-entry CPU mesh against one device
    on the whole batch (``tests/test_torch_parallel_train.py``'s bars); a
    BN-free model has no BatchNorm sum to make over the parts."""
    from rcu_tpu_torch.models import get_optimizer
    from rcu_tpu_torch.engine.state import TrainState
    params = base(2, 4, **options)
    flax_params, stats = flax_variables(params, HW, seed=4)
    model = get_model("unet", params)
    model.load_state_dict(state_dict_from_flax(flax_params, stats))
    sgd = get_optimizer("sgd", {"lr": 1e-2})
    state = TrainState(model, sgd, sgd.init(dict(model.named_parameters())))
    single = copy.deepcopy(state)
    batch = {k: torch.from_numpy(v) for k, v in make_batch(5).items()}
    want = steps.make_train_step()(single, batch,
                                   torch.Generator().manual_seed(9))
    got = steps.make_train_step(mesh=Mesh([torch.device("cpu")] * 2))(
        state, batch, torch.Generator().manual_seed(9))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    for (name, a), b in zip(state.model.state_dict().items(),
                            single.model.state_dict().values()):
        if a.dtype.is_floating_point:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
