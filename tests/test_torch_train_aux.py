"""The auxiliary train steps' gradients against ``jax.grad`` of the JAX
steps' own loss functions, the train-time predicts, and a 3-step
trajectory of both packages' train steps, on carried weights (the bars
and helpers of ``tests/test_torch_train_step.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcu_tpu.engine import steps as jax_steps
from rcu_tpu.engine.state import TrainState as JaxTrainState
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.models.convert import state_dict_from_flax
from tests.test_torch_train_step import (HW, UNET, assert_steps_match,
                                         jax_loss_fn, make_batch, port_batch,
                                         port_model, port_state, run_both,
                                         scaled_close, to64, torch_batch)
from tests.test_torch_unet import flax_net, flax_unet


def test_auxiliary_feat_step_matches_jax():
    segm_params = {**UNET, "provide_features": True}
    segm_fm, s_params, s_stats = flax_unet(segm_params, HW, seed=6)
    post = dict(nb_classes=2, in_channels=8, nb_convs=2, dropout=0.0)
    post_fm, p_params, p_stats = flax_net("postnet", post, HW, seed=7)
    batch = make_batch(8, valid=[1, 1, 1, 0])
    loss_fn = jax_loss_fn(jax_steps.make_auxiliary_train_step(
        post_fm, optax.adam(1e-3), segm_model=segm_fm))

    def port_run(dtype):
        segm = port_model("unet", segm_params, s_params, s_stats, dtype)
        state = port_state("postnet", post, p_params, p_stats, dtype=dtype)
        metrics = steps.make_auxiliary_train_step(segm)(
            state, port_batch(batch, dtype), torch.Generator().manual_seed(0))
        assert not segm.training
        assert all(p.grad is None for p in segm.parameters())
        return metrics, state

    out = run_both(loss_fn, (p_params, p_stats, (s_params, s_stats), batch,
                             jax.random.PRNGKey(0)), port_run)
    _, score = assert_steps_match(out)
    np.testing.assert_allclose(float(out[torch.float64][1][0]["dice"]),
                               float(score), rtol=1e-5)


def test_auxiliary_segm_step_matches_jax():
    params = {**UNET, "in_channels": 4}
    fm, flax_params, stats = flax_unet(params, HW, seed=10)
    batch = make_batch(11, labels_channels=2, valid=[1, 1, 0, 0])
    loss_fn = jax_loss_fn(jax_steps.make_auxiliary_train_step(
        fm, optax.adam(1e-3)))

    def port_run(dtype):
        state = port_state("unet", params, flax_params, stats, dtype=dtype)
        metrics = steps.make_auxiliary_train_step()(
            state, port_batch(batch, dtype), torch.Generator().manual_seed(0))
        return metrics, state

    assert_steps_match(run_both(loss_fn, (flax_params, stats, None, batch,
                                          jax.random.PRNGKey(0)), port_run))


def test_train_predict_fns_match_jax():
    """The validation forwards of the default and both auxiliary runs."""
    segm_params = {**UNET, "provide_features": True}
    segm_fm, s_params, s_stats = flax_unet(segm_params, HW, seed=12)
    post = dict(nb_classes=2, in_channels=8, nb_convs=1)
    post_fm, p_params, p_stats = flax_net("postnet", post, HW, seed=13)
    segm = get_model("unet", segm_params)
    segm.load_state_dict(state_dict_from_flax(s_params, s_stats))
    postnet = get_model("postnet", post)
    postnet.load_state_dict(state_dict_from_flax(p_params, p_stats))
    batch = make_batch(14, labels_channels=2)
    runs = [(jax_steps.make_predict_fn(segm_fm)(s_params, s_stats, batch),
             steps.make_predict_fn()(segm, torch_batch(batch))),
            (jax_steps.make_auxiliary_feat_predict_fn(segm_fm, post_fm)(
                s_params, s_stats, p_params, p_stats, batch),
             steps.make_auxiliary_feat_predict_fn(segm)(postnet,
                                                        torch_batch(batch)))]
    aux = {**UNET, "in_channels": 4}
    fm, params, stats = flax_unet(aux, HW, seed=15)
    model = get_model("unet", aux)
    model.load_state_dict(state_dict_from_flax(params, stats))
    runs.append((jax_steps.make_auxiliary_segm_predict_fn(fm)(params, stats,
                                                              batch),
                 steps.make_auxiliary_segm_predict_fn()(model,
                                                        torch_batch(batch))))
    with torch.no_grad():
        for want, got in runs:
            assert set(got) == set(want)
            for key in want:
                np.testing.assert_allclose(got[key].numpy(),
                                           np.asarray(want[key]),
                                           rtol=1e-3, atol=2e-4, err_msg=key)


@pytest.mark.parametrize("name,lr,dtype", [("sgd", 0.1, torch.float32),
                                           ("adam", 1e-3, torch.float64)])
def test_three_step_trajectory_matches_jax(name, lr, dtype):
    """make_train_step in both packages from the same weights, three
    batches (the last padded): the losses, the parameters and BatchNorm
    statistics rtol 1e-4 (atol 1e-6 x the tensor's max), and with sgd the
    outputs of the trained models too (adam's are those of its held
    parameters through the float32 class head).

    Adam runs in float64: its update divides by the gradient's running
    size, so in float32 an element whose gradient lies near the rounding
    floor (the pre-BatchNorm conv biases, whose gradient is zero in exact
    arithmetic, and elements up to ~1e-5 x their tensor's max) steps by up
    to lr in a direction that the rounding picks, in either package.
    Adam's float32 arithmetic is held on identical gradients above."""
    fm, flax_params, stats = flax_unet(UNET, HW, seed=18)
    if dtype == torch.float64:
        flax_params, stats = to64(flax_params), to64(stats)
    tx = getattr(optax, name)(lr)
    with jax.enable_x64(dtype == torch.float64):
        jax_step = jax_steps.make_train_step(fm, tx, donate=False)
        jstate = JaxTrainState(params=flax_params, batch_stats=stats,
                               opt_state=tx.init(flax_params),
                               epoch=jnp.asarray(0),
                               best_score=jnp.asarray(0.0))
        state = port_state("unet", UNET, flax_params, stats,
                           get_optimizer(name, {"lr": lr}), dtype=dtype)
        step = steps.make_train_step()
        for i in range(3):
            batch = make_batch(20 + i, valid=[1, 1, 1, int(i < 2)])
            jstate, jm = jax_step(jstate, to64(batch) if dtype == torch.float64
                                  else batch, jax.random.PRNGKey(i))
            pm = step(state, port_batch(batch, dtype),
                      torch.Generator().manual_seed(i))
            np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                       rtol=1e-4)
        x = make_batch(30)["images"]
        wantl = fm.apply({"params": jstate.params,
                          "batch_stats": jstate.batch_stats},
                         to64(x) if dtype == torch.float64 else x).logits
        trained = jax.tree_util.tree_map(np.asarray, (jstate.params,
                                                      jstate.batch_stats))
    want = state_dict_from_flax(*to64(trained))
    for key, value in state.model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            scaled_close(value.double().numpy(), want[key].numpy(), 1e-4, 1e-6)
    if name == "sgd":
        got = state.model.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).logits
        scaled_close(got.detach().permute(0, 2, 3, 1).numpy(), wantl, 1e-4,
                     1e-6)
