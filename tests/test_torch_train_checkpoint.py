"""Checkpoints written by the port's trainer in the JAX package's schema:
flax's msgpack encoding byte for byte, a port checkpoint restored by
``rcu_tpu.engine.checkpoint.load_checkpoint(path, template)`` (optimizer
state included), a JAX checkpoint resumed by the port bitwise, and the
best + 3 last retention's file names."""
import os

import jax
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.engine import hooks as jax_hooks
from rcu_tpu.engine.state import create_train_state as jax_create_state
from rcu_tpu.models import get_model as jax_get_model
from rcu_tpu_torch.engine import checkpoint as ckpt
from rcu_tpu_torch.engine import hooks, steps
from rcu_tpu_torch.engine.state import TrainState, create_train_state
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.models.convert import flax_from_state_dict

UNET = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4,
            dropout=0.1)


def trained_port_state(optimizer=("adam", {"lr": 1e-3})):
    """A port train state after two steps (non-zero moments, count 2)."""
    state = create_train_state(get_model("unet", UNET),
                               get_optimizer(*optimizer), 20, "cpu")
    step = steps.make_train_step()
    rng = np.random.RandomState(0)
    for i in range(2):
        batch = {"images": torch.from_numpy(
                     rng.randn(3, 16, 16, 2).astype(np.float32)),
                 "labels": torch.from_numpy(
                     (rng.rand(3, 16, 16) < 0.3).astype(np.uint8)),
                 "valid": torch.ones(3)}
        step(state, batch, steps.step_generator(20, 0, i, "cpu"))
    return state


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def assert_trees_equal(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        a, b = np.asarray(got[key]), np.asarray(want[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key


def test_encoding_is_flax_msgpack(tmp_path):
    payload = {**trained_port_state().to_flax(), "epoch": 4,
               "best_score": np.float32(0.25)}
    mf = ckpt.ModelFiles.from_model_dir(str(tmp_path))
    path = ckpt.save_checkpoint(mf, payload, 4, best=True)
    assert path.endswith("checkpoints/checkpoint_ep004-best.ckpt")
    assert not os.path.exists(path + ".tmp")
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(
            serialization.to_state_dict(payload))


@pytest.mark.parametrize("optimizer", [("adam", {"lr": 1e-3}),
                                       ("sgd", {"lr": 1e-2}),
                                       ("sgd", {"lr": 1e-2, "momentum": 0.9})])
def test_jax_restores_a_port_checkpoint(tmp_path, optimizer):
    state = trained_port_state(optimizer)
    mf = ckpt.ModelFiles.from_model_dir(str(tmp_path))
    path = ckpt.save_checkpoint(mf, {**state.to_flax(), "epoch": 1,
                                     "best_score": np.float32(-np.inf)}, 1)
    name, params = optimizer
    tx = getattr(optax, name)(learning_rate=params["lr"],
                              **{k: v for k, v in params.items() if k != "lr"})
    jstate = jax_create_state(jax_get_model("unet", UNET), tx, (1, 16, 16, 2),
                              jax.random.PRNGKey(0))
    template = {"params": jstate.params, "batch_stats": jstate.batch_stats,
                "opt_state": jstate.opt_state, "epoch": 0,
                "best_score": np.float32(0)}
    restored = jax_ckpt.load_checkpoint(path, template)
    params, stats = flax_from_state_dict(state.model.state_dict())
    assert_trees_equal(restored["params"], params)
    assert_trees_equal(restored["batch_stats"], stats)
    assert type(restored["opt_state"]) is type(jstate.opt_state)
    assert_trees_equal(serialization.to_state_dict(restored["opt_state"]),
                       state.optimizer.to_flax(state.opt_state, state.params))
    if name == "adam":
        assert int(restored["opt_state"][0].count) == 2
    assert restored["epoch"] == 1 and np.isneginf(restored["best_score"])


def test_port_resumes_a_jax_checkpoint_bitwise(tmp_path):
    tx = optax.adam(1e-3)
    model = jax_get_model("unet", UNET)
    jstate = jax_create_state(model, tx, (1, 16, 16, 2), jax.random.PRNGKey(3))
    from rcu_tpu.engine import steps as jax_steps
    step = jax_steps.make_train_step(model, tx, donate=False)
    rng = np.random.RandomState(1)
    for i in range(2):
        batch = {"images": rng.randn(3, 16, 16, 2).astype(np.float32),
                 "labels": (rng.rand(3, 16, 16) < 0.3).astype(np.uint8),
                 "valid": np.ones(3, np.float32)}
        jstate, _ = step(jstate, batch, jax.random.PRNGKey(i))
    mf = jax_ckpt.ModelFiles.from_model_dir(str(tmp_path))
    jax_ckpt.save_checkpoint(mf, {"params": jstate.params,
                                  "batch_stats": jstate.batch_stats,
                                  "opt_state": jstate.opt_state, "epoch": 7,
                                  "best_score": np.float32(0.5)}, 7)
    port = create_train_state(get_model("unet", UNET),
                              get_optimizer("adam", {"lr": 1e-3}), 0, "cpu")
    raw = ckpt.load_checkpoint(ckpt.find_checkpoint_file(
        ckpt.ModelFiles.from_model_dir(str(tmp_path)), "last"))
    port.load_flax(raw)
    params, stats = flax_from_state_dict(port.model.state_dict())
    host = jax.tree_util.tree_map(np.asarray, jstate)
    assert_trees_equal(params, host.params)
    assert_trees_equal(stats, host.batch_stats)
    assert_trees_equal(port.optimizer.to_flax(port.opt_state, port.params),
                       serialization.to_state_dict(host.opt_state))
    assert port.opt_state["count"] == 2


class StubLoop:
    """What the retention hooks read of a loop: its model files and a
    checkpoint writer."""

    def __init__(self, ckpt_lib, model_dir):
        self.ckpt_lib = ckpt_lib
        self.model_files = ckpt_lib.ModelFiles.from_model_dir(model_dir)
        self.resume_epoch = None

    def save_checkpoint(self, epoch, best=False):
        self.ckpt_lib.save_checkpoint(self.model_files,
                                      {"epoch": epoch}, epoch, best)


def test_retention_keeps_the_jax_file_names(tmp_path):
    scores = [0.1, 0.5, 0.3, 0.6, 0.2, 0.4, 0.7, 0.1]
    names = []
    for name, ckpt_lib, hook_lib in (("jax", jax_ckpt, jax_hooks),
                                     ("port", ckpt, hooks)):
        loop = StubLoop(ckpt_lib, str(tmp_path / name))
        hook = hook_lib.ComposeTrainHook([hook_lib.SaveBestModelHook(),
                                          hook_lib.SaveNLastModelHook(3)])
        hook.on_startup(loop)
        best = None
        for epoch, score in enumerate(scores):
            is_best = best is None or score > best
            best = score if is_best else best
            hook.on_validation_end(loop, epoch, score, is_best, [])
            hook.on_epoch_end(loop, epoch)
        names.append(sorted(os.listdir(loop.model_files.weight_checkpoint_dir)))
        assert ckpt_lib.find_best_checkpoint_epoch(loop.model_files) == 6
        assert ckpt_lib.find_epoch_checkpoints(loop.model_files) == [5, 6, 7]
        assert ckpt_lib.find_last_checkpoint_epoch(loop.model_files) == 7
    assert names[0] == names[1] == [
        "checkpoint_ep005.ckpt", "checkpoint_ep006-best.ckpt",
        "checkpoint_ep006.ckpt", "checkpoint_ep007.ckpt"]


def test_model_json_is_written_once(tmp_path):
    from rcu_tpu_torch.engine.config import ParametricNode
    mf = ckpt.ModelFiles.create(str(tmp_path), "261017-000000")
    assert mf.model_dir.endswith("model_261017-000000")
    ckpt.backup_model_parameters(mf, ParametricNode("unet", UNET),
                                 ParametricNode("adam", {"lr": 1e-3}))
    ckpt.backup_model_parameters(mf, ParametricNode("unet", {}), None)
    model, optimizer = jax_ckpt.load_model_parameters(
        jax_ckpt.ModelFiles.from_model_dir(mf.model_dir))
    assert (model.type, model.params) == ("unet", UNET)
    assert (optimizer.type, optimizer.params) == ("adam", {"lr": 1e-3})
