"""The port reads checkpoints written by the JAX checkpoint service: the
msgpack payload decodes without flax, and the converted state_dict holds
every flax array exactly."""
import jax
import numpy as np
import pytest
import torch
from flax import serialization

from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.engine.config import ParametricNode as JaxNode
from rcu_tpu_torch.engine import checkpoint as ckpt
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.models.convert import state_dict_from_flax
from tests.test_torch_unet import flax_unet

PARAMS = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
              dropout=0.05)


def _flat(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flat(value, prefix + (key,))
        else:
            yield prefix + (key,), value


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("ckpt") / "model_x")
    mf = jax_ckpt.ModelFiles.from_model_dir(model_dir)
    jax_ckpt.backup_model_parameters(mf, JaxNode("unet", PARAMS), None)
    _, params, stats = flax_unet(PARAMS, (16, 16), seed=11)
    state = {"params": params, "batch_stats": stats, "epoch": 3,
             "best_score": np.float32(0.75)}
    jax_ckpt.save_checkpoint(mf, state, epoch=3, best=True)
    jax_ckpt.save_checkpoint(mf, state, epoch=5)
    return model_dir, params, stats


def test_model_json_and_checkpoint_addressing(saved):
    model_dir, _, _ = saved
    mf = ckpt.ModelFiles.from_model_dir(model_dir)
    node, optimizer = ckpt.load_model_parameters(mf)
    assert (node.type, node.params, optimizer) == ("unet", PARAMS, None)
    jax_mf = jax_ckpt.ModelFiles.from_model_dir(model_dir)
    for at in ("best", "last", 5, 3, 7):
        assert ckpt.find_checkpoint_file(mf, at) == \
            jax_ckpt.find_checkpoint_file(jax_mf, at), at


def test_payload_decodes_exactly(saved):
    model_dir, params, stats = saved
    mf = ckpt.ModelFiles.from_model_dir(model_dir)
    raw = ckpt.load_checkpoint(ckpt.find_checkpoint_file(mf, "best"))
    assert raw["epoch"] == 3 and raw["best_score"] == np.float32(0.75)
    for tree, got in ((params, raw["params"]), (stats, raw["batch_stats"])):
        want = dict(_flat(tree))
        have = dict(_flat(got))
        assert want.keys() == have.keys()
        for path, value in want.items():
            assert have[path].dtype == value.dtype, path
            np.testing.assert_array_equal(have[path], value, err_msg=str(path))


def test_converted_state_dict_holds_every_array(saved):
    model_dir, params, stats = saved
    mf = ckpt.ModelFiles.from_model_dir(model_dir)
    raw = ckpt.load_checkpoint(ckpt.find_checkpoint_file(mf, "last"))
    state = state_dict_from_flax(raw["params"], raw["batch_stats"])
    model = get_model("unet", PARAMS)
    model.load_state_dict(state)  # strict: every key, no extra
    sd = model.state_dict()
    for path, value in _flat(params):
        leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
        if path[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)
        assert torch.equal(sd[".".join(path[:-1] + (leaf,))],
                           torch.from_numpy(np.ascontiguousarray(value)))
    for path, value in _flat(stats):
        leaf = {"mean": "running_mean", "var": "running_var"}[path[-1]]
        assert torch.equal(sd[".".join(path[:-1] + (leaf,))],
                           torch.from_numpy(value))


def test_chunked_array_leaves_decode(tmp_path, monkeypatch):
    """flax splits arrays above MAX_CHUNK_SIZE into chunk dicts; shrink the
    size so a small tree exercises that path."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"w": np.arange(50, dtype=np.float32).reshape(5, 10)},
            "scalar": np.int64(4)}
    path = str(tmp_path / "c.ckpt")
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(jax.tree_util.tree_map(
            lambda x: x, tree)))
    raw = ckpt.load_checkpoint(path)
    np.testing.assert_array_equal(raw["params"]["w"], tree["params"]["w"])
    assert raw["scalar"] == 4
