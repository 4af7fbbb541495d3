"""Fused ensemble training (``rcu_tpu_torch.parallel.ensemble.
train_ensemble_fused`` and its CLI) on the CPU: member 0's lockstep step on
a 2 x 1 model x data mesh is bitwise its solo step; a 2-member run on that
mesh writes per-member run dirs whose best checkpoints ``rcu_tpu``
restores and ``strategies.test_ensemble`` reads, as
``tests/test_parallel.py::test_train_ensemble_fused_end_to_end`` does with
JAX's; the four refusals are JAX's, word for word; the CLI takes a mesh by
JAX's rule."""
import copy
import glob
import os

import numpy as np
import pytest
import torch

from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.parallel import ensemble as jax_ens
from rcu_tpu_torch import strategies
from rcu_tpu_torch.cli import train_ensemble_fused as fused_cli
from rcu_tpu_torch.engine import checkpoint as ckpt
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.engine.state import create_train_state
from rcu_tpu_torch.eval.direct import load_model
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.parallel import ensemble as ens_lib
from rcu_tpu_torch.parallel import make_mesh
from tests.test_torch_direct import make_store
from tests.test_torch_parallel_train import (STORE_UNET, assert_jax_restores,
                                             make_batch)
from tests.test_torch_test_loop import write_config as write_test_config
from tests.test_torch_train_strategies import SHAPE, write_config


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def model_by_mesh():
    return ens_lib.make_ensemble_mesh(2, make_mesh(n_devices=2,
                                                   device="cpu").devices)


def test_member_step_equals_its_solo_step():
    """One lockstep step of 2 members on a 2 x 1 model x data mesh: member
    0 (its row's one data device: the single step) is bitwise its solo
    step from the same init and generator; member 1 is not member 0."""
    record = {**STORE_UNET, "in_channels": 3}
    placement = ens_lib.member_placement(2, model_by_mesh())
    assert [d for d, _ in placement] == [torch.device("cpu")] * 2
    optimizer = get_optimizer("adam", {"lr": 1e-3})
    states = [create_train_state(get_model("unet", record), optimizer,
                                 20 + i, device) for i, (device, _)
              in enumerate(placement)]
    solo = copy.deepcopy(states[0])
    member_steps = [steps.make_train_step(mesh=row) for _, row in placement]
    batches = [make_batch(1), make_batch(2)]
    ens_lib.ensemble_step(
        states, member_steps, batches,
        [steps.seeded_generator((20, 0, 0, m), "cpu") for m in range(2)])
    steps.make_train_step()(solo, batches[0],
                            steps.seeded_generator((20, 0, 0, 0), "cpu"))
    for (name, a), b in zip(states[0].model.state_dict().items(),
                            solo.model.state_dict().values()):
        assert torch.equal(a, b), name
    for key in ("mu", "nu"):
        assert torch.equal(states[0].opt_state[key], solo.opt_state[key])
    assert not torch.equal(states[1].opt_state["mu"], solo.opt_state["mu"])


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from rcu_tpu.data.split import save_split
    tmp_path = tmp_path_factory.mktemp("ensemble_train")
    store = make_store(tmp_path, SHAPE)
    split = str(tmp_path / "split.json")
    # k-fold style: each member its own train list, shared valid/test
    save_split(split, [["s00"], ["s01"]], [["s02"], ["s02"]],
               [["s03"], ["s03"]])
    return tmp_path, store, split


def member_configs(env, names, epochs=2):
    tmp_path, store, split = env
    configs = []
    for k, name in enumerate(names):
        cfg = write_config(tmp_path, name, store, split,
                           {"unet": STORE_UNET}, others={"split_k": k},
                           epochs=epochs)
        configs.append(cfg)
    return configs


def test_train_ensemble_fused_end_to_end(env):
    tmp_path, store, split = env
    members = ens_lib.train_ensemble_fused(
        member_configs(env, ["member0", "member1"]), mesh=model_by_mesh())
    assert len(members) == 2
    for i, m in enumerate(members):
        assert m.best_score is not None and np.isfinite(m.best_score)
        best = ckpt.find_best_checkpoint_epoch(m.model_files)
        assert best is not None
        assert os.path.exists(m.model_files.model_path)
        assert sorted(os.listdir(m.model_files.weight_checkpoint_dir)) == \
            sorted([f"checkpoint_ep{best:03d}-best.ckpt",
                    "checkpoint_ep000.ckpt", "checkpoint_ep001.ckpt"])
        assert m.run_dir.endswith(f"_member{i}")
        # the best checkpoint restores in rcu_tpu and in the port
        model = load_model(m.model_files.model_dir, "best", "cpu")
        assert_jax_restores(m.model_files, STORE_UNET, model.state_dict())
    assert members[0].run_dir != members[1].run_dir
    # the per-member artifacts feed the standard ensemble test loop
    test_file = write_test_config(
        tmp_path / "fused_ens_test.yaml", "fused_ens_test", store, split,
        members[0].model_files.model_dir,
        others={"model_dir": [members[1].model_files.model_dir],
                "test_at": "best", "split_k": 0})
    config = port_cfg.load(test_file, "test-config")
    loop = strategies.test_ensemble(config, device="cpu")
    assert len(glob.glob(os.path.join(loop.run_dir,
                                      "*_probabilities.nii.gz"))) == 1


@pytest.mark.parametrize("change", ["model", "optimizer", "epochs", "name"])
def test_fused_refusals_are_jax_s(env, change):
    tmp_path, _, _ = env
    paths = [str(tmp_path / f"refuse_{change}_{k}.yaml") for k in range(2)]
    member_configs(env, [f"refuse_{change}_{k}" for k in range(2)])
    runs = []
    for load in (port_cfg.load, jax_cfg.load):
        configs = [load(p, "train-config") for p in paths]
        second = configs[1]
        if change == "model":
            second.model.params["start_filters"] = 4
        elif change == "optimizer":
            second.optimizer.params["lr"] = 0.1
        elif change == "epochs":
            second.epochs = 3
        else:
            second.train_name = configs[0].train_name
        runs.append(configs)
    with pytest.raises(ValueError) as got:
        ens_lib.train_ensemble_fused(runs[0], device="cpu")
    with pytest.raises(ValueError) as want:
        jax_ens.train_ensemble_fused(runs[1])
    assert str(got.value) == str(want.value)
    assert not glob.glob(str(tmp_path / "out" / f"*refuse_{change}*"))


@pytest.mark.parametrize("ks,no_mesh,rows", [([0], False, 1),
                                             ([0, 1], False, None),
                                             ([0], True, None)])
def test_cli_mesh_rule(monkeypatch, ks, no_mesh, rows):
    """JAX's rule: a mesh when the device count (the CPU: one) is a
    multiple of the member count and at least it; ``--no-mesh`` none."""
    seen = {}

    def fake(configs, mesh=None, device=None):
        seen.update(configs=configs, mesh=mesh, device=device)
        return []

    monkeypatch.setattr(ens_lib, "train_ensemble_fused", fake)
    monkeypatch.setattr("sys.argv", ["train_ensemble_fused", "--ds", "isic",
                                     "-k", *map(str, ks), "-device", "cpu"]
                        + (["--no-mesh"] if no_mesh else []))
    fused_cli.cli()
    assert [c.train_name for c in seen["configs"]] == \
        [f"isic_ensemble_k{k}" for k in ks]
    assert seen["device"] == "cpu"
    if rows is None:
        assert seen["mesh"] is None
    else:
        assert seen["mesh"].shape == {"model": rows, "data": 1}


def test_reserve_run_dir_retries_a_taken_id(tmp_path, monkeypatch):
    """Each member's run dir (and each TrainLoop's) is reserved by an
    exclusive create: an id taken within its second is drawn again, and
    five taken ids raise."""
    from rcu_tpu_torch.engine import train
    ids = iter(["20260101-000000", "20260101-000000", "20260101-000001"])
    monkeypatch.setattr(train.ids_lib, "unique_identifier", lambda: next(ids))
    monkeypatch.setattr(train.time, "sleep", lambda s: None)
    config = port_cfg.TrainConfiguration()
    config.train_dir, config.train_name = str(tmp_path), "m"
    first = train.reserve_run_dir(config)
    second = train.reserve_run_dir(config)
    assert first == ("20260101-000000", str(tmp_path / "20260101-000000_m"))
    assert second == ("20260101-000001", str(tmp_path / "20260101-000001_m"))
    monkeypatch.setattr(train.ids_lib, "unique_identifier",
                        lambda: "20260101-000000")
    with pytest.raises(RuntimeError, match="after 5 attempts"):
        train.reserve_run_dir(config)
