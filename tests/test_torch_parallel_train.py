"""Training on a mesh (``rcu_tpu_torch.parallel.mesh.shard_train_step``,
``engine.steps.MeshTrainStep``) on virtual CPU meshes of 2 and 4 entries,
against the port's single-device step on the whole batch and against
``rcu_tpu.parallel.mesh.shard_train_step`` on the JAX tests' 8 CPU
devices; the loader's per-host shards against ``rcu_tpu.data.loader``;
``TrainLoop(mesh=)`` through ``strategies.train_default`` and a train CLI.

Bars: a mesh step adds its BatchNorm sums, losses and gradients over the
parts in another order than one device does, so it is held as
``tests/test_parallel.py`` holds JAX's sharded step against its single
step: the loss rtol 1e-5, every parameter and BatchNorm running
statistic after one SGD step (lr 1e-2) rtol 1e-4, atol 1e-6, the train
dice rtol 1e-5; ``batch_norm_train`` over parts rtol 1e-6 (its output,
running statistics and input gradient, atol 1e-6 / 1e-7 where a value
is near 0). The shard orders are exact.
"""
import copy
import glob
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rcu_tpu.data import indexing as jax_idx
from rcu_tpu.data import loader as jax_loader
from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.engine import steps as jax_steps
from rcu_tpu.engine.state import TrainState as JaxTrainState
from rcu_tpu.engine.state import create_train_state as jax_create_state
from rcu_tpu.models import get_model as jax_get_model
from rcu_tpu.parallel import mesh as jax_mesh
from rcu_tpu_torch import strategies
from rcu_tpu_torch.cli import brats_train_default
from rcu_tpu_torch.data import indexing, loader
from rcu_tpu_torch.engine import checkpoint as ckpt
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.engine import hooks as hooks_lib
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.engine.state import TrainState
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.models.convert import (flax_from_state_dict,
                                          state_dict_from_flax)
from rcu_tpu_torch.models.unet import batch_norm_train
from rcu_tpu_torch.parallel import make_mesh
from rcu_tpu_torch.parallel.mesh import (all_sum, current_part, run_parts,
                                         shard_batch, shard_train_step,
                                         split_bounds)
from tests.test_torch_direct import make_store
from tests.test_torch_loader import both, store  # noqa: F401 (fixture)
from tests.test_torch_test_loop import write_config as write_test_config
from tests.test_torch_train_strategies import SHAPE, write_config
from tests.test_torch_unet import flax_net, flax_unet

UNET = dict(nb_classes=2, in_channels=3, depth=2, start_filters=8,
            dropout=0.1)
HW = (16, 16)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread a part: the parts run in threads of their own,
    beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def cpu_mesh(n):
    return make_mesh(n_devices=n, device="cpu")


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------ the loader

@pytest.mark.parametrize("n_shards", [2, 3])
@pytest.mark.parametrize("kwargs", [
    dict(batch_size=2, shuffle=True),
    dict(batch_size=3, shuffle=True, shuffle_chunk=3),
    dict(batch_size=4, shuffle=False),
], ids=["uniform", "chunked", "unshuffled"])
def test_shard_order_equals_jax(store, n_shards, kwargs):  # noqa: F811
    """Each host's batches (their subject and slice indices) equal the JAX
    loader's for the same ``shard=(host, n)``, over three epochs; the
    hosts' batch counts are equal and their items disjoint."""
    jd, pd = both(store)
    ji = jax_idx.all_indices(jd, jax_idx.SliceIndexing())
    pi = indexing.all_indices(pd, indexing.SliceIndexing())
    for epoch in range(3):
        seen, counts = [], set()
        for host in range(n_shards):
            shard = (host, n_shards)
            want = jax_loader.SliceBatchLoader(jd, ji, shard=shard, seed=4,
                                               **kwargs)
            got = loader.SliceBatchLoader(pd, pi, shard=shard, seed=4,
                                          **kwargs)
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            assert len(got) == len(want)
            counts.add(len(got))
            for a, b in zip(want, got, strict=True):
                for key in ("subject_index", "slice_index", "valid"):
                    assert np.array_equal(a[key], b[key]), key
                seen += [(s, z) for s, z, v in zip(
                    b["subject_index"], b["slice_index"], b["valid"]) if v]
        assert len(counts) == 1
        assert len(seen) == len(set(seen))


# ------------------------------------------------------------ BatchNorm

@pytest.mark.parametrize("n_parts", [2, 4])
def test_batch_norm_train_over_parts(n_parts):
    """``batch_norm_train`` run by ``n_parts`` parts on their rows equals
    one call on the whole batch: the output, the running statistics of
    every part's copy and the input's gradient; outside a part it is the
    single call (``all_sum`` the identity)."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((1.5 * rng.randn(8, 6, 5, 5)
                          + 2 * rng.randn(6, 1, 1)).astype(np.float32))
    r = torch.from_numpy(rng.randn(8, 6, 5, 5).astype(np.float32))
    bn = torch.nn.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(1))
        bn.bias.normal_(generator=torch.Generator().manual_seed(2))
    whole_bn = copy.deepcopy(bn)
    xw = x.clone().requires_grad_()
    want = batch_norm_train(xw, whole_bn)
    (want * r).sum().backward()
    assert current_part() is None and all_sum(xw) is xw

    devices = cpu_mesh(n_parts).data_devices
    bounds = split_bounds(len(x), n_parts)
    rows = [(a, b, len(x)) for a, b in bounds]
    bns = [copy.deepcopy(bn) for _ in range(n_parts)]
    xp = x.clone().requires_grad_()
    outs = run_parts(lambda i: batch_norm_train(xp[slice(*bounds[i])],
                                                bns[i]), devices, rows)
    got = torch.cat(outs)
    (got * r).sum().backward()
    close(got.detach(), want.detach(), 1e-6, 1e-6)
    close(xp.grad, xw.grad, 1e-6, 1e-7)
    for part_bn in bns:
        close(part_bn.running_mean, whole_bn.running_mean, 1e-6, 1e-7)
        close(part_bn.running_var, whole_bn.running_var, 1e-6, 1e-7)


def test_a_failing_part_does_not_hang_the_others():
    """A part that raises before the sum breaks the barrier that the
    others wait at; the caller gets the part's own exception."""
    def fn(i):
        if i == 1:
            raise OSError("part 1 failed")
        return all_sum(torch.ones(2))

    devices = cpu_mesh(3).data_devices
    with pytest.raises(OSError, match="part 1 failed"):
        run_parts(fn, devices, [(i, i + 1, 3) for i in range(3)])
    assert current_part() is None


def test_all_sum_under_contention():
    """16 parts (more than the cores) through 40 sums each with a short
    switch interval: every part gets every round's total (a lost or
    stale slot would change it), and the run ends within 60 s."""
    n, rounds = 16, 40
    devices = [torch.device("cpu")] * n
    got = {}

    def fn(i):
        return [float(all_sum(torch.tensor(float(i * 1000 + r))))
                for r in range(rounds)]

    def run():
        got["totals"] = run_parts(fn, devices,
                                  [(i, i + 1, n) for i in range(n)])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        thread = threading.Thread(target=run, daemon=True)
        thread.start()
        thread.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not thread.is_alive()
    want = [sum(i * 1000 + r for i in range(n)) for r in range(rounds)]
    assert got["totals"] == [want] * n


# ------------------------------------------------------------ the steps

def make_batch(seed, n=8, channels=3, labels_channels=None):
    rng = np.random.RandomState(seed)
    shape = (n, *HW) + ((labels_channels,) if labels_channels else ())
    valid = np.ones(n, np.float32)
    valid[-1] = 0.0  # the loader's padding: the last row repeated
    images = rng.randn(n, *HW, channels).astype(np.float32)
    images[-1] = images[-2]
    return {"images": torch.from_numpy(images),
            "labels": torch.from_numpy((rng.rand(*shape) < 0.4)
                                       .astype(np.uint8)),
            "valid": torch.from_numpy(valid)}


def carried_state(model_type, record, seed, lr=1e-2):
    """A port state on flax weights of ``seed`` (``models.convert``), sgd."""
    _, params, stats = flax_net(model_type, record, HW, seed=seed)
    model = get_model(model_type, record)
    model.load_state_dict(state_dict_from_flax(params, stats))
    optimizer = get_optimizer("sgd", {"lr": lr})
    return TrainState(model, optimizer,
                      optimizer.init(dict(model.named_parameters())))


def assert_states_close(got, want):
    for (name, a), b in zip(got.model.state_dict().items(),
                            want.model.state_dict().values()):
        if a.dtype.is_floating_point:
            close(a, b, 1e-4, 1e-6)
        else:
            assert torch.equal(a, b), name


def step_case(kind):
    """(make_step(mesh), state, batch) of a train step kind."""
    if kind == "ce":
        return (lambda mesh: steps.make_train_step(mesh=mesh),
                carried_state("unet", UNET, 2), make_batch(3))
    if kind == "aleatoric":
        record = {**UNET, "sigma_out": True}
        return (lambda mesh: steps.make_train_step(
            "aleatoric", is_log_sigma=True, nb_samples=4, mesh=mesh),
            carried_state("unet", record, 4), make_batch(5))
    if kind == "auxiliary_feat":
        segm_record = {**UNET, "provide_features": True}
        _, params, stats = flax_unet(segm_record, HW, seed=6)
        segm = get_model("unet", segm_record)
        segm.load_state_dict(state_dict_from_flax(params, stats))
        segm = segm.eval().requires_grad_(False)
        post = dict(nb_classes=2, in_channels=8, nb_convs=2, dropout=0.1)
        return (lambda mesh: steps.make_auxiliary_train_step(segm, mesh=mesh),
                carried_state("postnet", post, 7), make_batch(8))
    record = {**UNET, "in_channels": 4}
    return (lambda mesh: steps.make_auxiliary_train_step(mesh=mesh),
            carried_state("unet", record, 10),
            make_batch(11, labels_channels=2))


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("kind", ["ce", "aleatoric", "auxiliary_feat",
                                  "auxiliary_segm"])
def test_mesh_step_equals_single_step(kind, n_parts):
    """One SGD step on ``n_parts`` CPU entries equals the single step on
    the whole batch from the same weights and generator (dropout 0.1
    through the parts' rows of the whole batch's masks; aleatoric noise
    drawn for the whole batch): loss, dice, parameters and BatchNorm
    statistics; the copies of the model do not replace it."""
    make_step, state, batch = step_case(kind)
    single = copy.deepcopy(state)
    want = make_step(None)(single, batch, torch.Generator().manual_seed(9))
    mesh_step = make_step(cpu_mesh(n_parts))
    model = state.model
    got = mesh_step(state, batch, torch.Generator().manual_seed(9))
    assert state.model is model and model.training
    close(got["loss"], want["loss"], 1e-5, 0)
    close(got["dice"], want["dice"], 1e-5, 0)
    assert_states_close(state, single)
    assert all(p.grad is None for p in state.model.parameters())
    # a second step: the copies take the updated weights first
    want = make_step(None)(single, batch, torch.Generator().manual_seed(10))
    got = mesh_step(state, batch, torch.Generator().manual_seed(10))
    close(got["loss"], want["loss"], 1e-5, 0)
    assert_states_close(state, single)


def test_mesh_step_with_injected_noise():
    """The aleatoric step with the whole batch's noise given: each part
    takes its rows of it."""
    make_step, state, batch = step_case("aleatoric")
    noise = torch.randn((4, 8, 2, *HW),
                        generator=torch.Generator().manual_seed(3))
    single = copy.deepcopy(state)
    step = steps.make_train_step("aleatoric", is_log_sigma=True,
                                 nb_samples=4)
    want = step(single, batch, torch.Generator().manual_seed(1), noise=noise)
    got = shard_train_step(step, cpu_mesh(2))(
        state, batch, torch.Generator().manual_seed(1), noise=noise)
    close(got["loss"], want["loss"], 1e-5, 0)
    assert_states_close(state, single)


def test_shard_train_step_refusals():
    with pytest.raises(TypeError, match="make_\\*train_step"):
        shard_train_step(lambda *a: None, cpu_mesh(2))
    make_step, state, _ = step_case("ce")
    with pytest.raises(ValueError, match="leaves a device without rows"):
        make_step(cpu_mesh(4))(state, make_batch(3, n=3),
                               torch.Generator().manual_seed(0))
    parts = shard_batch(make_batch(3, n=5), cpu_mesh(2))
    assert [len(p["valid"]) for p in parts] == [3, 2]


@pytest.mark.parametrize("n_parts", [2, 4])
def test_mesh_step_matches_jax_sharded_step(n_parts):
    """With dropout 0, the port's mesh step equals
    ``rcu_tpu.parallel.mesh.shard_train_step`` on the JAX tests' 8 CPU
    devices from the same weights, one SGD step (``tests/test_parallel.py``
    ``test_sharded_step_matches_single_device``'s bar)."""
    record = {**UNET, "dropout": 0.0}
    fm, params, stats = flax_unet(record, HW, seed=12)
    batch = make_batch(13)
    tx = optax.sgd(1e-2)
    raw = jax_steps.make_train_step(fm, tx, donate=False)
    sharded = jax_mesh.shard_train_step(raw.__wrapped__, jax_mesh.make_mesh(),
                                        donate=False)
    jstate = JaxTrainState(params=params, batch_stats=stats,
                           opt_state=tx.init(params), epoch=jnp.asarray(0),
                           best_score=jnp.asarray(0.0))
    jstate, jm = sharded(jstate, {k: v.numpy() for k, v in batch.items()},
                         jax.random.PRNGKey(5))
    state = carried_state("unet", record, 12)
    pm = steps.make_train_step(mesh=cpu_mesh(n_parts))(
        state, batch, torch.Generator().manual_seed(5))
    close(float(pm["loss"]), float(jm["loss"]), 1e-5, 0)
    want = state_dict_from_flax(*jax.tree_util.tree_map(
        np.asarray, (jstate.params, jstate.batch_stats)))
    for name, value in state.model.state_dict().items():
        if value.dtype.is_floating_point:
            close(value, want[name], 1e-4, 1e-6)


# ------------------------------------------------------------ the loop

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from rcu_tpu.data.split import save_split
    tmp_path = tmp_path_factory.mktemp("parallel_train")
    store = make_store(tmp_path, SHAPE)
    split = str(tmp_path / "split.json")
    save_split(split, ["s00", "s01"], ["s02"], ["s02", "s03"])
    return tmp_path, store, split


STORE_UNET = {"depth": 2, "dropout": 0.1, "in_channels": 4, "nb_classes": 2,
              "start_filters": 8}


def assert_jax_restores(model_files, record, state_dict):
    """The run's best checkpoint restores in ``rcu_tpu`` (a template of
    the model and ``write_config``'s sgd) to ``state_dict``'s weights."""
    path = ckpt.find_checkpoint_file(model_files, "best")
    jstate = jax_create_state(jax_get_model("unet", record), optax.sgd(0.5),
                              (1, *SHAPE[1:], record["in_channels"]),
                              jax.random.PRNGKey(0))
    restored = jax_ckpt.load_checkpoint(path, {
        "params": jstate.params, "batch_stats": jstate.batch_stats,
        "opt_state": jstate.opt_state, "epoch": 0,
        "best_score": np.float32(0)})
    want = jax.tree_util.tree_leaves(flax_from_state_dict(state_dict))
    got = jax.tree_util.tree_leaves((restored["params"],
                                     restored["batch_stats"]))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), b)


def test_train_default_on_a_mesh(env):
    """``strategies.train_default`` on 4 CPU entries: a batch of 10 pads to
    12 (valid 5 rows round up to 8), its best checkpoint restores in
    ``rcu_tpu`` and ``strategies.test_default`` reads it on the mesh."""
    tmp_path, store, split = env
    config = write_config(tmp_path, "mesh_default", store, split,
                          {"unet": STORE_UNET})
    config.train_data.batch_size = 10
    mesh = cpu_mesh(4)
    loop = strategies.train_default(config, mesh=mesh,
                                    hooks=[hooks_lib.SaveBestModelHook()])
    assert loop.train_data.loader.batch_size == 12
    assert loop.valid_data.loader.batch_size == 8
    assert loop.best_score is not None and np.isfinite(loop.best_score)
    assert_jax_restores(loop.model_files, STORE_UNET,
                        loop.state.model.state_dict())
    test_file = write_test_config(tmp_path / "mesh_test.yaml", "mesh_test",
                                  store, split, loop.model_files.model_dir)
    test_config = port_cfg.load(test_file, "test-config")
    test_config.test_dir = str(tmp_path / "mesh_test_out")
    tested = strategies.test_default(test_config, mesh=cpu_mesh(2))
    assert len(glob.glob(os.path.join(tested.run_dir,
                                      "*_probabilities.nii.gz"))) == 2


def test_train_cli_trains_on_a_cpu_mesh(env, monkeypatch):
    """``brats_train_default -config_file F -device cpu -devices 2``: the
    run trains on a 2-entry CPU mesh (its state on the mesh's first entry)
    and writes its checkpoints."""
    tmp_path, store, split = env
    config = write_config(tmp_path, "cli_mesh", store, split,
                          {"unet": {**STORE_UNET, "start_filters": 4}})
    path = str(tmp_path / "cli_mesh.yaml")
    assert os.path.exists(path) and config.train_name == "cli_mesh"
    loops = []
    real = strategies.train_default
    monkeypatch.setattr(strategies, "train_default",
                        lambda *a, **k: loops.append(real(*a, **k))
                        or loops[-1])
    monkeypatch.setattr(sys, "argv", ["brats_train_default", "-config_file",
                                      path, "-device", "cpu", "-devices",
                                      "2"])
    brats_train_default.cli()
    loop, = loops
    assert loop.mesh.devices == (torch.device("cpu"),) * 2
    assert isinstance(loop.train_step, steps.MeshTrainStep)
    assert sorted(os.listdir(loop.model_files.weight_checkpoint_dir)) == [
        "checkpoint_ep000-best.ckpt", "checkpoint_ep000.ckpt"]
