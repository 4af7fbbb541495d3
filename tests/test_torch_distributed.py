"""Training across processes (``parallel.mesh.initialize_distributed``, the
loader's ``shard=(rank, n)``): two ``gloo`` processes on the CPU, each a
2-entry CPU mesh feeding its own shard of one epoch order, take one SGD
step of the U-Net with dropout 0.1; each process's step must equal one
single-process step on the two hosts' batches joined (the loss rtol
1e-5, every parameter and BatchNorm statistic rtol 1e-4, atol 1e-6: the
bar of ``tests/test_parallel.py``'s sharded step), and the two processes
must hold the same weights bitwise. The processes meet through a
``file://`` rendezvous under ``tmp_path``; the test gives them 120 s.

This file imports no JAX: its processes are spawned, and each imports it.
"""
import multiprocessing
import os
import time
import traceback

import numpy as np
import pytest
import torch

from rcu_tpu_torch.data.loader import SliceBatchLoader
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.engine.state import create_train_state
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.parallel import make_mesh
from rcu_tpu_torch.parallel import mesh as mesh_lib

UNET = dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
            dropout=0.1)
LIMIT_S = 120


class ArrayDataset:
    """Two subjects of 6 slices of 16x16, 3 channels, from a seed."""

    def __init__(self, seed=0):
        rng = np.random.RandomState(seed)
        self.subjects = ["a", "b"]
        self.arrays = {s: {"images": rng.randn(6, 16, 16, 3)
                           .astype(np.float32),
                           "labels": (rng.rand(6, 16, 16) < 0.4)
                           .astype(np.uint8)} for s in self.subjects}

    def read_slice(self, subject, z, category):
        return self.arrays[subject][category][z]


def first_batch(shard=None):
    dataset = ArrayDataset()
    indices = [(s, z) for s in range(2) for z in range(6)]
    loader = SliceBatchLoader(dataset, indices, batch_size=4, shuffle=True,
                              seed=3, shard=shard)
    loader.set_epoch(1)
    return {k: torch.from_numpy(v) for k, v in next(iter(loader)).items()}


def fresh_state():
    return create_train_state(get_model("unet", UNET),
                              get_optimizer("sgd", {"lr": 1e-2}), 7, "cpu")


def _worker(rank, init_method, out_dir):
    torch.set_num_threads(1)
    try:
        mesh_lib.initialize_distributed(num_processes=2, process_id=rank,
                                        init_method=init_method,
                                        device="cpu")
        assert mesh_lib.process_rows(4) == (4 * rank, 8)
        state = fresh_state()
        step = steps.make_train_step(mesh=make_mesh(n_devices=2,
                                                    device="cpu"))
        metrics = step(state, first_batch((rank, 2)),
                       steps.step_generator(20, 1, 0, "cpu"))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 loss=metrics["loss"].numpy(), dice=metrics["dice"].numpy(),
                 **{k: v.numpy() for k, v in
                    state.model.state_dict().items()})
    except BaseException:  # noqa: BLE001 — reported to the parent
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_gloo_processes_equal_one_step_on_the_joined_batch(tmp_path):
    ctx = multiprocessing.get_context("spawn")
    init_method = f"file://{tmp_path / 'rendezvous'}"
    procs = [ctx.Process(target=_worker, args=(rank, init_method,
                                               str(tmp_path)))
             for rank in range(2)]
    start = time.monotonic()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=max(1.0, LIMIT_S - (time.monotonic() - start)))
        alive = [p.pid for p in procs if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    errors = [open(tmp_path / f"rank{r}.err").read() for r in range(2)
              if (tmp_path / f"rank{r}.err").exists()]
    assert not errors, errors[0]
    assert not alive, f"processes {alive} still ran after {LIMIT_S} s"
    assert [p.exitcode for p in procs] == [0, 0]

    joined = {k: torch.cat([first_batch((r, 2))[k] for r in range(2)])
              for k in ("images", "labels", "valid")}
    state = fresh_state()
    want = steps.make_train_step()(state, joined,
                                   steps.step_generator(20, 1, 0, "cpu"))
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for got in ranks:
        np.testing.assert_allclose(got["loss"], want["loss"].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["dice"], want["dice"].numpy(),
                                   rtol=1e-5)
        for name, value in state.model.state_dict().items():
            if value.dtype.is_floating_point:
                np.testing.assert_allclose(got[name], value.numpy(),
                                           rtol=1e-4, atol=1e-6)
    for name in ranks[0].files:
        assert np.array_equal(ranks[0][name], ranks[1][name]), name


def test_outside_a_process_group():
    """No group: a process is the whole batch, and the cross-process sum is
    the identity."""
    assert not mesh_lib.distributed()
    assert mesh_lib.process_rows(5) == (0, 5)
    t = torch.ones(3)
    assert mesh_lib.all_reduce_sum(t) is t
    with pytest.raises(ValueError, match="not both"):
        mesh_lib.initialize_distributed("localhost:1234",
                                        init_method="file:///nowhere")
