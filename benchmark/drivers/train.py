"""Training: ``rcu_tpu_torch.engine.train.TrainLoop``'s epochs over seeded
in-memory BraTS-like subjects, fed by the program's ``SliceBatchLoader``
(the slice indexing, the none-black selection, the shuffle of ``seed +
epoch``) through its ``prefetch``.

Set-up builds the loop, its model and Adam state, loads the benchmark's
seeded weights into the model and runs epoch 0 through the loop's own
epoch call: its first three steps are checked (each step's loss, the
first gradient as Adam's first moment holds it after one step, each
leaf's change after three). The window runs the same loop's further
epochs, a fixed number: ``--seconds`` times the traffic's
``epochs_per_s`` (a rate measured once on the card), at least one;
validation is not run. The first three steps of the window's last epoch
are checked too, from the program's weights and Adam state as that
epoch began (copied on the device; the copy is part of the window).
Afterwards the reference replays both stretches: the first from the same
seeded weights, the second from that copy, on the batches and dropout
streams of their epochs.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import compare, inputs, roofline
from benchmark.harness import Outcome
from benchmark.reference import streams
from benchmark.reference.train import adam_steps
from benchmark.reference.unet import precision

CHECKED_STEPS = 3


class CheckedSteps:
    """A train-loop hook that keeps, in each epoch of ``epochs``, the first
    steps' losses and the parameters after the last checked step, and in
    epoch 0 Adam's first moment after step 1 (copies on the device; the
    other steps pass by)."""

    def __init__(self, epochs):
        self.losses = {e: [] for e in epochs}
        self.params, self.first_moment = {}, None
        self.epoch_losses = []

    def on_training_batch_end(self, loop, epoch, batch_index, nb_batches,
                              metrics):
        if epoch not in self.losses or batch_index >= CHECKED_STEPS:
            return
        self.losses[epoch].append(metrics["loss"].detach().clone())
        if epoch == 0 and batch_index == 0:
            self.first_moment = loop.state.opt_state["mu"].detach().clone()
        if batch_index == CHECKED_STEPS - 1:
            self.params[epoch] = {k: p.detach().clone()
                                  for k, p in loop.state.params.items()}

    def on_training_end(self, loop, epoch, metrics_mean):
        self.epoch_losses.append(metrics_mean.get("loss", float("nan")))

    def __getattr__(self, name):  # the loop's other hook calls
        if name.startswith("on_"):
            return lambda *args, **kwargs: None
        raise AttributeError(name)


def _leaves(flat, params) -> dict:
    """A flat tensor over ``params`` (Adam's layout) split into its leaves."""
    sizes = [p.numel() for p in params.values()]
    return {k: part.view(params[k].shape)
            for k, part in zip(params, torch.split(flat, sizes))}


def _leaf_norms(flat, params) -> dict:
    return {k: float(part.norm()) for k, part in _leaves(flat, params).items()}


class TrainCell:
    """A cell's set-up: the seeded subjects and weights, and the program's
    train loop with its loader, model and Adam state, driven through
    epoch 0; the window's epochs are 1 to ``last``."""

    def __init__(self, run):
        from rcu_tpu_torch.data import indexing
        from rcu_tpu_torch.data.loader import SliceBatchLoader
        from rcu_tpu_torch.engine import config as cfg_lib, databuild
        from rcu_tpu_torch.engine.train import TrainLoop

        self.run, traffic, device = run, run.traffic, run.device
        self.model = run.config["model"]["unet"]
        data = run.config["data"]
        self.shape = tuple(data["shape"])
        self.volumes = inputs.brats_volumes(
            int(traffic["subjects"]), self.shape, int(data["channels"]),
            run.seed, device)
        pool = inputs.VolumePool(self.volumes, [
            f"train_{k:03d}" for k in range(len(self.volumes))])
        self.seed = run.seed % 2 ** 31  # the loader's RandomState: 32 bits
        self.batch = int(traffic["batch_size"])
        config = cfg_lib.TrainConfiguration.from_dict({
            "train_name": "bench", "train_dir": run.scratch,
            "seed": self.seed, "epochs": 1, "model": run.config["model"],
            "optimizer": run.config["optimizer"],
            "train_data": {"batch_size": self.batch, "shuffle": True}})
        self.last = max(1, int(round(run.seconds
                                     * float(traffic["epochs_per_s"]))))
        self.hook = CheckedSteps((0, self.last))
        self.start_of_last = None
        self.loop = TrainLoop(config, hooks=[self.hook], device=device)
        slicing = indexing.SliceIndexing()
        self.selected = indexing.select_indices(
            pool, slicing, indexing.NoneBlackSelection(), ("images",))
        self.loader = SliceBatchLoader(
            pool, self.selected, batch_size=self.batch,
            categories=("images", "labels"), shuffle=True, seed=self.seed,
            indexing=slicing, num_workers=int(traffic["num_workers"]))
        self.loop.train_data = databuild.Data(pool, self.loader,
                                              len(self.loader))
        self.w0 = inputs.weights(self.model, run.seed, device)

    def start(self):
        """The state with the benchmark's weights, then epoch 0 (call
        inside the program's float32 policy)."""
        loop = self.loop
        loop.init_state()
        with torch.no_grad():
            for name, tensor in loop.state.model.state_dict().items():
                if name in self.w0:
                    tensor.copy_(self.w0[name])
        loop.state.epoch = 0
        loop._train_epoch(0)

    def epoch(self, epoch: int):
        """The loop's epoch ``epoch``; before the last, a copy of the state
        that the reference goes on from."""
        loop = self.loop
        if epoch == self.last:
            opt = loop.state.opt_state
            self.start_of_last = (
                {k: p.detach().clone() for k, p in loop.state.params.items()},
                opt["mu"].detach().clone(), opt["nu"].detach().clone(),
                int(opt["count"]))
        loop.state.epoch = epoch
        loop._train_epoch(epoch)

    def first_steps(self) -> dict:
        """The checked steps of epoch 0 as the program ran them."""
        params, hook = self.loop.state.params, self.hook
        return {"losses": [float(x) for x in hook.losses[0]],
                "grad_norm": {k: v / (1 - 0.9) for k, v in
                              _leaf_norms(hook.first_moment, params).items()},
                "change_norm": {k: float((hook.params[0][k] - self.w0[k])
                                         .norm()) for k in params}}

    def window_steps(self) -> dict:
        """The checked steps of the window's last epoch."""
        start, after = self.start_of_last[0], self.hook.params[self.last]
        return {"losses": [float(x) for x in self.hook.losses[self.last]],
                "change_norm": {k: float((after[k] - start[k]).norm())
                                for k in start}}

    def reference(self, tf32: bool = False, rows: int = None) -> dict:
        """The reference's first three steps of epoch 0 from the seeded
        weights."""
        return reference_steps(self.run, self.volumes, self.w0, self.seed,
                               self.batch, 0, None, tf32, rows)

    def reference_window(self, tf32: bool = False, rows: int = None) -> dict:
        """The reference's first three steps of the last epoch from the
        program's state as that epoch began."""
        params, mu, nu, count = self.start_of_last
        w = dict(self.w0)
        w.update(params)
        state = (_leaves(mu, params), _leaves(nu, params), count)
        return reference_steps(self.run, self.volumes, w, self.seed,
                               self.batch, self.last, state, tf32, rows)

    def free(self):
        """Drop the program's loop (the copies the checks read stay)."""
        self.loop = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()


def drive(run) -> Outcome:
    from rcu_tpu_torch.eval.device import full_float32
    cell = TrainCell(run)
    run.mark("inputs and loop")
    with full_float32():
        cell.start()  # warm-up: the first checked steps and every shape
        run.mark("epoch 0")
        with run.window():
            for epoch in range(1, cell.last + 1):
                cell.epoch(epoch)
    per_epoch = len(cell.loader)
    steps = cell.last * per_epoch
    failed = sum(per_epoch for loss in cell.hook.epoch_losses[1:]
                 if not np.isfinite(loss))
    got, got_window = cell.first_steps(), cell.window_steps()
    work = {"train_flops": roofline.train_step_flops(
                cell.model, *cell.shape[1:], cell.batch) * steps,
            "peak_flops": roofline.PEAK_FLOPS[run.traffic["dtype"]]}
    slices = cell.last * len(cell.selected)
    cell.free()
    numbers = compare.train_gaps(got, cell.reference())
    numbers.update(compare.window_gaps(got_window, cell.reference_window()))
    return Outcome(values={"train_slices_per_s": slices / run.window_s},
                   attempted=steps, failed=failed, numbers=numbers,
                   work=work)


def reference_batches(volumes, seed, batch, steps, epoch, device) -> list:
    """The first ``steps`` batches of ``epoch``, by the documented order."""
    selected = [(s, z) for s, v in enumerate(volumes)
                for z in streams.none_black(v["images"])]
    order = streams.epoch_order(len(selected), seed, epoch)
    out = []
    for k in range(steps):
        rows = [selected[i] for i in order[k * batch:(k + 1) * batch]]
        x = np.stack([volumes[s]["images"][z] for s, z in rows])
        y = np.stack([volumes[s]["labels"][z] for s, z in rows])
        out.append((torch.from_numpy(x).to(device).permute(0, 3, 1, 2)
                    .contiguous(), torch.from_numpy(y).to(device)))
    return out


def reference_steps(run, volumes, w0, seed, batch, epoch, state, tf32=False,
                    rows=None) -> dict:
    """The reference's first three steps of ``epoch`` from the weights
    ``w0`` and Adam's ``state`` (None: fresh)."""
    model = run.config["model"]["unet"]
    lr = float(run.config["optimizer"]["adam"]["lr"])
    batches = reference_batches(volumes, seed, batch, CHECKED_STEPS, epoch,
                                run.device)
    gens = [streams.generator((seed, epoch, k), run.device)
            for k in range(CHECKED_STEPS)]
    with precision(tf32=tf32):
        ref = adam_steps(w0, batches, gens, model, lr,
                         1.0 - float(model["dropout"]), rows=rows,
                         state=state)
    return {"losses": ref["losses"],
            "grad_norm": {k: float(g.norm())
                          for k, g in ref["first_grad"].items()},
            "change_norm": {k: float(c.norm())
                            for k, c in ref["change"].items()}}
