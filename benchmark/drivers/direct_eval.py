"""The direct eval: ``rcu_tpu_torch.eval.direct.evaluate_subjects`` over
seeded in-memory items, the way a researcher evaluates a test split.

The configuration's ``data`` names the dataset: BraTS-like volumes (an
item is a subject, a pool of ``eval_pool`` volumes cycled, each item its
own MC stream) or ISIC-like images (an item is a chunk of ``batch_size``
images out of a pool of ``eval_pool``, each image a CSV row). The traffic
names the protocol (``strategy``, ``mc``), the compute dtype, the fast
decoder, the batch and the thresholds.

Set-up makes the weights (seeded, calibrated by the reference), the
program's model in the cell's variant and the data; a short call over
``warmup_items`` items warms up every shape (the full batch and the tail
batch) and the reader's pipeline. The window is one call over a fixed
number of items: ``--seconds`` times the traffic's ``items_per_s`` (a
rate measured once on the card), the same work for every seed. Afterwards
the rows that call wrote are read back from its CSVs, and a sample of its
items drawn from the seed is recomputed by the reference.
"""
from __future__ import annotations

import csv
import glob
import math
import os

import numpy as np
import torch
from torch.nn import functional as F

from benchmark import compare, inputs, roofline
from benchmark.harness import Outcome
from benchmark.reference import evalrows, streams
from benchmark.reference.unet import forward, precision

RUN_ID = "bench"


def program_model(model: dict, traffic: dict, weights: dict, device):
    """The program's U-Net of the configuration in the cell's variant,
    with the benchmark's weights, as its loader builds one."""
    from rcu_tpu_torch.models import (FAST_DECODER_KWARGS, get_model,
                                      precast_params)
    record = dict(model)
    if traffic["dtype"] != "float32":
        record["dtype"] = traffic["dtype"]
    if traffic.get("fast_decoder"):
        record.update(FAST_DECODER_KWARGS)
    net = get_model("unet", record)
    missing, unexpected = net.load_state_dict(
        {k: v.cpu() for k, v in weights.items()}, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise KeyError(f"weights do not fit the model: {missing} "
                       f"{unexpected}")
    return precast_params(net).to(device)


class Items:
    """The cell's data and how its items map onto it."""

    def __init__(self, run):
        data, device = run.config["data"], run.device
        self.kind = data["kind"]
        self.shape = tuple(data["shape"])
        self.batch = int(run.traffic["batch_size"])
        self.transform = None
        if self.kind == "brats_volumes":
            volumes = inputs.brats_volumes(int(data["eval_pool"]), self.shape,
                                           int(data["channels"]), run.seed,
                                           device)
            self.pool = inputs.VolumePool(
                volumes, [], os.path.join(run.scratch, "t2"))
            # the 8 middle slices and the first, empty one
            mid = self.shape[0] // 2
            picks = [0] + list(range(mid - 4, mid + 4))
            calib = volumes[0]["images"][picks]
            self.background = torch.from_numpy(
                ~volumes[0]["head"][picks]).to(device)
            self.rows_per_item = 1
        else:
            from rcu_tpu_torch.engine.config import ParametricNode
            from rcu_tpu_torch.engine.databuild import build_transform
            images = inputs.isic_images(int(data["eval_pool"]), self.shape,
                                        run.seed, device)
            self.pool = inputs.ImagePool(images, [])
            self.transform = build_transform(
                ParametricNode.parse_list(data["transform"]))
            calib = inputs.rescaled(images["images"][:8])
            self.background = None
            self.rows_per_item = self.batch
        self.calibration = torch.from_numpy(
            np.ascontiguousarray(calib.transpose(0, 3, 1, 2))).to(device)
        self.voxels_per_row = int(np.prod(self.shape))

    def names(self, n_items: int) -> list:
        rows = n_items * self.rows_per_item
        if self.kind == "brats_volumes":
            return [f"subject_{k:05d}" for k in range(rows)]
        return [f"ISIC_{k:07d}" for k in range(rows)]

    def dataset(self, names: list):
        if self.kind == "brats_volumes":
            return self.pool.named(names)
        return inputs.ImagePool(self.pool.data, names)


def _rows(out_dir: str, thresholds) -> dict:
    """{subject: row} of the CSVs a call wrote."""
    def table(pattern):
        (path,) = glob.glob(os.path.join(out_dir, pattern))
        with open(path, newline="") as f:
            return {r["subject_name"]: r for r in csv.DictReader(f)}

    ece = table(f"eval_ece_{RUN_ID}.csv")
    calib = table(f"eval_calibration_{RUN_ID}.csv")
    corr = [table(f"eval_uncertainty_{RUN_ID}_th"
                  f"{f'{th:.2f}'.replace('.', '')}.csv") for th in thresholds]
    rows = {}
    for name, r in ece.items():
        rows[name] = {
            "ece": float(r["ece"]), "dice": float(r["dice"]),
            **{k: int(r[k]) for k in ("tp", "tn", "fp", "fn", "n")},
            "bins_count": [int(float(calib[name][f"bins_count_{i:02d}"]))
                           for i in range(evalrows.N_BINS)],
            "uncertain": [[int(c[name][k]) for k in ("tpu", "tnu", "fpu",
                                                      "fnu")] for c in corr]}
    return rows


@torch.no_grad()
def _reference_probs(w, depth, images, mc, keep, names):
    """The sum over the MC samples (or the one forward) of the softmax of
    the images (N, H, W, C) on the device, one batch, the samples'
    generators named ``names + (t,)``."""
    x = images.permute(0, 3, 1, 2).contiguous()
    if not mc:
        return F.softmax(forward(w, x, depth), 1).double(), 1
    total = 0
    for t in range(mc):
        masks = streams.Masks(streams.generator(names + (t,), x.device), keep)
        total = total + F.softmax(forward(w, x, depth, masks, keep),
                                  1).double()
    return total, mc


def reference_rows(run, items, weights, names, picks) -> dict:
    """The reference's rows of the items ``picks`` (indices into the
    window's item list)."""
    model, traffic, device = run.config["model"]["unet"], run.traffic, \
        run.device
    depth, keep = int(model["depth"]), 1.0 - float(model["dropout"])
    mc = int(traffic["mc"]) if traffic["strategy"] == "mc" else 0
    thresholds, refs = traffic["thresholds"], {}
    for item in picks:
        if items.kind == "brats_volumes":
            name = names[item]
            volume = items.pool.volumes[item % len(items.pool.volumes)]
            images = torch.from_numpy(volume["images"]).to(device)
            probs = torch.cat([
                _reference_probs(w=weights, depth=depth,
                                 images=images[lo:lo + items.batch], mc=mc,
                                 keep=keep,
                                 names=(run.seed, item, b))[0]
                for b, lo in enumerate(range(0, len(images), items.batch))])
            fg, ent = evalrows.mc_summary(probs, max(mc, 1))
            target = torch.from_numpy(volume["labels"] > 0).to(device)
            mask = torch.from_numpy(volume["head"]).to(device)
            refs[name] = evalrows.eval_row(fg, ent, target, mask, thresholds)
            continue
        chunk = names[item * items.batch:(item + 1) * items.batch]
        index = [k % len(items.pool.data["images"])
                 for k in range(item * items.batch, (item + 1) * items.batch)]
        images = torch.from_numpy(inputs.rescaled(
            items.pool.data["images"][index])).to(device)
        labels = inputs.rescaled(items.pool.data["labels"][index]) > 0.5
        probs, n = _reference_probs(weights, depth, images, mc, keep,
                                    (run.seed, item * items.batch, 0))
        fg, ent = evalrows.mc_summary(probs, max(n, 1))
        for k, name in enumerate(chunk):
            refs[name] = evalrows.eval_row(
                fg[k], ent[k], torch.from_numpy(labels[k]).to(device),
                torch.ones_like(fg[k], dtype=torch.bool), thresholds)
    return refs


class EvalCell:
    """A cell's set-up: its items, the seeded weights, the program's model
    and the call of the timed path."""

    def __init__(self, run):
        self.run, traffic = run, run.traffic
        self.model = run.config["model"]["unet"]
        self.items = Items(run)
        self.weights = inputs.weights(self.model, run.seed, run.device,
                                      self.items.calibration,
                                      self.items.background)
        self.net = program_model(self.model, traffic, self.weights,
                                 run.device)
        self.thresholds = tuple(float(t) for t in traffic["thresholds"])
        self.mc = int(traffic["mc"]) if traffic["strategy"] == "mc" else 0

    def call(self, n_items: int, tag: str, net=None):
        """``evaluate_subjects`` over the first ``n_items`` items -> (the
        item list's row names, the directory of its CSVs)."""
        from rcu_tpu_torch.eval.direct import evaluate_subjects
        run, items = self.run, self.items
        names = items.names(n_items)
        out = os.path.join(run.scratch, tag)
        evaluate_subjects(self.net if net is None else net,
                          items.dataset(names), out,
                          strategy=run.traffic["strategy"], run_id=RUN_ID,
                          mc=self.mc, batch_size=items.batch, seed=run.seed,
                          thresholds=self.thresholds,
                          masked=run.config["data"]["masked"],
                          device=run.device, transform=items.transform)
        return names, out

    def rows(self, out: str) -> dict:
        return _rows(out, self.thresholds)

    def reference(self, names, picks, tf32: bool = False) -> dict:
        with precision(tf32=tf32):
            return reference_rows(self.run, self.items, self.weights, names,
                                  picks)

    def free(self):
        self.net = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()


def drive(run) -> Outcome:
    cell = EvalCell(run)
    items, traffic = cell.items, run.traffic
    run.mark("inputs and model")
    # every shape (the full batch and a volume's tail batch) and the
    # pipeline's depth (2 read ahead, 2 in flight) before the window
    cell.call(int(traffic["warmup_items"]), "warm-up")
    run.mark("warm-up")
    # a fixed amount of work: the items that fill --seconds at the rate
    # the traffic names, the same for every seed
    n_items = max(2, int(round(run.seconds * float(traffic["items_per_s"]))))
    with run.window():
        names, out = cell.call(n_items, "window")
    rows = cell.rows(out)
    failed = sum(1 for name in names if name not in rows
                 or not math.isfinite(rows[name]["ece"]))
    images = n_items * items.rows_per_item
    forwards = images * max(cell.mc, 1) \
        * (items.shape[0] if items.kind == "brats_volumes" else 1)
    work = {"conv_flops": roofline.unet_forward_flops(
                cell.model, *items.shape[-2:]) * forwards,
            "peak_flops": roofline.PEAK_FLOPS[traffic["dtype"]],
            "evalstats_bytes": roofline.evalstats_bytes(
                images * items.voxels_per_row)}
    cell.free()
    picks = np.random.default_rng([run.seed, 1]).choice(
        n_items, size=min(int(traffic["check_items"]), n_items), replace=False)
    refs = cell.reference(names, sorted(picks))
    return Outcome(
        values={"eval_voxels_per_s": images * items.voxels_per_row
                / run.window_s},
        attempted=len(names), failed=failed,
        numbers=compare.eval_gaps(rows, refs), work=work)
