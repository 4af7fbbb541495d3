"""The direct eval of the 2-D Swin UNETR: ``rcu_tpu_torch.eval.direct.
evaluate_subjects`` over seeded BraTS-like subjects, the way a researcher
evaluates a test split with a Swin transformer segmenter. The items, the
call and the reading of its CSVs are the U-Net's (``direct_eval``); the
model, its seeded weights and the plain reference are Swin UNETR's
(``reference.swin_unetr``), and the work counted from shapes is its shared
prefix's FLOPs an image and the rest's a sample (``swinunetr_flops``),
which the readers multiply by the program's counters ``swinunetr.images``
and ``swinunetr.samples``.

Set-up builds the program's model first (a program without Swin UNETR
fails here, at once), then the data, the seeded weights calibrated by the
reference, and warms up as ``direct_eval`` does. After the window the
reference recomputes the items drawn from the seed: T full forwards a
32-slice batch, every sample's masks drawn from its own generator in the
sites' order, as the program's shared prefix must reproduce.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from benchmark import compare, inputs, roofline, swinunetr_flops
from benchmark.drivers.direct_eval import EvalCell, Items
from benchmark.harness import Outcome
from benchmark.reference import evalrows, streams, swin_unetr
from benchmark.reference.unet import precision


@torch.no_grad()
def _reference_probs(w, cfg, images, mc, names):
    """The sum over the MC samples of the softmax of the images (N, H, W,
    C) on the device, one batch, the samples' generators named ``names +
    (t,)``."""
    x = images.permute(0, 3, 1, 2).contiguous()
    total = 0
    for t in range(mc):
        masks = swin_unetr.Masks(streams.generator(names + (t,), x.device))
        total = total + F.softmax(swin_unetr.forward(w, x, cfg, masks),
                                  1).double()
    return total


class SwinUNETRCell(EvalCell):
    """:class:`direct_eval.EvalCell` with the configuration's Swin UNETR."""

    def __init__(self, run):
        from rcu_tpu_torch.models import get_model
        self.run, traffic = run, run.traffic
        self.model = run.config["model"]["swin_unetr"]
        if traffic["strategy"] != "mc" or traffic["dtype"] != "float32":
            raise ValueError("the Swin UNETR cells run the f32 mc protocol")
        net = get_model("swin_unetr", self.model)
        self.items = Items(run)
        self.weights = swin_unetr.seeded_weights(
            self.model, inputs.generator(run.seed, inputs.WEIGHTS,
                                         run.device), run.device)
        with precision():
            swin_unetr.calibrate(self.weights, self.items.calibration,
                                 self.model, background=self.items.background)
        net.load_state_dict({k: v.cpu() for k, v in self.weights.items()})
        self.net = net.to(run.device)
        self.thresholds = tuple(float(t) for t in traffic["thresholds"])
        self.mc = int(traffic["mc"])

    def reference(self, names, picks, tf32: bool = False) -> dict:
        """The reference's rows of the subjects ``picks`` (indices into
        the window's item list)."""
        run, items, refs = self.run, self.items, {}
        with precision(tf32=tf32):
            for item in picks:
                volume = items.pool.volumes[item % len(items.pool.volumes)]
                images = torch.from_numpy(volume["images"]).to(run.device)
                probs = torch.cat([
                    _reference_probs(self.weights, self.model,
                                     images[lo:lo + items.batch], self.mc,
                                     (run.seed, item, b))
                    for b, lo in enumerate(range(0, len(images),
                                                 items.batch))])
                fg, ent = evalrows.mc_summary(probs, self.mc)
                target = torch.from_numpy(volume["labels"] > 0).to(run.device)
                mask = torch.from_numpy(volume["head"]).to(run.device)
                refs[names[item]] = evalrows.eval_row(fg, ent, target, mask,
                                                      self.thresholds)
        return refs


def drive(run) -> Outcome:
    cell = SwinUNETRCell(run)
    items, traffic = cell.items, run.traffic
    run.mark("inputs and model")
    # every shape (the full batch and a volume's tail batch) and the
    # pipeline's depth (2 read ahead, 2 in flight) before the window
    cell.call(int(traffic["warmup_items"]), "warm-up")
    run.mark("warm-up")
    # a fixed amount of work: the subjects that fill --seconds at the rate
    # the traffic names, the same for every seed
    n_items = max(2, int(round(run.seconds * float(traffic["items_per_s"]))))
    with run.window():
        names, out = cell.call(n_items, "window")
    rows = cell.rows(out)
    failed = sum(1 for name in names if name not in rows
                 or not math.isfinite(rows[name]["ece"]))
    h, w = items.shape[-2:]
    work = {"swinunetr_shared_flops": swinunetr_flops.shared_flops(
                cell.model, h, w),
            "swinunetr_sample_flops": swinunetr_flops.sample_flops(
                cell.model, h, w),
            "peak_flops": roofline.PEAK_FLOPS[traffic["dtype"]]}
    cell.free()
    picks = np.random.default_rng([run.seed, 1]).choice(
        n_items, size=min(int(traffic["check_items"]), n_items), replace=False)
    refs = cell.reference(names, sorted(picks))
    return Outcome(
        values={"eval_voxels_per_s": n_items * items.voxels_per_row
                / run.window_s},
        attempted=len(names), failed=failed,
        numbers=compare.eval_gaps(rows, refs), work=work)
