"""The eval reductions over a mesh (``rcu_tpu.parallel.inference``
counterpart): one launch of the hand-written eval kernel
(``ops.cuda.evalstats.fused_eval_stats``) per data-axis device on that
device's voxels, then the launches' int64 count rows and float64
confidence sums added in device order on the mesh's first device.

The JAX package pads the flattened voxels to a multiple of the mesh and
gives the padding weight 0. The port's kernel weighs the bins only (its
confusion and threshold counts take every voxel), so a padded voxel would
count in ``tn``: the voxels are split instead into contiguous shards of
unequal size (``torch.tensor_split``), and nothing is padded. The counts
are then exact against one launch over the whole subject; the float64
sums differ only in their order of addition.
"""
from __future__ import annotations

import torch

from rcu_tpu_torch.eval.kernels import _fg
from rcu_tpu_torch.ops.cuda import evalstats


def sharded_eval_stats(shards, thresholds, per_image: bool = False) -> dict:
    """``fused_eval_stats``' sums of a subject held as ``shards``: per
    device, its five planes ``(fg, target, prediction, uncertainty,
    mask)`` or None where it holds no voxels. One launch per shard; the
    sums added in shard order on the first shard's device (with
    ``per_image``, each shard's images' rows joined in order)."""
    stats = [evalstats.fused_eval_stats(
        *evalstats.kernel_planes(*planes), thresholds, per_image)
        for planes in shards if planes is not None]
    home = stats[0]["tp"].device
    if per_image:
        return {k: torch.cat([s[k].to(home) for s in stats])
                for k in stats[0]}
    out = {}
    for k in stats[0]:
        total = stats[0][k]
        for s in stats[1:]:
            total = total + s[k].to(home)
        out[k] = total
    return out


def sharded_subject_eval(shards, thresholds, per_image: bool = False):
    """``(bins, confusion, correction)`` of
    ``evalstats.fused_subject_eval`` from :func:`sharded_eval_stats`."""
    return evalstats.subject_eval_from_stats(
        sharded_eval_stats(shards, thresholds, per_image))


def shard_voxels(mesh, arrays: dict) -> dict:
    """Flatten same-voxel-count arrays (a ``probabilities`` array keeps a
    trailing class axis of at most 2: (N, C)) and split them into
    contiguous shards, one per data-axis device, on that device: name ->
    list of shards (None where a device gets no voxel)."""
    devices = mesh.data_devices
    flats, sizes = {}, set()
    for name, arr in arrays.items():
        t = torch.as_tensor(arr)
        if name.endswith("probabilities") and t.dim() > 1 \
                and t.shape[-1] <= 2:
            flat = t.reshape(-1, t.shape[-1])
        else:
            flat = t.reshape(-1)
        flats[name] = flat
        sizes.add(flat.shape[0])
    if len(sizes) != 1:
        raise ValueError(f"arrays disagree on voxel count: {sorted(sizes)}")
    return {name: [part.to(d, non_blocking=True) if len(part) else None
                   for d, part in zip(devices,
                                      torch.tensor_split(flat, len(devices)))]
            for name, flat in flats.items()}


class ShardedSubjectEval:
    """The offline eval's per-subject reductions (``eval.kernels``: the
    same results and semantics) with the voxels split over the mesh's
    data axis. Every method takes the unflattened per-subject arrays
    (tensors or numpy)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def _shards(self, arrays, planes):
        sh = shard_voxels(self.mesh, arrays)
        return [None if sh["target"][d] is None else planes(
            {k: v[d] for k, v in sh.items()})
            for d in range(len(self.mesh.data_devices))]

    def calibration_bins(self, probabilities, target, prediction,
                         mask=None) -> dict:
        arrays = {"probabilities": probabilities, "target": target,
                  "prediction": prediction}
        if mask is not None:
            arrays["mask"] = mask

        def planes(s):
            fg = _fg(s["probabilities"])
            return fg, s["target"], s["prediction"], fg, s.get("mask")

        bins, confusion, _ = sharded_subject_eval(
            self._shards(arrays, planes), ())
        return {**bins, **confusion}

    def ece_dice_confusion(self, probabilities, target, prediction,
                           mask=None) -> dict:
        out = self.calibration_bins(probabilities, target, prediction, mask)
        return {k: out[k] for k in ("ece", "dice", "tp", "tn", "fp", "fn",
                                    "n")}

    def correction_eval(self, prediction, target, uncertainty,
                        thresholds) -> dict:
        def planes(s):
            u = s["uncertainty"]
            return u, s["target"], s["prediction"], u, None

        _, _, correction = sharded_subject_eval(self._shards(
            {"prediction": prediction, "target": target,
             "uncertainty": uncertainty}, planes), thresholds)
        return correction

    def min_max(self, x) -> dict:
        parts = [p for p in shard_voxels(self.mesh, {"x": x})["x"]
                 if p is not None]
        home = parts[0].device
        lo, hi = zip(*(torch.aminmax(p) for p in parts))
        return {"min": torch.stack([v.to(home) for v in lo]).min(),
                "max": torch.stack([v.to(home) for v in hi]).max()}
