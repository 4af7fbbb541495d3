"""Whole-volume and image-batch inference + eval reductions of every
strategy family (``rcu_tpu.eval.pipeline`` counterparts of the ``_*_scan``
helpers, ``_entropy_eval``, ``_confidence_eval``, the
``make_volume_*_eval_fn`` and ``make_image_batch_*_fn`` factories, with
``make_volume_mc_fn``).

PyTorch runs eagerly, so the JAX factories become plain functions: a
Python loop over the volume's slice batches, then one call of the fused
eval kernel per subject (``volume_*``); or, on native-2D datasets, one
batch of K same-shape images, then one call of the kernel for all K with
each image's own reductions, as the JAX programs vmap them
(``image_batch_*``: every result has a leading K axis, and an image is a
subject: its own confidence rescale, its own minmax bounds). Two
protocols feed the kernel:
- entropy (mc, deterministic, ensemble): the fg probability is the ECE
  plane, the entropy in bits the uncertainty plane, ``fg > 0.5`` the
  prediction;
- confidence (aleatoric, auxiliary_feat, auxiliary_segm): the family's
  confidence map rescaled (per subject, or by the run's global bounds for
  aleatoric) is the uncertainty plane, that folded by the prediction
  (``ops.prepare``) the ECE plane. Rescale and fold are plain tensor ops,
  as the JAX package computes them outside its kernel: the subject's min
  and max are needed before any voxel can be folded.

MC random stream: batch ``b`` of subject ``s`` draws sample ``t``'s dropout
masks from a ``torch.Generator`` seeded with
``SeedSequence([seed, s, b, t])`` (:func:`sample_generators`). The stream
is thus defined per (subject, batch, sample), whatever rides one forward.
An image batch is one batch named by its first image's offset in the run
(``rng=(seed, offset)``), as the JAX driver names a chunk's key.
It cannot equal flax's threefry stream; MC parity with the JAX package is
distributional.

Mesh (``mesh=``, a ``parallel.Mesh``; the JAX programs' latency mode):
each slice batch splits into contiguous parts over the mesh's data
devices (``parallel.Split``), each part runs on its device's copy of the
models (:func:`place`), and each device keeps the planes of its own
slices. The eval is one kernel launch per device on those planes, the
sums added on the first device (``parallel.inference``); the confidence
families take the global min and max over the devices before each
device rescales its planes. A part draws its rows of the whole batch's
dropout masks, so the MC stream does not depend on the mesh. The
per-voxel maps come back as ``parallel.Sharded`` values that
``eval.device.Fetch`` copies once per device and joins in slice order.
Ensembles on a 2-D mesh shard their members over the model axis
(``parallel.ensemble``).

Serving (``rcu_tpu_torch.serve``) reads the same forwards: each family's
loop over the slice batches lives in one ``_*_scan`` helper, which its
unscored function (``volume_mc``, ``volume_aleatoric``,
``volume_ensemble``, ``volume_aux_feat``, ``volume_aux_segm``: the
per-voxel artifacts only, the ``make_volume_*_fn`` programs) and its
scored one (``volume_*_eval``; ``artifacts=True`` adds the per-voxel maps
to the eval dict under the JAX programs' keys) share.
"""
from __future__ import annotations

import math

import torch

from rcu_tpu_torch.engine.steps import (aleatoric_forward, batch_generators,
                                        mc_forward, multi_prediction_summary,
                                        predict, to_model_layout)
from rcu_tpu_torch.ops import metrics, prepare
from rcu_tpu_torch.ops.cuda.evalstats import fused_subject_eval
from rcu_tpu_torch.parallel.ensemble import (ensemble_summary, member_sums,
                                             shard_members)
from rcu_tpu_torch.parallel.inference import sharded_subject_eval
from rcu_tpu_torch.parallel.mesh import Split, replicate
from rcu_tpu_torch.utils import profiling


def sample_generators(rng, batch_index: int, mc_steps: int, device,
                      rows=None):
    """One Generator per MC sample of batch ``batch_index``; ``rng`` is the
    tuple of ints that names the volume, e.g. ``(seed, subject_index)``;
    ``rows`` names a mesh device's part of the batch
    (``steps.batch_generators``)."""
    return batch_generators((*rng, batch_index), mc_steps, device, rows)


def place(strategy: str, models, mesh):
    """The models of a run, placed on ``mesh``'s data devices as the
    functions here take them there: per data device its copy of the
    model (``parallel.replicate``); for ``ensemble`` its rows of members
    (``parallel.ensemble.shard_members``, the model axis of a 2-D mesh);
    for ``auxiliary_feat`` the (segmenter, PostNet) copies. A mesh's
    latency mode."""
    if strategy == "ensemble":
        return shard_members(models, mesh)
    if strategy == "auxiliary_feat":
        return tuple(replicate(m, mesh.data_devices) for m in models)
    return replicate(models, mesh.data_devices)


def replicas(strategy: str, models, devices) -> list:
    """Per entry of ``devices``, its copy of ``models`` in the form one
    device takes them (``parallel.replicate``: a repeated device shares
    its copy): a mesh's throughput mode."""
    if strategy == "ensemble":
        copies = [replicate(m, devices) for m in models]
        return [[c[i] for c in copies] for i in range(len(devices))]
    if strategy == "auxiliary_feat":
        return list(zip(*(replicate(m, devices) for m in models)))
    return replicate(models, devices)


def _listed(x):
    """A per-device list of shards: one device's tensor is a list of one."""
    return x if isinstance(x, list) else [x]


def _each(fn, *shards):
    """``fn`` on each device's shards (None where a device holds none)."""
    return [None if xs[0] is None else fn(*xs) for xs in zip(*shards)]


def _split(n: int, batch_size: int, mesh, device) -> Split:
    return Split(n, batch_size,
                 (device,) if mesh is None else mesh.data_devices)


def _scan(split, columns, inputs: dict, step):
    """``step(models, parts, batch index, rows)`` on every device's part
    of every batch (``inputs``: row-aligned tensors; ``columns``: each
    device's models; ``rows``: the part's (start, stop, total) in its
    batch). -> per device, its outputs each concatenated over the batches
    (a list of None for a device with no rows)."""
    outs = [[] for _ in split.devices]
    for b, (lo, hi, parts) in enumerate(split.batches):
        for d, (a, c) in enumerate(parts):
            if c > a:
                device = split.devices[d]
                data = {k: v[a:c].to(device, non_blocking=True)
                        for k, v in inputs.items()}
                outs[d].append(step(columns[d], data, b,
                                    (a - lo, c - lo, hi - lo)))
    width = len(next(o for o in outs if o)[0])
    return [[torch.cat(col) for col in zip(*o)] if o else [None] * width
            for o in outs]


def _outputs(per_device):
    """Per device lists of outputs -> per output the list of shards."""
    return [list(shards) for shards in zip(*per_device)]


def _mc_scan(model, mc_steps: int, volume, batch_size: int, rng, mesh=None):
    """MC protocol over a volume's slice batches. ``volume`` (Z, H, W, C).

    Returns (the split, per-device (fg probability, entropy in nats) of
    its slices, each (z, H, W)). ``mc_steps=0`` is the deterministic
    protocol: the single weight-scaling forward is the probability map.
    With MC samples the weight-scaling forward of the JAX ``_mc_scan`` is
    not run: neither the eval nor the service's result reads its map."""
    split = _split(len(volume), batch_size, mesh, volume.device)

    def step(model, data, b, rows):
        images = data["images"]
        if mc_steps:
            gens = sample_generators(rng, b, mc_steps, images.device, rows)
            with profiling.span("pipeline.mc_forward"):
                samples = mc_forward(model, images, gens)
            summary = multi_prediction_summary(samples)
        else:
            probs = predict(model, images)
            summary = {"probabilities": probs,
                       "entropy": metrics.entropy(probs, dim=-1)}
        return summary["probabilities"][..., 1], summary["entropy"]

    return split, _scan(split, [model] if mesh is None else model,
                        {"images": volume}, step)


def _normalize_entropy(ent):
    """Entropy in bits, f32 / f32 like the JAX program's ``ent / log(2.0)``."""
    return ent / torch.tensor(math.log(2.0), dtype=torch.float32)


def _eval_row(fg, uncertainty, prediction, target, mask, thresholds,
              per_image=False):
    """One kernel pass: ECE bins on ``fg`` (masked), the threshold
    correction on ``uncertainty`` and the confusion row (both unmasked);
    with ``per_image``, a row for each image of the leading axis. Each
    plane is one device's tensor or a list of per-device shards (one
    launch per device, the sums added on the first). The planes are
    float32 whatever the models' compute dtype: the logits, sigma and
    confidence heads give f32."""
    fg, uncertainty, prediction, target = map(
        _listed, (fg, uncertainty, prediction, target))
    mask = _listed(mask) if mask is not None else [None] * len(fg)
    for name, planes in (("fg", fg), ("uncertainty", uncertainty)):
        for plane in planes:
            if plane is not None and plane.dtype != torch.float32:
                raise TypeError(f"the eval's {name} plane must be float32, "
                                f"got {plane.dtype}")
    if len(fg) == 1:
        bins, confusion, correction = fused_subject_eval(
            fg[0], target[0], prediction[0], uncertainty[0], mask[0],
            thresholds, per_image=per_image)
    else:
        bins, confusion, correction = sharded_subject_eval(
            [None if f is None else (f, t, p, u, m) for f, t, p, u, m
             in zip(fg, target, prediction, uncertainty, mask)],
            thresholds, per_image)
    return {**bins, "correction": correction,
            **{k: confusion[k] for k in ("dice", "tp", "tn", "fp", "fn", "n")}}


def _local_min_max(x, per_image):
    if per_image:
        dims = tuple(range(1, x.dim()))
        return torch.amin(x, dim=dims), torch.amax(x, dim=dims)
    return torch.min(x), torch.max(x)


def _combined(bounds, per_image):
    """Per-device (min, max) -> the map's (each image's) on the first."""
    if len(bounds) == 1:
        return bounds[0]
    home = bounds[0][0].device
    lo = [b[0].to(home) for b in bounds]
    hi = [b[1].to(home) for b in bounds]
    if per_image:
        return torch.cat(lo), torch.cat(hi)
    return torch.stack(lo).min(), torch.stack(hi).max()


def _aligned(shards, values):
    """``values`` (one per non-empty shard) aligned with ``shards``."""
    it = iter(values)
    return [None if s is None else next(it) for s in shards]


def _min_max(x, per_image):
    """The map's (min, max), or each image's; ``x`` a tensor or shards."""
    return _combined([_local_min_max(s, per_image) for s in _listed(x)
                      if s is not None], per_image)


def _entropy_eval(fg, ent, target, mask, thresholds, per_image=False):
    """The 'probabilities' protocol's eval row, plus the subject's fg
    min/max for the run minmax CSV."""
    conf_min, conf_max = _min_max(fg, per_image)
    prediction = _each(lambda f: f > 0.5, _listed(fg))
    return {**_eval_row(fg, ent, prediction, target, mask, thresholds,
                        per_image),
            "conf_min": conf_min, "conf_max": conf_max}


def _folded_eval(rescaled, prediction, target, mask, thresholds,
                 per_image=False):
    """Fold the rescaled map by the prediction; the folded map is the ECE
    plane, the rescaled one the uncertainty plane. -> (the eval row, the
    folded shards)."""
    folded = _each(prepare.uncertainty_to_foreground_probabilities,
                   _listed(rescaled), _listed(prediction))
    return _eval_row(folded, rescaled, prediction, target, mask, thresholds,
                     per_image), folded


def _confidence_eval(confidence, prediction, target, mask, thresholds,
                     per_image=False):
    """The 'confidence' protocol's eval row (auxiliary feat/segm): subject
    (with ``per_image``: image) min-max rescale, fold, one kernel pass; the
    run minmax CSV takes the RAW confidence's min/max. On a mesh the
    subject's bounds are the global ones over the devices."""
    confidence = _listed(confidence)
    local = [_local_min_max(c, per_image) for c in confidence
             if c is not None]
    conf_min, conf_max = _combined(local, per_image)
    if per_image:
        def rescale(c, bounds):
            view = (-1,) + (1,) * (c.dim() - 1)
            return prepare.rescale_linear(c, bounds[0].view(view),
                                          bounds[1].view(view))
        rescaled = _each(rescale, confidence, _aligned(confidence, local))
    else:
        rescaled = _each(lambda c: prepare.rescale_linear(
            c, conf_min.to(c.device), conf_max.to(c.device)), confidence)
    row, _ = _folded_eval(rescaled, prediction, target, mask, thresholds,
                          per_image)
    return {**row, "conf_min": conf_min, "conf_max": conf_max}


@torch.inference_mode()
def volume_mc_eval(model, mc_steps: int, batch_size: int, volume, target,
                   mask, thresholds, rng, per_image: bool = False,
                   artifacts: bool = False, mesh=None):
    """MC inference + eval reductions of one volume -> the eval dict.

    ``volume`` (Z, H, W, C) float32 or the model's compute dtype,
    ``target``/``mask`` (Z, H, W) bool or uint8, all on the model's device
    (with ``mesh``: anywhere, each device copies its rows; ``model`` then
    :func:`place`'s); ``rng`` names the volume's MC stream. With
    ``per_image`` each slice is an image with its own eval row.
    ``artifacts`` adds the per-voxel ``fg`` and ``entropy`` (bits),
    bitwise those of :func:`volume_mc` on the same stream."""
    split, outs = _mc_scan(model, mc_steps, volume, batch_size, rng, mesh)
    fg, ent = _outputs(outs)
    ent = _each(_normalize_entropy, ent)
    out = _entropy_eval(fg, ent, split.shards(target), split.shards(mask),
                        thresholds, per_image)
    if artifacts:
        out.update(fg=split.joined(fg), entropy=split.joined(ent))
    return out


@torch.inference_mode()
def volume_mc(model, mc_steps: int, batch_size: int, volume, rng, mesh=None):
    """Inference only: the per-voxel artifacts {fg, entropy, prediction},
    with the same MC stream as :func:`volume_mc_eval`. The JAX program
    also returns the weight-scaling map ``ws_fg`` (a 21st forward under
    MC), which its service never sends, so the port does not compute
    it."""
    split, outs = _mc_scan(model, mc_steps, volume, batch_size, rng, mesh)
    fg, ent = _outputs(outs)
    return {"fg": split.joined(fg),
            "entropy": split.joined(_each(_normalize_entropy, ent)),
            "prediction": split.joined(_each(lambda f: f > 0.5, fg))}


def _aleatoric_scan(model, is_log_sigma: bool, volume, batch_size: int,
                    mesh=None):
    """One deterministic forward per slice batch -> (the split, per device
    (softmax fg, prediction uint8, predicted-class sigma))."""
    split = _split(len(volume), batch_size, mesh, volume.device)

    def step(model, data, b, rows):
        probabilities, _, prediction, predicted_sigma = aleatoric_forward(
            model, data["images"], is_log_sigma)
        return (probabilities[..., 1], prediction.to(torch.uint8),
                predicted_sigma)

    return split, _scan(split, [model] if mesh is None else model,
                        {"images": volume}, step)


@torch.inference_mode()
def volume_sigma_minmax(model, batch_size: int, volume, is_log_sigma: bool,
                        per_image: bool = False, mesh=None):
    """Pass A of the aleatoric protocol: the subject's predicted-class
    sigma (min, max), its share of the run's global rescale bounds (with
    ``per_image``, each slice's)."""
    _, outs = _aleatoric_scan(model, is_log_sigma, volume, batch_size, mesh)
    return _min_max(_outputs(outs)[2], per_image)


@torch.inference_mode()
def volume_aleatoric_eval(model, batch_size: int, volume, target, mask,
                          thresholds, sigma_min, sigma_max,
                          is_log_sigma: bool, per_image: bool = False,
                          artifacts: bool = False, mesh=None):
    """Pass B: sigma rescaled by the run's f32 global bounds, folded, one
    kernel pass. No conf_min/conf_max: the minmax CSV holds pass A's.
    ``artifacts`` adds the ``prediction``, the raw predicted-class
    ``sigma`` and the folded ``confidence``."""
    split, outs = _aleatoric_scan(model, is_log_sigma, volume, batch_size,
                                  mesh)
    _, prediction, sigma = _outputs(outs)
    rescaled = _each(lambda s: prepare.rescale_linear(s, sigma_min,
                                                      sigma_max), sigma)
    out, folded = _folded_eval(rescaled, prediction, split.shards(target),
                               split.shards(mask), thresholds, per_image)
    if artifacts:
        out.update(prediction=split.joined(prediction),
                   sigma=split.joined(sigma), confidence=split.joined(folded))
    return out


@torch.inference_mode()
def volume_aleatoric(model, batch_size: int, volume, is_log_sigma: bool,
                     mesh=None):
    """Inference only (``make_volume_aleatoric_fn``): the softmax ``fg``,
    the ``prediction`` and the unrescaled predicted-class ``sigma``."""
    split, outs = _aleatoric_scan(model, is_log_sigma, volume, batch_size,
                                  mesh)
    return {k: split.joined(v) for k, v in
            zip(("fg", "prediction", "sigma"), _outputs(outs))}


def _ensemble_scan(members, volume, batch_size: int, mesh=None):
    """Member-mean softmax and its entropy
    (``parallel.ensemble.ensemble_summary``) per slice batch -> (the
    split, per device (fg, entropy in nats))."""
    split = _split(len(volume), batch_size, mesh, volume.device)
    columns = [[list(members)]] if mesh is None else members
    k = sum(len(row) for row in columns[0])

    def step(column, data, b, rows):
        out = ensemble_summary(member_sums(column, data["images"], predict), k)
        return out["probabilities"][..., 1], out["entropy"]

    return split, _scan(split, columns, {"images": volume}, step)


@torch.inference_mode()
def volume_ensemble_eval(members, batch_size: int, volume, target, mask,
                         thresholds, per_image: bool = False,
                         artifacts: bool = False, mesh=None):
    """Member-mean softmax, then the entropy protocol; ``artifacts`` adds
    the per-voxel ``fg`` and ``entropy`` (bits)."""
    split, outs = _ensemble_scan(members, volume, batch_size, mesh)
    fg, ent = _outputs(outs)
    ent = _each(_normalize_entropy, ent)
    out = _entropy_eval(fg, ent, split.shards(target), split.shards(mask),
                        thresholds, per_image)
    if artifacts:
        out.update(fg=split.joined(fg), entropy=split.joined(ent))
    return out


@torch.inference_mode()
def volume_ensemble(members, batch_size: int, volume, mesh=None):
    """Inference only (``make_volume_ensemble_fn``): the member-mean
    ``fg``, its ``entropy`` in bits and the ``prediction``."""
    split, outs = _ensemble_scan(members, volume, batch_size, mesh)
    fg, ent = _outputs(outs)
    return {"fg": split.joined(fg),
            "entropy": split.joined(_each(_normalize_entropy, ent)),
            "prediction": split.joined(_each(lambda f: f > 0.5, fg))}


def _aux_feat_scan(segmenter, postnet, volume, batch_size: int, mesh=None):
    """The frozen segmenter and the PostNet on its features per slice
    batch -> (the split, per device (the PostNet's softmax fg, the
    segmenter's argmax (of its logits) uint8))."""
    split = _split(len(volume), batch_size, mesh, volume.device)
    columns = [(segmenter, postnet)] if mesh is None \
        else list(zip(segmenter, postnet))

    def step(pair, data, b, rows):
        segm, post = pair
        out = segm(to_model_layout(data["images"], segm))
        return (torch.softmax(post(out.features).logits, dim=1)[:, 1],
                torch.argmax(out.logits, dim=1).to(torch.uint8))

    return split, _scan(split, columns, {"images": volume}, step)


@torch.inference_mode()
def volume_aux_feat_eval(segmenter, postnet, batch_size: int, volume, target,
                         mask, thresholds, per_image: bool = False,
                         artifacts: bool = False, mesh=None):
    """The frozen segmenter's argmax is the prediction, the PostNet's
    softmax fg on the segmenter's features the confidence; ``artifacts``
    adds both maps (``confidence``, ``prediction``)."""
    split, outs = _aux_feat_scan(segmenter, postnet, volume, batch_size,
                                 mesh)
    conf, pred = _outputs(outs)
    out = _confidence_eval(conf, pred, split.shards(target),
                           split.shards(mask), thresholds, per_image)
    if artifacts:
        out.update(confidence=split.joined(conf),
                   prediction=split.joined(pred))
    return out


@torch.inference_mode()
def volume_aux_feat(segmenter, postnet, batch_size: int, volume, mesh=None):
    """Inference only (``make_volume_aux_feat_fn``): the ``confidence``
    and the segmenter's ``prediction``."""
    split, outs = _aux_feat_scan(segmenter, postnet, volume, batch_size,
                                 mesh)
    conf, pred = _outputs(outs)
    return {"confidence": split.joined(conf),
            "prediction": split.joined(pred)}


def _aux_segm_scan(model, volume, baseline, batch_size: int, mesh=None):
    """The error net per slice batch over the images and the baseline
    prediction as a 5th channel (0/1, exact in the images' dtype) ->
    (the split, per device (its softmax fg,))."""
    split = _split(len(volume), batch_size, mesh, volume.device)

    def step(model, data, b, rows):
        images = data["images"]
        inputs = torch.cat([images, data["baseline"][..., None]
                            .to(images.dtype)], dim=-1)
        return (predict(model, inputs)[..., 1],)

    return split, _scan(split, [model] if mesh is None else model,
                        {"images": volume, "baseline": baseline}, step)


@torch.inference_mode()
def volume_aux_segm_eval(model, batch_size: int, volume, baseline, target,
                         mask, thresholds, per_image: bool = False,
                         artifacts: bool = False, mesh=None):
    """The error net's confidence; the baseline itself (uint8, (Z, H, W))
    is the prediction. ``artifacts`` adds ``confidence`` and the baseline
    passed through as ``prediction``."""
    split, outs = _aux_segm_scan(model, volume, baseline, batch_size, mesh)
    conf, = _outputs(outs)
    out = _confidence_eval(conf, split.shards(baseline), split.shards(target),
                           split.shards(mask), thresholds, per_image)
    if artifacts:
        out.update(confidence=split.joined(conf), prediction=baseline)
    return out


@torch.inference_mode()
def volume_aux_segm(model, batch_size: int, volume, baseline, mesh=None):
    """Inference only (``make_volume_aux_segm_fn``): the error net's
    ``confidence`` and the baseline passed through as ``prediction``."""
    split, outs = _aux_segm_scan(model, volume, baseline, batch_size, mesh)
    return {"confidence": split.joined(_outputs(outs)[0]),
            "prediction": baseline}


# ---------------------------------------------------------------------------
# native-2D: K same-shape images a call, each image's own eval row
# ---------------------------------------------------------------------------

@torch.inference_mode()
def image_batch_mc_eval(model, mc_steps: int, images, targets, masks,
                        thresholds, rng, mesh=None):
    """MC (``mc_steps=0``: deterministic) inference over K images in one
    batch, then each image's eval row (``make_image_batch_mc_eval_fn``).
    ``images`` (K, H, W, C), ``targets``/``masks`` (K, H, W) bool or uint8;
    ``rng`` names the batch's MC stream, ``(seed, offset of its first
    image)``. On a mesh the K images split over the data devices."""
    return volume_mc_eval(model, mc_steps, len(images), images, targets,
                          masks, thresholds, rng, per_image=True, mesh=mesh)


@torch.inference_mode()
def image_batch_ensemble_eval(members, images, targets, masks, thresholds,
                              mesh=None):
    """Member-mean softmax over K images, each image's entropy-protocol
    row (``make_image_batch_ensemble_eval_fn``)."""
    return volume_ensemble_eval(members, len(images), images, targets, masks,
                                thresholds, per_image=True, mesh=mesh)


@torch.inference_mode()
def image_batch_aux_feat_eval(segmenter, postnet, images, targets, masks,
                              thresholds, mesh=None):
    """Frozen segmenter + PostNet over K images, each image rescaled by its
    own confidence range (``make_image_batch_aux_feat_eval_fn``)."""
    return volume_aux_feat_eval(segmenter, postnet, len(images), images,
                                targets, masks, thresholds, per_image=True,
                                mesh=mesh)


@torch.inference_mode()
def image_batch_aux_segm_eval(model, images, baselines, targets, masks,
                              thresholds, mesh=None):
    """The error net over K images and their baselines, each image
    rescaled by its own confidence range
    (``make_image_batch_aux_segm_eval_fn``)."""
    return volume_aux_segm_eval(model, len(images), images, baselines,
                                targets, masks, thresholds, per_image=True,
                                mesh=mesh)


@torch.inference_mode()
def image_batch_sigma_minmax(model, images, is_log_sigma: bool, mesh=None):
    """Pass A over K images: each image's predicted-class sigma (min, max),
    (K,) each (``make_image_batch_sigma_minmax_fn``)."""
    return volume_sigma_minmax(model, len(images), images, is_log_sigma,
                               per_image=True, mesh=mesh)


@torch.inference_mode()
def image_batch_aleatoric_eval(model, images, targets, masks, thresholds,
                               sigma_min, sigma_max, is_log_sigma: bool,
                               mesh=None):
    """Pass B over K images: sigma rescaled by the run's global bounds,
    folded, each image's row (``make_image_batch_aleatoric_eval_fn``)."""
    return volume_aleatoric_eval(model, len(images), images, targets, masks,
                                 thresholds, sigma_min, sigma_max,
                                 is_log_sigma, per_image=True, mesh=mesh)
