"""Whole-volume and image-batch inference + eval reductions of every
strategy family (``rcu_tpu.eval.pipeline`` counterparts of the ``_*_scan``
helpers, ``_entropy_eval``, ``_confidence_eval``, the
``make_volume_*_eval_fn``, ``make_volume_*_fn`` and
``make_image_batch_*_fn`` factories).

:data:`FAMILIES` holds a :class:`Family` record for each name of
:data:`STRATEGIES` (``deterministic`` is ``mc`` with 0 samples): its
models, their placement, its forwards (a ``_*_scan`` helper: the loop
over the slice batches), its protocol and what its callers must know.
The direct eval (``eval.direct``) and the service
(``rcu_tpu_torch.serve``) call three entry points with a strategy name:
:func:`evaluate` (one item's eval dict; ``artifacts`` adds the per-voxel
maps), :func:`infer` (the maps only) and :func:`sigma_minmax`
(aleatoric's first pass).

PyTorch runs eagerly, so the JAX factories become plain functions: a
Python loop over the volume's slice batches, then one call of the fused
eval kernel per subject; or, on native-2D datasets (``per_image``), one
batch of K same-shape images, then one call of the kernel for all K with
each image's own reductions, as the JAX programs vmap them (every result
has a leading K axis, and an image is a subject: its own confidence
rescale, its own minmax bounds). Two protocols feed the kernel:
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
models (:meth:`Family.slots`), and each device keeps the planes of its
own slices. The eval is one kernel launch per device on those planes, the
sums added on the first device (``parallel.inference``); the confidence
families take the global min and max over the devices before each
device rescales its planes. A part draws its rows of the whole batch's
dropout masks, so the MC stream does not depend on the mesh. The
per-voxel maps come back as ``parallel.Sharded`` values that
``eval.device.Fetch`` copies once per device and joins in slice order.
Ensembles on a 2-D mesh shard their members over the model axis
(``parallel.ensemble``).
"""
from __future__ import annotations

import math
import typing

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


def _entropy_infer(maps):
    fg = maps["fg"]
    return {"fg": fg, "entropy": _each(_normalize_entropy, maps["entropy"]),
            "prediction": _each(lambda f: f > 0.5, fg)}


def _entropy_score(maps, labels, thresholds, per_image, bounds):
    maps = {"fg": maps["fg"],
            "entropy": _each(_normalize_entropy, maps["entropy"])}
    return _entropy_eval(maps["fg"], maps["entropy"], *labels, thresholds,
                         per_image), maps


def _subject_rescale_score(maps, labels, thresholds, per_image, bounds):
    return _confidence_eval(maps["confidence"], maps["prediction"], *labels,
                            thresholds, per_image), maps


def _global_rescale_score(maps, labels, thresholds, per_image, bounds):
    """No conf_min/conf_max: the run minmax CSV holds the first pass's
    (:func:`sigma_minmax`)."""
    prediction, sigma = maps["prediction"], maps["sigma"]
    rescaled = _each(lambda s: prepare.rescale_linear(s, *bounds), sigma)
    row, folded = _folded_eval(rescaled, prediction, *labels, thresholds,
                               per_image)
    return row, {"prediction": prediction, "sigma": sigma,
                 "confidence": folded}


# the strategy families' messages for a variant they refuse: the JAX direct
# eval's words, and the JAX service's
_FOLD_BN_REFUSED = (
    "fold_bn covers the deterministic single-forward protocols "
    "(deterministic/ensemble/aleatoric/auxiliary_*); the mc protocol samples "
    "dropout, which the load-time BN fold cannot commute with",
    "fold_bn covers the deterministic single-forward serving strategies "
    "(mc=0/ensemble/aleatoric/auxiliary_*); the mc protocol samples dropout, "
    "which the BN fold cannot commute with")
_INT8_REFUSED = (
    "quantize=True covers the mc/deterministic/ensemble protocols; strategy "
    "'{}' keeps the f32/bf16 paths",
    "quantize=True covers the mc/deterministic/ensemble serving strategies; "
    "'{}' keeps the f32/bf16 paths")


class Family(typing.NamedTuple):
    """A strategy family of :data:`FAMILIES`: what its models are, what
    its forwards give, which protocol scores them, and what its callers
    must know of it."""
    name: str
    # "model"; "members" (ensemble, a non-empty list); "pair" (the
    # segmenter with provide_features, the PostNet)
    holds: str
    # (models, data, batch_size, mesh, mc, rng, is_log_sigma) -> the
    # ``_*_scan`` helper's (split, per-device outputs)
    scan: typing.Callable
    outputs: tuple  # the names of the scan's outputs
    infer: typing.Callable  # maps -> the unscored artifacts
    # (maps, (target, mask) shards, thresholds, per_image, bounds) ->
    # (the eval dict, the scored artifacts)
    score: typing.Callable
    samples: bool = False   # draws ``mc`` MC-dropout samples
    # the sigma head: a sigma-headed model, ``is_log_sigma``, the run's
    # global bounds from a first pass (:func:`sigma_minmax`)
    sigma: bool = False
    baseline: bool = False  # reads the baseline, which is its prediction
    int8: bool = False      # int8 PTQ covers it

    def check(self, models):
        """Raise where ``models`` are not what the family runs."""
        if self.holds == "members":
            if isinstance(models, torch.nn.Module) or not models:
                raise TypeError(f"{self.name} takes a non-empty list of "
                                "members")
        elif self.holds == "pair":
            if isinstance(models, torch.nn.Module) or len(models) != 2 \
                    or not getattr(models[0], "provide_features", False):
                raise TypeError(f"{self.name} takes a (segmenter with "
                                "provide_features, PostNet) pair")
        elif not isinstance(models, torch.nn.Module):
            raise TypeError(f"{self.name} takes one model")
        elif self.sigma and not getattr(models, "sigma_out", False):
            raise ValueError(f"strategy '{self.name}' needs a sigma-headed "
                             "model")

    def check_variant(self, mc: int, fold_bn: bool, quantize: bool,
                      service: bool = False):
        """Raise where an inference variant does not cover the family: the
        load-time BN fold cannot commute with MC-dropout sampling, and
        int8 covers mc, deterministic and ensemble. The messages are the
        JAX direct eval's, or with ``service`` the JAX service's."""
        if fold_bn and self.samples and mc > 0:
            raise ValueError(_FOLD_BN_REFUSED[service])
        if quantize and not self.int8:
            raise ValueError(_INT8_REFUSED[service].format(self.name))

    def input_dtype(self, models) -> torch.dtype:
        """The dtype the images travel in: the compute dtype of the models
        that read them where they share one, else float32. A model's first
        op casts its input to its compute dtype, so casting on the host
        first is the same rounding and halves the bytes of the
        host-to-device copy under bf16."""
        readers = list(models) if self.holds == "members" \
            else models[:1] if self.holds == "pair" else [models]
        dtypes = {getattr(m, "dtype", torch.float32) for m in readers}
        return dtypes.pop() if len(dtypes) == 1 else torch.float32

    def slots(self, models, device, mesh=None, throughput: bool = False):
        """Where the items of a run (the requests of a service) go: per
        slot (its models, the device its tensors go to, the mesh its
        batches split over); item ``i`` takes slot ``i % len(slots)``.
        Without a mesh, one slot of ``models`` on ``device``. On a
        latency mesh, one slot of the models placed on its data devices
        (each device its copy, ``parallel.replicate``; an ensemble's rows
        of members over the model axis of a 2-D mesh,
        ``parallel.ensemble.shard_members``), whose tensors stay on the
        host (device None): each device copies its rows. In throughput
        mode a slot for each mesh device with its copy of the models (a
        repeated device shares its copy)."""
        if mesh is None:
            return [(models, device, None)]
        if throughput:
            if self.holds == "model":
                copies = replicate(models, mesh.devices)
            else:
                copies = [list(c) for c in zip(*(
                    replicate(m, mesh.devices) for m in models))]
            return [(c, d, None) for c, d in zip(copies, mesh.devices)]
        if self.holds == "members":
            placed = shard_members(models, mesh)
        elif self.holds == "pair":
            placed = tuple(replicate(m, mesh.data_devices) for m in models)
        else:
            placed = replicate(models, mesh.data_devices)
        return [(placed, None, mesh)]


_MC = Family(
    "mc", "model",
    lambda m, d, n, mesh, mc, rng, log_sigma: _mc_scan(
        m, mc, d["images"], n, rng, mesh),
    ("fg", "entropy"), _entropy_infer, _entropy_score, samples=True,
    int8=True)
FAMILIES = {family.name: family for family in (
    _MC, _MC._replace(name="deterministic", samples=False),
    Family("aleatoric", "model",
           lambda m, d, n, mesh, mc, rng, log_sigma: _aleatoric_scan(
               m, log_sigma, d["images"], n, mesh),
           ("fg", "prediction", "sigma"), dict, _global_rescale_score,
           sigma=True),
    Family("ensemble", "members",
           lambda m, d, n, mesh, *_: _ensemble_scan(m, d["images"], n, mesh),
           ("fg", "entropy"), _entropy_infer, _entropy_score, int8=True),
    Family("auxiliary_feat", "pair",
           lambda m, d, n, mesh, *_: _aux_feat_scan(*m, d["images"], n,
                                                    mesh),
           ("confidence", "prediction"), dict, _subject_rescale_score),
    Family("auxiliary_segm", "model",
           lambda m, d, n, mesh, *_: _aux_segm_scan(m, d["images"],
                                                    d["baseline"], n, mesh),
           ("confidence",), dict, _subject_rescale_score, baseline=True))}
STRATEGIES = tuple(FAMILIES)


def _maps(family, models, data, batch_size, mesh, mc, rng, is_log_sigma):
    """The family's forwards -> (the split, {map name: per-device
    shards})."""
    split, outs = family.scan(models, data, batch_size, mesh,
                              mc if family.samples else 0, rng, is_log_sigma)
    maps = dict(zip(family.outputs, _outputs(outs)))
    if family.baseline:
        maps["prediction"] = split.shards(data["baseline"])
    return split, maps


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@torch.inference_mode()
def evaluate(strategy: str, models, data: dict, batch_size: int, thresholds,
             *, mc: int = 0, rng=None, is_log_sigma: bool = False,
             bounds=None, per_image: bool = False, artifacts: bool = False,
             mesh=None) -> dict:
    """The family's inference and eval reductions of one item -> the eval
    dict (with ``per_image`` a row for each image of the leading axis).

    ``data``: ``images`` (Z, H, W, C) float32 or the models' compute
    dtype, ``target`` and ``mask`` (Z, H, W) bool or uint8 and, for
    auxiliary_segm, the ``baseline`` (uint8), all on the models' device
    (with ``mesh``: anywhere, each device copies its rows; ``models`` then
    :meth:`Family.slots`'). ``batch_size`` slices a forward; ``mc`` the MC
    samples and ``rng`` the item's MC stream (mc); ``is_log_sigma`` and
    ``bounds`` the run's global (sigma min, sigma max) (aleatoric).
    ``artifacts`` adds the per-voxel maps under the JAX programs' keys,
    bitwise those of :func:`infer` on the same stream (aleatoric: the
    ``prediction``, the raw ``sigma`` and the folded ``confidence``)."""
    family = FAMILIES[strategy]
    split, maps = _maps(family, models, data, batch_size, mesh, mc, rng,
                        is_log_sigma)
    labels = (split.shards(data["target"]), split.shards(data["mask"]))
    out, kept = family.score(maps, labels, thresholds, per_image, bounds)
    if artifacts:
        out.update({k: split.joined(v) for k, v in kept.items()})
    return out


@torch.inference_mode()
def infer(strategy: str, models, data: dict, batch_size: int, *, mc: int = 0,
          rng=None, is_log_sigma: bool = False, mesh=None) -> dict:
    """Inference only (the ``make_volume_*_fn`` programs): the per-voxel
    artifacts of :func:`evaluate`'s arguments without the labels. The
    entropy families give ``fg``, ``entropy`` (bits) and ``prediction``
    (the JAX program's weight-scaling map ``ws_fg``, a 21st forward under
    MC that its service never sends, is not computed); aleatoric ``fg``,
    ``prediction`` and the unrescaled predicted-class ``sigma``; the
    auxiliary families ``confidence`` and ``prediction`` (auxiliary_segm:
    the baseline passed through)."""
    family = FAMILIES[strategy]
    split, maps = _maps(family, models, data, batch_size, mesh, mc, rng,
                        is_log_sigma)
    return {k: split.joined(v) for k, v in family.infer(maps).items()}


@torch.inference_mode()
def sigma_minmax(model, batch_size: int, volume, is_log_sigma: bool,
                 per_image: bool = False, mesh=None):
    """The aleatoric protocol's first pass: the item's predicted-class
    sigma (min, max), its share of the run's global rescale bounds (with
    ``per_image``, each image's, (K,) each)."""
    _, outs = _aleatoric_scan(model, is_log_sigma, volume, batch_size, mesh)
    return _min_max(_outputs(outs)[2], per_image)
