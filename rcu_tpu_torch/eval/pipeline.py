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
                                        ensemble_probabilities, mc_forward,
                                        multi_prediction_summary, predict,
                                        to_model_layout)
from rcu_tpu_torch.ops import metrics, prepare
from rcu_tpu_torch.ops.cuda.evalstats import fused_subject_eval


def _slice_batches(volume, batch_size):
    return [volume[start:start + batch_size]
            for start in range(0, volume.shape[0], batch_size)]


def sample_generators(rng, batch_index: int, mc_steps: int, device):
    """One Generator per MC sample of batch ``batch_index``; ``rng`` is the
    tuple of ints that names the volume, e.g. ``(seed, subject_index)``."""
    return batch_generators((*rng, batch_index), mc_steps, device)


def _mc_scan(model, mc_steps: int, volume, batch_size: int, rng):
    """MC protocol over a volume's slice batches. ``volume`` (Z, H, W, C).

    Returns per-slice (fg probability, entropy in nats), each (Z, H, W).
    ``mc_steps=0`` is the deterministic protocol: the single
    weight-scaling forward is the probability map. With MC samples the
    weight-scaling forward of the JAX ``_mc_scan`` is not run: neither the
    eval nor the service's result reads its map."""
    fg, ent = [], []
    for b, images in enumerate(_slice_batches(volume, batch_size)):
        if mc_steps:
            gens = sample_generators(rng, b, mc_steps, volume.device)
            summary = multi_prediction_summary(mc_forward(model, images, gens))
        else:
            probs = predict(model, images)
            summary = {"probabilities": probs,
                       "entropy": metrics.entropy(probs, dim=-1)}
        fg.append(summary["probabilities"][..., 1])
        ent.append(summary["entropy"])
    return torch.cat(fg), torch.cat(ent)


def _normalize_entropy(ent):
    """Entropy in bits, f32 / f32 like the JAX program's ``ent / log(2.0)``."""
    return ent / torch.tensor(math.log(2.0), dtype=torch.float32)


def _eval_row(fg, uncertainty, prediction, target, mask, thresholds,
              per_image=False):
    """One kernel pass: ECE bins on ``fg`` (masked), the threshold
    correction on ``uncertainty`` and the confusion row (both unmasked);
    with ``per_image``, a row for each image of the leading axis. The
    planes are float32 whatever the models' compute dtype: the logits,
    sigma and confidence heads give f32."""
    for name, plane in (("fg", fg), ("uncertainty", uncertainty)):
        if plane.dtype != torch.float32:
            raise TypeError(f"the eval's {name} plane must be float32, got "
                            f"{plane.dtype}")
    bins, confusion, correction = fused_subject_eval(
        fg, target, prediction, uncertainty, mask, thresholds,
        per_image=per_image)
    return {**bins, "correction": correction,
            **{k: confusion[k] for k in ("dice", "tp", "tn", "fp", "fn", "n")}}


def _min_max(x, per_image):
    """The map's (min, max), or each image's."""
    if per_image:
        dims = tuple(range(1, x.dim()))
        return torch.amin(x, dim=dims), torch.amax(x, dim=dims)
    return torch.min(x), torch.max(x)


def _entropy_eval(fg, ent, target, mask, thresholds, per_image=False):
    """The 'probabilities' protocol's eval row, plus the subject's fg
    min/max for the run minmax CSV."""
    conf_min, conf_max = _min_max(fg, per_image)
    return {**_eval_row(fg, ent, fg > 0.5, target, mask, thresholds,
                        per_image),
            "conf_min": conf_min, "conf_max": conf_max}


def _folded_eval(rescaled, prediction, target, mask, thresholds,
                 per_image=False):
    """Fold the rescaled map by the prediction; the folded map is the ECE
    plane, the rescaled one the uncertainty plane. -> (the eval row, the
    folded map)."""
    folded = prepare.uncertainty_to_foreground_probabilities(rescaled,
                                                             prediction)
    return _eval_row(folded, rescaled, prediction, target, mask, thresholds,
                     per_image), folded


def _confidence_eval(confidence, prediction, target, mask, thresholds,
                     per_image=False):
    """The 'confidence' protocol's eval row (auxiliary feat/segm): subject
    (with ``per_image``: image) min-max rescale, fold, one kernel pass; the
    run minmax CSV takes the RAW confidence's min/max."""
    conf_min, conf_max = _min_max(confidence, per_image)
    if per_image:
        view = (-1,) + (1,) * (confidence.dim() - 1)
        rescaled = prepare.rescale_linear(confidence, conf_min.view(view),
                                          conf_max.view(view))
    else:
        rescaled = prepare.rescale_subject_min_max(confidence)
    row, _ = _folded_eval(rescaled, prediction, target, mask, thresholds,
                          per_image)
    return {**row, "conf_min": conf_min, "conf_max": conf_max}


@torch.inference_mode()
def volume_mc_eval(model, mc_steps: int, batch_size: int, volume, target,
                   mask, thresholds, rng, per_image: bool = False,
                   artifacts: bool = False):
    """MC inference + eval reductions of one volume -> the eval dict.

    ``volume`` (Z, H, W, C) float32 or the model's compute dtype,
    ``target``/``mask`` (Z, H, W) bool or uint8, all on the model's device;
    ``rng`` names the volume's MC stream. With ``per_image`` each slice is
    an image with its own eval row. ``artifacts`` adds the per-voxel
    ``fg`` and ``entropy`` (bits), bitwise those of :func:`volume_mc` on
    the same stream."""
    fg, ent = _mc_scan(model, mc_steps, volume, batch_size, rng)
    ent = _normalize_entropy(ent)
    out = _entropy_eval(fg, ent, target, mask, thresholds, per_image)
    if artifacts:
        out.update(fg=fg, entropy=ent)
    return out


@torch.inference_mode()
def volume_mc(model, mc_steps: int, batch_size: int, volume, rng):
    """Inference only: the per-voxel artifacts {fg, entropy, prediction},
    with the same MC stream as :func:`volume_mc_eval`. The JAX program
    also returns the weight-scaling map ``ws_fg`` (a 21st forward under
    MC), which its service never sends, so the port does not compute
    it."""
    fg, ent = _mc_scan(model, mc_steps, volume, batch_size, rng)
    return {"fg": fg, "entropy": _normalize_entropy(ent),
            "prediction": fg > 0.5}


def _aleatoric_scan(model, is_log_sigma: bool, volume, batch_size: int):
    """One deterministic forward per slice batch -> (softmax fg, prediction
    uint8, predicted-class sigma), each (Z, H, W)."""
    fg, pred, sigma = [], [], []
    for images in _slice_batches(volume, batch_size):
        probabilities, _, prediction, predicted_sigma = aleatoric_forward(
            model, images, is_log_sigma)
        fg.append(probabilities[..., 1])
        pred.append(prediction.to(torch.uint8))
        sigma.append(predicted_sigma)
    return torch.cat(fg), torch.cat(pred), torch.cat(sigma)


@torch.inference_mode()
def volume_sigma_minmax(model, batch_size: int, volume, is_log_sigma: bool,
                        per_image: bool = False):
    """Pass A of the aleatoric protocol: the subject's predicted-class
    sigma (min, max), its share of the run's global rescale bounds (with
    ``per_image``, each slice's)."""
    _, _, sigma = _aleatoric_scan(model, is_log_sigma, volume, batch_size)
    return _min_max(sigma, per_image)


@torch.inference_mode()
def volume_aleatoric_eval(model, batch_size: int, volume, target, mask,
                          thresholds, sigma_min, sigma_max,
                          is_log_sigma: bool, per_image: bool = False,
                          artifacts: bool = False):
    """Pass B: sigma rescaled by the run's f32 global bounds, folded, one
    kernel pass. No conf_min/conf_max: the minmax CSV holds pass A's.
    ``artifacts`` adds the ``prediction``, the raw predicted-class
    ``sigma`` and the folded ``confidence``."""
    _, prediction, sigma = _aleatoric_scan(model, is_log_sigma, volume,
                                           batch_size)
    rescaled = prepare.rescale_linear(sigma, sigma_min, sigma_max)
    out, folded = _folded_eval(rescaled, prediction, target, mask,
                               thresholds, per_image)
    if artifacts:
        out.update(prediction=prediction, sigma=sigma, confidence=folded)
    return out


@torch.inference_mode()
def volume_aleatoric(model, batch_size: int, volume, is_log_sigma: bool):
    """Inference only (``make_volume_aleatoric_fn``): the softmax ``fg``,
    the ``prediction`` and the unrescaled predicted-class ``sigma``."""
    fg, prediction, sigma = _aleatoric_scan(model, is_log_sigma, volume,
                                            batch_size)
    return {"fg": fg, "prediction": prediction, "sigma": sigma}


def _ensemble_scan(members, volume, batch_size: int):
    """Member-mean softmax (``steps.ensemble_probabilities``) per slice
    batch -> (fg, entropy in nats), each (Z, H, W)."""
    fg, ent = [], []
    for images in _slice_batches(volume, batch_size):
        probabilities = ensemble_probabilities(members, images)
        fg.append(probabilities[..., 1])
        ent.append(metrics.entropy(probabilities, dim=-1))
    return torch.cat(fg), torch.cat(ent)


@torch.inference_mode()
def volume_ensemble_eval(members, batch_size: int, volume, target, mask,
                         thresholds, per_image: bool = False,
                         artifacts: bool = False):
    """Member-mean softmax, then the entropy protocol; ``artifacts`` adds
    the per-voxel ``fg`` and ``entropy`` (bits)."""
    fg, ent = _ensemble_scan(members, volume, batch_size)
    ent = _normalize_entropy(ent)
    out = _entropy_eval(fg, ent, target, mask, thresholds, per_image)
    if artifacts:
        out.update(fg=fg, entropy=ent)
    return out


@torch.inference_mode()
def volume_ensemble(members, batch_size: int, volume):
    """Inference only (``make_volume_ensemble_fn``): the member-mean
    ``fg``, its ``entropy`` in bits and the ``prediction``."""
    fg, ent = _ensemble_scan(members, volume, batch_size)
    return {"fg": fg, "entropy": _normalize_entropy(ent),
            "prediction": fg > 0.5}


def _aux_feat_scan(segmenter, postnet, volume, batch_size: int):
    """The frozen segmenter and the PostNet on its features per slice
    batch -> (the PostNet's softmax fg, the segmenter's argmax (of its
    logits) uint8), each (Z, H, W)."""
    conf, pred = [], []
    for images in _slice_batches(volume, batch_size):
        out = segmenter(to_model_layout(images, segmenter))
        pred.append(torch.argmax(out.logits, dim=1).to(torch.uint8))
        conf.append(torch.softmax(postnet(out.features).logits, dim=1)[:, 1])
    return torch.cat(conf), torch.cat(pred)


@torch.inference_mode()
def volume_aux_feat_eval(segmenter, postnet, batch_size: int, volume, target,
                         mask, thresholds, per_image: bool = False,
                         artifacts: bool = False):
    """The frozen segmenter's argmax is the prediction, the PostNet's
    softmax fg on the segmenter's features the confidence; ``artifacts``
    adds both maps (``confidence``, ``prediction``)."""
    conf, pred = _aux_feat_scan(segmenter, postnet, volume, batch_size)
    out = _confidence_eval(conf, pred, target, mask, thresholds, per_image)
    if artifacts:
        out.update(confidence=conf, prediction=pred)
    return out


@torch.inference_mode()
def volume_aux_feat(segmenter, postnet, batch_size: int, volume):
    """Inference only (``make_volume_aux_feat_fn``): the ``confidence``
    and the segmenter's ``prediction``."""
    conf, pred = _aux_feat_scan(segmenter, postnet, volume, batch_size)
    return {"confidence": conf, "prediction": pred}


def _aux_segm_scan(model, volume, baseline, batch_size: int):
    """The error net per slice batch over the images and the baseline
    prediction as a 5th channel (0/1, exact in the images' dtype) -> its
    softmax fg (Z, H, W)."""
    conf = []
    for images, base in zip(_slice_batches(volume, batch_size),
                            _slice_batches(baseline, batch_size)):
        inputs = torch.cat([images, base[..., None].to(images.dtype)], dim=-1)
        conf.append(predict(model, inputs)[..., 1])
    return torch.cat(conf)


@torch.inference_mode()
def volume_aux_segm_eval(model, batch_size: int, volume, baseline, target,
                         mask, thresholds, per_image: bool = False,
                         artifacts: bool = False):
    """The error net's confidence; the baseline itself (uint8, (Z, H, W))
    is the prediction. ``artifacts`` adds ``confidence`` and the baseline
    passed through as ``prediction``."""
    conf = _aux_segm_scan(model, volume, baseline, batch_size)
    out = _confidence_eval(conf, baseline, target, mask, thresholds,
                           per_image)
    if artifacts:
        out.update(confidence=conf, prediction=baseline)
    return out


@torch.inference_mode()
def volume_aux_segm(model, batch_size: int, volume, baseline):
    """Inference only (``make_volume_aux_segm_fn``): the error net's
    ``confidence`` and the baseline passed through as ``prediction``."""
    return {"confidence": _aux_segm_scan(model, volume, baseline, batch_size),
            "prediction": baseline}


# ---------------------------------------------------------------------------
# native-2D: K same-shape images a call, each image's own eval row
# ---------------------------------------------------------------------------

@torch.inference_mode()
def image_batch_mc_eval(model, mc_steps: int, images, targets, masks,
                        thresholds, rng):
    """MC (``mc_steps=0``: deterministic) inference over K images in one
    batch, then each image's eval row (``make_image_batch_mc_eval_fn``).
    ``images`` (K, H, W, C), ``targets``/``masks`` (K, H, W) bool or uint8;
    ``rng`` names the batch's MC stream, ``(seed, offset of its first
    image)``."""
    return volume_mc_eval(model, mc_steps, len(images), images, targets,
                          masks, thresholds, rng, per_image=True)


@torch.inference_mode()
def image_batch_ensemble_eval(members, images, targets, masks, thresholds):
    """Member-mean softmax over K images, each image's entropy-protocol
    row (``make_image_batch_ensemble_eval_fn``)."""
    return volume_ensemble_eval(members, len(images), images, targets, masks,
                                thresholds, per_image=True)


@torch.inference_mode()
def image_batch_aux_feat_eval(segmenter, postnet, images, targets, masks,
                              thresholds):
    """Frozen segmenter + PostNet over K images, each image rescaled by its
    own confidence range (``make_image_batch_aux_feat_eval_fn``)."""
    return volume_aux_feat_eval(segmenter, postnet, len(images), images,
                                targets, masks, thresholds, per_image=True)


@torch.inference_mode()
def image_batch_aux_segm_eval(model, images, baselines, targets, masks,
                              thresholds):
    """The error net over K images and their baselines, each image
    rescaled by its own confidence range
    (``make_image_batch_aux_segm_eval_fn``)."""
    return volume_aux_segm_eval(model, len(images), images, baselines,
                                targets, masks, thresholds, per_image=True)


@torch.inference_mode()
def image_batch_sigma_minmax(model, images, is_log_sigma: bool):
    """Pass A over K images: each image's predicted-class sigma (min, max),
    (K,) each (``make_image_batch_sigma_minmax_fn``)."""
    return volume_sigma_minmax(model, len(images), images, is_log_sigma,
                               per_image=True)


@torch.inference_mode()
def image_batch_aleatoric_eval(model, images, targets, masks, thresholds,
                               sigma_min, sigma_max, is_log_sigma: bool):
    """Pass B over K images: sigma rescaled by the run's global bounds,
    folded, each image's row (``make_image_batch_aleatoric_eval_fn``)."""
    return volume_aleatoric_eval(model, len(images), images, targets, masks,
                                 thresholds, sigma_min, sigma_max,
                                 is_log_sigma, per_image=True)
