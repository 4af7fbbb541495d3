"""The protocols' forwards and the train steps (``rcu_tpu.engine.steps``
counterparts).

Public layout is the JAX package's: NHWC images in, ``(..., classes)``
probabilities out (views over the NCHW compute, no copies). Models return
``models.unet.UNetOutput``.

A train step is a plain function ``(state, batch, generator) -> metrics``
(``engine.state.TrainState``; a batch of the loader's tensors on the
state's device): one forward in train mode with channel dropout drawn from
``generator``, the valid-masked loss, its backward and one optimizer
update. The metrics (``loss``, ``dice``: the batch's smooth dice) stay on
the device; the hooks fetch them at their cadence. Per-step randomness is
:func:`step_generator` of ``(seed, epoch, step)``, the port's analogue of
``fold_in(fold_in(key, epoch), step)``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from rcu_tpu_torch.ops import losses, metrics
from rcu_tpu_torch.parallel.ensemble import (ensemble_summary, member_sums,
                                             shard_ensemble_predict_fn)
from rcu_tpu_torch.parallel.mesh import mesh_predict, replicate

# training on a mesh and the JAX package's remat policies wait for their
# slices (ROADMAP.md queue 1 item 1b and queue 1 item 4); remat is a
# measured negative there
_LATER = ("{} is not ported to rcu_tpu_torch yet (ROADMAP.md queue 1, "
          "item 1b: training on a mesh; item 4: the remat policies)")


def to_model_layout(images, model):
    """NHWC images as the NCHW tensor that ``model`` takes, in the memory
    format its convolutions run fastest in: channels-last for a bf16 model
    (cuDNN's tensor-core convolutions read NHWC; an NCHW tensor costs a
    transpose on each side of each conv), NCHW for a float32 one."""
    fmt = torch.contiguous_format \
        if getattr(model, "dtype", torch.float32) == torch.float32 \
        else torch.channels_last
    return images.permute(0, 3, 1, 2).contiguous(memory_format=fmt)


def predict(model, images):
    """Deterministic softmax forward: (B, H, W, C) -> (B, H, W, classes)."""
    logits = model(to_model_layout(images, model)).logits
    return torch.softmax(logits, dim=1).permute(0, 2, 3, 1)


def mc_forward(model, images, generators):
    """The T stochastic forwards of the MC protocol, riding the batch dim.

    ``images`` (B, H, W, C); ``generators`` one ``torch.Generator`` per
    sample, on the images' device. Returns (T, B, H, W, classes).

    Where the model has a dropout-free encoder prefix
    (``mc_shared_blocks`` > 0, ``dropout_center < depth``), the prefix runs
    once on the B images and only its outputs are repeated for the T
    samples; the outputs equal those of the full T*B forward with the same
    generators."""
    x = to_model_layout(images, model)
    b, t = x.shape[0], len(generators)
    if getattr(model, "mc_shared_blocks", 0):
        pooled, skips = model.encode_shared(x)
        out = model.decode_rest(torch.cat([pooled] * t),
                                [torch.cat([s] * t) for s in skips],
                                generators)
    else:
        out = model(torch.cat([x] * t), generators)
    probs = torch.softmax(out.logits, dim=1)
    return probs.reshape((t, b) + probs.shape[1:]).permute(0, 1, 3, 4, 2)


def multi_prediction_summary(multi_probabilities):
    """Mean probabilities and predictive entropy over the leading sample axis."""
    probabilities = torch.mean(multi_probabilities, dim=0)
    return {"probabilities": probabilities,
            "entropy": metrics.entropy(probabilities, dim=-1)}


def aleatoric_forward(model, images, is_log_sigma: bool):
    """One deterministic forward of a sigma-headed model -> (probabilities
    (B, H, W, classes), sigma (B, H, W, classes), prediction (B, H, W)
    int64, predicted-class sigma (B, H, W)).

    sigma is ``exp`` of the head when it gives log-sigma, else its ``abs``.
    The prediction is the argmax of the softmax probabilities, not of the
    logits: two logits apart by less than the softmax resolves tie there,
    and a tie goes to class 0, as ``jnp.argmax`` gives it."""
    out = model(to_model_layout(images, model))
    probabilities = torch.softmax(out.logits, dim=1)
    sigma = torch.exp(out.sigma) if is_log_sigma else torch.abs(out.sigma)
    prediction = torch.argmax(probabilities, dim=1)
    predicted_sigma = torch.gather(sigma, 1, prediction[:, None])[:, 0]
    return (probabilities.permute(0, 2, 3, 1), sigma.permute(0, 2, 3, 1),
            prediction, predicted_sigma)


def seeded_generator(names, device) -> torch.Generator:
    """A generator on ``device`` seeded from the ints ``names`` through
    numpy's SeedSequence (nearby names give unrelated streams)."""
    words = np.random.SeedSequence(list(names)).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return g


def step_generator(seed: int, epoch: int, step: int, device) -> torch.Generator:
    """The dropout (and aleatoric noise) generator of one train step."""
    return seeded_generator((seed, epoch, step), device)


def _check_later(remat=None, mesh=None):
    if remat not in (None, "conv", "full"):
        raise ValueError(f"unknown remat policy '{remat}'; "
                         "choose None, 'conv' or 'full'")
    if remat is not None:
        raise NotImplementedError(_LATER.format(f"remat={remat!r}"))
    if mesh is not None:
        raise NotImplementedError(_LATER.format("training on a mesh"))


def _masked_mean(per_px: torch.Tensor, valid: torch.Tensor):
    """Mean over the pixels of the valid batch items; per_px (B, H, W),
    valid (B,)."""
    w = valid[:, None, None]
    return torch.sum(per_px * w) / (torch.sum(valid) * per_px.shape[1]
                                    * per_px.shape[2])


def _masked_ce(logits, labels, valid):
    return -_masked_mean(losses.ce_log_probs(logits, labels), valid)


@torch.no_grad()
def _batch_smooth_dice(logits, labels, valid):
    """Valid-masked smooth dice of the softmax probabilities (B, C, H, W)
    against the one-hot labels (B, H, W): the train score."""
    probs = torch.softmax(logits, dim=1)
    onehot = F.one_hot(labels.long(), logits.shape[1]).permute(0, 3, 1, 2) \
        .to(probs.dtype)
    w = valid[:, None, None, None]
    iflat = (probs * w).reshape(-1)
    tflat = (onehot * w).reshape(-1)
    intersection = torch.sum(iflat * tflat)
    return (2.0 * intersection + 1.0) / (torch.sum(iflat) + torch.sum(tflat)
                                         + 1.0)


def _update(state, loss, logits, target, valid) -> dict:
    loss.backward()
    state.step()
    return {"loss": loss.detach(),
            "dice": _batch_smooth_dice(logits.detach(), target, valid)}


def make_train_step(loss_kind: str = "ce", is_log_sigma: bool = False,
                    nb_samples: int = 10, remat: str = None, mesh=None):
    """The CE or aleatoric train step. ``'aleatoric'`` needs a sigma-headed
    model: its loss averages the softmax over ``nb_samples`` draws of
    Normal(logits, sigma), drawn from the step's generator after the
    dropout masks, or given as ``noise`` (``losses.aleatoric_log_probs``).
    ``remat`` and ``mesh`` raise ``NotImplementedError``."""
    if loss_kind not in ("ce", "aleatoric"):
        raise ValueError(f"unknown loss_kind '{loss_kind}'; "
                         "choose 'ce' or 'aleatoric'")
    _check_later(remat, mesh)

    def train_step(state, batch: dict, generator, noise=None) -> dict:
        model = state.model.train()
        out = model(to_model_layout(batch["images"], model), [generator])
        labels, valid = batch["labels"].long(), batch["valid"]
        if loss_kind == "aleatoric":
            loss = -_masked_mean(losses.aleatoric_log_probs(
                out.logits, out.sigma, labels, is_log_sigma, nb_samples,
                generator, noise), valid)
        else:
            loss = _masked_ce(out.logits, labels, valid)
        return _update(state, loss, out.logits, labels, valid)

    return train_step


def _aux_segm_inputs(batch):
    """auxiliary_segm: labels carry [gt, baseline prediction]; the model
    reads the images with the prediction appended as a channel. -> (gt,
    baseline, NHWC inputs)."""
    gt = batch["labels"][..., 0].long()
    baseline = batch["labels"][..., 1].long()
    inputs = torch.cat([batch["images"], baseline[..., None].float()], dim=-1)
    return gt, baseline, inputs


def make_auxiliary_train_step(segm_model=None, remat: str = None, mesh=None):
    """Train a confidence net on the segmenter's error mask. With
    ``segm_model`` (auxiliary_feat: a frozen U-Net with
    ``provide_features``, in eval mode) the batch runs through it without
    gradients, the PostNet reads its features and the target is
    ``argmax(logits) != labels``; without (auxiliary_segm) the model reads
    the images with the baseline prediction appended, and the target is
    ``baseline != gt``."""
    _check_later(remat, mesh)

    def train_step(state, batch: dict, generator) -> dict:
        model = state.model.train()
        if segm_model is not None:
            with torch.no_grad():
                segm_out = segm_model(to_model_layout(batch["images"],
                                                      segm_model))
            target = (torch.argmax(segm_out.logits, dim=1)
                      != batch["labels"].long()).long()
            inputs = segm_out.features
        else:
            gt, baseline, images = _aux_segm_inputs(batch)
            target = (baseline != gt).long()
            inputs = to_model_layout(images, model)
        out = model(inputs, [generator])
        valid = batch["valid"]
        return _update(state, _masked_ce(out.logits, target, valid),
                       out.logits, target, valid)

    return train_step


class ShardGenerators(list):
    """The generators of a forward on rows ``start:stop`` of a batch of
    ``total`` rows (``rows``), as a device of a mesh runs its part:
    dropout draws the whole batch's masks and keeps these rows, so a
    part's masks are bitwise those rows of the whole batch's, whatever
    the split (a shorter draw would not be: on a card the values depend
    on the draw's shape)."""

    def __init__(self, generators, rows):
        super().__init__(generators)
        self.rows = rows


def batch_generators(rng, mc_steps: int, device, rows=None):
    """One generator per MC sample of the batch that ``rng`` (a tuple of
    ints, e.g. ``(seed, batch index)``) names: sample ``t``'s from
    ``(*rng, t)``, the port's analogue of ``split(fold_in(key, i), T)``.
    ``rows=(start, stop, total)``: for a part of the batch on a mesh
    device (:class:`ShardGenerators`); the same seeds, so the
    stream does not depend on the mesh."""
    gens = [seeded_generator((*rng, t), device) for t in range(mc_steps)]
    return gens if rows is None else ShardGenerators(gens, rows)


def make_mc_predict_fn(mc_steps: int, mesh=None):
    """The MC protocol of a batch: ``predict(model, batch, rng)`` -> the
    mean probabilities and their entropy over ``mc_steps`` dropout
    forwards (:func:`mc_forward`, generators :func:`batch_generators` of
    ``rng``), and the weight-scaling forward's ``ws_probabilities``. On a
    ``mesh`` (``parallel.mesh.mesh_predict``) a part draws its rows of the
    whole batch's masks."""
    def predict_fn(model, batch, rows, rng):
        images = batch["images"]
        out = multi_prediction_summary(mc_forward(
            model, images,
            batch_generators(rng, mc_steps, images.device, rows)))
        out["ws_probabilities"] = predict(model, images)
        return out
    return mesh_predict(predict_fn, mesh)


def make_aleatoric_predict_fn(is_log_sigma: bool, mesh=None):
    """``predict(model, batch)`` -> softmax ``probabilities``, the per-class
    ``sigma_all`` and the predicted class's ``sigma``
    (:func:`aleatoric_forward`)."""
    def predict_fn(model, batch, rows):
        probabilities, sigma, _, predicted_sigma = aleatoric_forward(
            model, batch["images"], is_log_sigma)
        return {"probabilities": probabilities, "sigma_all": sigma,
                "sigma": predicted_sigma}
    return mesh_predict(predict_fn, mesh)


def make_ensemble_predict_fn(members, mesh=None):
    """The members' mean softmax and its entropy: ``predict(model, batch)``
    (``model`` unused: the members carry their weights), their softmax
    added in member order (``parallel.ensemble.member_sums``) before the
    division by K. On a mesh the members shard over its model axis
    (``parallel.ensemble.shard_ensemble_predict_fn``); on a 1-D mesh each
    data device holds every member."""
    if mesh is not None:
        return shard_ensemble_predict_fn(members, mesh)
    members = list(members)

    def predict_fn(model, batch):
        return ensemble_summary(member_sums([members], batch["images"],
                                            predict), len(members))
    return predict_fn


def make_predict_fn(mesh=None):
    """Deterministic softmax forward of a batch: ``predict(model, batch)``
    -> {probabilities}."""
    def predict_fn(model, batch, rows):
        return {"probabilities": predict(model, batch["images"])}
    return mesh_predict(predict_fn, mesh)


def make_auxiliary_feat_predict_fn(segm_model, mesh=None):
    """The frozen segmenter and the PostNet on its features:
    ``predict(post_model, batch)`` -> the PostNet's softmax
    (``probabilities``) and foreground column (``confidence``), the
    segmenter's softmax (``segm_probabilities``) and its argmax
    (``net_predictions``). On a mesh the segmenter is replicated here,
    and ``post_model`` is the PostNet's replicas."""
    segmenters = {} if mesh is None else dict(zip(
        mesh.data_devices, replicate(segm_model, mesh.data_devices)))

    def predict_fn(post_model, batch, rows):
        images = batch["images"]
        segmenter = segmenters.get(images.device, segm_model)
        segm_out = segmenter(to_model_layout(images, segmenter))
        segm_probabilities = torch.softmax(segm_out.logits, dim=1)
        confidence = torch.softmax(post_model(segm_out.features).logits, dim=1)
        return {"probabilities": confidence.permute(0, 2, 3, 1),
                "net_predictions": torch.argmax(segm_probabilities, dim=1),
                "segm_probabilities": segm_probabilities.permute(0, 2, 3, 1),
                "confidence": confidence[:, 1]}
    return mesh_predict(predict_fn, mesh)


def make_auxiliary_segm_predict_fn(mesh=None):
    """The error net over the images and the baseline prediction:
    ``predict(model, batch)`` -> {probabilities, confidence,
    baseline_prediction}."""
    def predict_fn(model, batch, rows):
        _, baseline, inputs = _aux_segm_inputs(batch)
        confidence = predict(model, inputs)
        return {"probabilities": confidence,
                "confidence": confidence[..., 1],
                "baseline_prediction": batch["labels"][..., 1]}
    return mesh_predict(predict_fn, mesh)
