"""The protocols' forwards and the train steps (``rcu_tpu.engine.steps``
counterparts).

Public layout is the JAX package's: NHWC images in, ``(..., classes)``
probabilities out (views over the NCHW compute, no copies). Models return
``models.unet.UNetOutput``.

A train step is called as ``(state, batch, generator) -> metrics``
(``engine.state.TrainState``; a batch of the loader's tensors on the
state's device, or, on a mesh, anywhere): one forward in train mode with
channel dropout drawn from ``generator``, the valid-masked loss, its
backward and one optimizer update (:class:`TrainStep`; on a mesh's data
axis :class:`MeshTrainStep`, the same result for the whole batch). The
metrics (``loss``, ``dice``: the batch's smooth dice) stay on the device;
the hooks fetch them at their cadence. Per-step randomness is
:func:`step_generator` of ``(seed, epoch, step)``, the port's analogue of
``fold_in(fold_in(key, epoch), step)``.
"""
from __future__ import annotations

import typing

import numpy as np
import torch
from torch.nn import functional as F

from rcu_tpu_torch.ops import losses, metrics
from rcu_tpu_torch.parallel import mesh as mesh_lib
from rcu_tpu_torch.parallel.ensemble import (ensemble_summary, member_sums,
                                             shard_ensemble_predict_fn)
from rcu_tpu_torch.parallel.mesh import mesh_predict, replicate

# the JAX package's remat policies wait for their slice (ROADMAP.md queue
# 1 item 4); remat is a measured negative there
_LATER = ("{} is not ported to rcu_tpu_torch yet (ROADMAP.md queue 1, "
          "item 4: the remat policies)")


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


def _check_later(remat=None):
    if remat not in (None, "conv", "full"):
        raise ValueError(f"unknown remat policy '{remat}'; "
                         "choose None, 'conv' or 'full'")
    if remat is not None:
        raise NotImplementedError(_LATER.format(f"remat={remat!r}"))


def _masked_sum(per_px: torch.Tensor, valid: torch.Tensor):
    """The sum over the pixels of the valid batch items; per_px (B, H, W),
    valid (B,)."""
    return torch.sum(per_px * valid[:, None, None])


def _valid_pixels(valid: torch.Tensor, h: int, w: int):
    """The pixels of the valid batch items: the masked mean's normalizer
    (the whole batch's, on a mesh)."""
    return torch.sum(valid) * h * w


def _masked_mean(per_px: torch.Tensor, valid: torch.Tensor):
    """Mean over the pixels of the valid batch items; per_px (B, H, W),
    valid (B,)."""
    return _masked_sum(per_px, valid) / _valid_pixels(valid, *per_px.shape[1:])


def _masked_ce(logits, labels, valid):
    return -_masked_mean(losses.ce_log_probs(logits, labels), valid)


@torch.no_grad()
def _dice_sums(logits, labels, valid):
    """The smooth dice's sums over the valid items: (intersection, sum of
    the softmax probabilities, sum of the one-hot labels), stacked; a
    mesh adds them over the parts."""
    probs = torch.softmax(logits, dim=1)
    onehot = F.one_hot(labels.long(), logits.shape[1]).permute(0, 3, 1, 2) \
        .to(probs.dtype)
    w = valid[:, None, None, None]
    iflat = (probs * w).reshape(-1)
    tflat = (onehot * w).reshape(-1)
    return torch.stack([torch.sum(iflat * tflat), torch.sum(iflat),
                        torch.sum(tflat)])


def _smooth_dice(sums):
    intersection, isum, tsum = sums.unbind()
    return (2.0 * intersection + 1.0) / (isum + tsum + 1.0)


def _batch_smooth_dice(logits, labels, valid):
    """Valid-masked smooth dice of the softmax probabilities (B, C, H, W)
    against the one-hot labels (B, H, W): the train score."""
    return _smooth_dice(_dice_sums(logits, labels, valid))


class PartSums(typing.NamedTuple):
    """What a train step's forward gives for its rows: the masked sum of
    the target's log probability (differentiable) and the dice sums."""
    log_prob_sum: torch.Tensor
    dice: torch.Tensor


def _part_sums(per_px, logits, target, valid) -> PartSums:
    return PartSums(_masked_sum(per_px, valid),
                    _dice_sums(logits.detach(), target, valid))


class TrainStep:
    """A train step ``(state, batch, generator[, noise]) -> metrics`` on
    one device (``state.model``'s): ``part(model, batch, generators,
    noise)`` runs the forward of a batch in train mode and gives its
    :class:`PartSums`; the loss is minus their log-probability sum over
    the batch's valid pixels, and one backward and one optimizer update
    follow. The metrics (``loss``, ``dice``: the batch's smooth dice) stay
    on the device. :func:`parallel.mesh.shard_train_step` runs the same
    ``part`` on each data device of a mesh (:class:`MeshTrainStep`)."""

    def __init__(self, part):
        self.part = part

    def __call__(self, state, batch: dict, generator, noise=None) -> dict:
        sums = self.part(state.model.train(), batch, [generator], noise)
        loss = -(sums.log_prob_sum
                 / _valid_pixels(batch["valid"], *batch["labels"].shape[1:3]))
        loss.backward()
        state.step()
        return {"loss": loss.detach(), "dice": _smooth_dice(sums.dice)}


class MeshTrainStep:
    """A :class:`TrainStep` on the data axis of ``mesh`` (JAX's GSPMD
    meaning, ``rcu_tpu.parallel.mesh.shard_train_step``): it computes what
    the single step computes on the whole batch.

    The batch (on the host or any device) splits into contiguous parts,
    one a data device (``parallel.mesh.split_batch``); each part runs on
    a train-mode copy of the model (``parallel.mesh.TrainReplicas``; the
    first is ``state.model``) in a thread of its own
    (``parallel.mesh.run_parts``). BatchNorm adds its sums over the parts
    (``models.unet.batch_norm_train``, ``parallel.mesh.all_sum``), so it
    normalizes with the whole batch's moments and updates its running
    statistics from them. A part's generator starts where the step's
    does and draws the whole batch's dropout masks and aleatoric noise,
    keeping its rows (:class:`ShardGenerators`). The parts' sums add in
    data-axis order on the first device, where the loss divides by the
    whole batch's valid pixels; one backward runs through every part,
    the parts' gradients add on the first device
    (``parallel.mesh.reduce_gradients``) and the optimizer updates once
    there; the copies take the new weights at the next step. In a
    process group every process is a block of rows of one global batch
    (``parallel.mesh.process_rows``), and the sums and the gradients are
    also all-reduced across the processes. One data device and no
    process group is the single step itself."""

    def __init__(self, step: TrainStep, mesh):
        self.step, self.mesh = step, mesh
        self.devices = mesh.data_devices
        self.replicas = mesh_lib.TrainReplicas(self.devices)

    def __call__(self, state, batch: dict, generator, noise=None) -> dict:
        home = self.devices[0]
        spread = mesh_lib.distributed()
        if len(self.devices) == 1 and not spread:
            batch = {k: v.to(home, non_blocking=True) for k, v in batch.items()}
            return self.step(state, batch, generator, noise)
        models = self.replicas(state.model)
        n = len(batch["valid"])
        bounds = mesh_lib.split_bounds(n, len(self.devices))
        if any(b <= a for a, b in bounds):
            raise ValueError(f"a batch of {n} rows on a {len(self.devices)}-"
                             "device data axis leaves a device without rows: "
                             "pad it (parallel.mesh.pad_batch_size_to_mesh)")
        offset, total = mesh_lib.process_rows(n)
        rows = [(offset + a, offset + b, total) for a, b in bounds]
        parts = mesh_lib.split_batch(batch, self.mesh)
        noises = [None if noise is None else noise[:, a:b].to(d)
                  for d, (a, b) in zip(self.devices, bounds)]
        generators = [_clone_generator(generator, d) for d in self.devices]

        def run(i):
            return self.step.part(models[i], parts[i],
                                  ShardGenerators([generators[i]], rows[i]),
                                  noises[i])

        sums = mesh_lib.run_parts(run, self.devices, rows, spread)
        log_prob_sum, dice = sums[0]
        for s in sums[1:]:
            log_prob_sum = log_prob_sum + s.log_prob_sum.to(home)
            dice = dice + s.dice.to(home)
        pixels = _valid_pixels(batch["valid"].to(home),
                               *batch["labels"].shape[1:3])
        with torch.no_grad():
            pixels = mesh_lib.all_reduce_sum(pixels)
        # this process's share of the loss: the processes' shares add up
        # to the global loss, as their gradients do
        (-(log_prob_sum / pixels)).backward()
        mesh_lib.reduce_gradients(models, spread)
        state.step()
        with torch.no_grad():
            loss = -(mesh_lib.all_reduce_sum(log_prob_sum.detach()) / pixels)
            dice = mesh_lib.all_reduce_sum(dice)
        return {"loss": loss, "dice": _smooth_dice(dice)}


def _clone_generator(generator, device) -> torch.Generator:
    """A generator on ``device`` in ``generator``'s state."""
    g = torch.Generator(device=device)
    g.set_state(generator.get_state())
    return g


def _aleatoric_noise(nb_samples, logits, generators):
    """The aleatoric loss's standard normal draws for a part's rows
    (``rows`` of :class:`ShardGenerators`: the whole batch's draw, these
    rows kept), or None: the single step draws them in
    ``losses.aleatoric_log_probs``."""
    rows = getattr(generators, "rows", None)
    if rows is None:
        return None
    start, stop, total = rows
    return torch.randn((nb_samples, total) + tuple(logits.shape[1:]),
                       generator=generators[0], device=logits.device,
                       dtype=logits.dtype)[:, start:stop]


def _on_mesh(step: TrainStep, mesh):
    return step if mesh is None else mesh_lib.shard_train_step(step, mesh)


def make_train_step(loss_kind: str = "ce", is_log_sigma: bool = False,
                    nb_samples: int = 10, remat: str = None, mesh=None):
    """The CE or aleatoric train step. ``'aleatoric'`` needs a sigma-headed
    model: its loss averages the softmax over ``nb_samples`` draws of
    Normal(logits, sigma), drawn from the step's generator after the
    dropout masks, or given as ``noise`` (``losses.aleatoric_log_probs``;
    the whole batch's on a mesh). With ``mesh`` the step runs on its data
    axis (:class:`MeshTrainStep`). ``remat`` raises
    ``NotImplementedError``."""
    if loss_kind not in ("ce", "aleatoric"):
        raise ValueError(f"unknown loss_kind '{loss_kind}'; "
                         "choose 'ce' or 'aleatoric'")
    _check_later(remat)

    def part(model, batch: dict, generators, noise=None) -> PartSums:
        out = model(to_model_layout(batch["images"], model), generators)
        labels, valid = batch["labels"].long(), batch["valid"]
        if loss_kind == "aleatoric":
            if noise is None:
                noise = _aleatoric_noise(nb_samples, out.logits, generators)
            per_px = losses.aleatoric_log_probs(
                out.logits, out.sigma, labels, is_log_sigma, nb_samples,
                generators[0], noise)
        else:
            per_px = losses.ce_log_probs(out.logits, labels)
        return _part_sums(per_px, out.logits, labels, valid)

    return _on_mesh(TrainStep(part), mesh)


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
    ``baseline != gt``. With ``mesh`` the step runs on its data axis
    (:class:`MeshTrainStep`), the frozen segmenter replicated on the data
    devices."""
    _check_later(remat)
    segmenters = {} if mesh is None or segm_model is None else dict(zip(
        mesh.data_devices, replicate(segm_model, mesh.data_devices)))

    def part(model, batch: dict, generators, noise=None) -> PartSums:
        if segm_model is not None:
            segmenter = segmenters.get(batch["images"].device, segm_model)
            with torch.no_grad():
                segm_out = segmenter(to_model_layout(batch["images"],
                                                     segmenter))
            target = (torch.argmax(segm_out.logits, dim=1)
                      != batch["labels"].long()).long()
            inputs = segm_out.features
        else:
            gt, baseline, images = _aux_segm_inputs(batch)
            target = (baseline != gt).long()
            inputs = to_model_layout(images, model)
        out = model(inputs, generators)
        return _part_sums(losses.ce_log_probs(out.logits, target), out.logits,
                          target, batch["valid"])

    return _on_mesh(TrainStep(part), mesh)


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
