"""Whole-volume MC-dropout inference + eval reductions
(``rcu_tpu.eval.pipeline`` counterparts of ``_mc_scan``, ``_entropy_eval``,
``make_volume_mc_eval_fn`` and ``make_volume_mc_fn``).

PyTorch runs eagerly, so the JAX factories become plain functions: a
Python loop over the volume's slice batches, then one call of the fused
eval kernel per subject.

MC random stream: batch ``b`` of subject ``s`` draws sample ``t``'s dropout
masks from a ``torch.Generator`` seeded with
``SeedSequence([seed, s, b, t])`` (:func:`sample_generators`). The stream
is thus defined per (subject, batch, sample), whatever rides one forward.
It cannot equal flax's threefry stream; MC parity with the JAX package is
distributional.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from rcu_tpu_torch.engine.steps import mc_forward, multi_prediction_summary, predict
from rcu_tpu_torch.ops import metrics
from rcu_tpu_torch.ops.cuda.evalstats import fused_subject_eval


def sample_generators(rng, batch_index: int, mc_steps: int, device):
    """One Generator per MC sample of batch ``batch_index``; ``rng`` is the
    tuple of ints that names the volume, e.g. ``(seed, subject_index)``."""
    gens = []
    for t in range(mc_steps):
        words = np.random.SeedSequence(
            [*rng, batch_index, t]).generate_state(2, np.uint32)
        g = torch.Generator(device=device)
        g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
        gens.append(g)
    return gens


def _mc_scan(model, mc_steps: int, volume, batch_size: int, rng,
             weight_scaling: bool = False):
    """MC protocol over a volume's slice batches. ``volume`` (Z, H, W, C).

    Returns per-slice (fg probability, entropy in nats, weight-scaling fg or
    None), each (Z, H, W). ``mc_steps=0`` is the deterministic protocol:
    the single weight-scaling forward is the probability map. Otherwise the
    weight-scaling forward runs only when ``weight_scaling`` asks for its
    output (the eval path never reads it)."""
    fg, ent, ws = [], [], []
    for b, start in enumerate(range(0, volume.shape[0], batch_size)):
        images = volume[start:start + batch_size]
        if mc_steps:
            gens = sample_generators(rng, b, mc_steps, volume.device)
            summary = multi_prediction_summary(mc_forward(model, images, gens))
            if weight_scaling:
                ws.append(predict(model, images)[..., 1])
        else:
            probs = predict(model, images)
            summary = {"probabilities": probs,
                       "entropy": metrics.entropy(probs, dim=-1)}
            ws.append(probs[..., 1])
        fg.append(summary["probabilities"][..., 1])
        ent.append(summary["entropy"])
    return (torch.cat(fg), torch.cat(ent),
            torch.cat(ws) if ws else None)


def _normalize_entropy(ent):
    """Entropy in bits, f32 / f32 like the JAX program's ``ent / log(2.0)``."""
    return ent / torch.tensor(math.log(2.0), dtype=torch.float32)


def _as_u8(x):
    """A 0/1 plane as uint8 without a copy where it is a bool tensor."""
    if x.dtype == torch.bool:
        return x.contiguous().view(torch.uint8)
    if x.dtype != torch.uint8:
        raise TypeError(f"expected a bool or uint8 plane, got {x.dtype}")
    return x.contiguous()


def _entropy_eval(fg, ent, target, mask, thresholds):
    """The 'probabilities' protocol's eval reductions in one kernel pass:
    ECE bins on the fg map (masked), the threshold correction on the
    normalized entropy and the confusion row (both unmasked), plus the
    subject's fg min/max for the run minmax CSV."""
    prediction = fg > 0.5
    bins, confusion, correction = fused_subject_eval(
        fg.contiguous(), _as_u8(target), _as_u8(prediction), ent.contiguous(),
        None if mask is None else _as_u8(mask), thresholds)
    return {**bins, "dice": correction["dice"][0], "correction": correction,
            **{k: confusion[k] for k in ("tp", "tn", "fp", "fn", "n")},
            "conf_min": torch.min(fg), "conf_max": torch.max(fg)}


@torch.inference_mode()
def volume_mc_eval(model, mc_steps: int, batch_size: int, volume, target,
                   mask, thresholds, rng):
    """MC inference + eval reductions of one volume -> the eval dict.

    ``volume`` (Z, H, W, C) float32, ``target``/``mask`` (Z, H, W) bool or
    uint8, all on the model's device; ``rng`` names the volume's MC stream."""
    fg, ent, _ = _mc_scan(model, mc_steps, volume, batch_size, rng)
    return _entropy_eval(fg, _normalize_entropy(ent), target, mask, thresholds)


@torch.inference_mode()
def volume_mc(model, mc_steps: int, batch_size: int, volume, rng):
    """Inference only: the per-voxel artifacts {fg, entropy, ws_fg,
    prediction}, with the same MC stream as :func:`volume_mc_eval`."""
    fg, ent, ws_fg = _mc_scan(model, mc_steps, volume, batch_size, rng,
                              weight_scaling=True)
    return {"fg": fg, "entropy": _normalize_entropy(ent), "ws_fg": ws_fg,
            "prediction": fg > 0.5}
