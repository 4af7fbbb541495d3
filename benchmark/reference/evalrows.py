"""The MC summary and the eval rows of one item, in plain PyTorch.

For each voxel: the foreground probability ``fg`` (the mean over the MC
samples of the softmax, or the one forward's), its predictive entropy in
bits, the prediction ``fg > 0.5``. For the item: the reliability bins of
``fg`` over the masked voxels (ten bins, edges ``linspace(0, 1 + 1e-8,
11)`` as ``numpy.digitize`` places them), the ECE weighted by the bins'
shares, the confusion counts and the Dice over all voxels, and for each
uncertainty threshold ``th`` the counts of tp, tn, fp and fn voxels whose
entropy exceeds ``th`` (the paper's uncertainty-error analysis).
"""
from __future__ import annotations

import math

import torch

N_BINS = 10


def mc_summary(probs_sum, n_samples: int):
    """(fg, entropy in bits) from the sum over samples of the (N, 2, H, W)
    softmax."""
    mean = (probs_sum / n_samples).double()
    plogp = torch.where(mean > 0, mean * torch.log(mean.clamp_min(1e-300)),
                        torch.zeros((), dtype=mean.dtype, device=mean.device))
    entropy = -plogp.sum(1) / math.log(2.0)
    return mean[:, 1], entropy


def eval_row(fg, entropy, target, mask, thresholds) -> dict:
    """The row of one item: ``fg`` and ``entropy`` float64, ``target`` and
    ``mask`` bool, all of one shape; counts are ints."""
    fg, entropy = fg.reshape(-1), entropy.reshape(-1)
    target, mask = target.reshape(-1).bool(), mask.reshape(-1).bool()
    edges = torch.linspace(0.0, 1.0 + 1e-8, N_BINS + 1, dtype=torch.float64,
                           device=fg.device)[1:]
    ids = (fg[:, None] >= edges[None, :]).sum(1).clamp(0, N_BINS - 1)
    ids, p, t = ids[mask], fg[mask], target[mask]
    count = torch.bincount(ids, minlength=N_BINS)
    conf = torch.bincount(ids, weights=p, minlength=N_BINS)
    true = torch.bincount(ids[t], minlength=N_BINS)
    nonzero = count > 0
    safe = count.clamp_min(1).double()
    gap = torch.where(nonzero, (conf - true.double()) / safe, 0.0).abs()
    ece = float((gap * count.double()).sum() / count.sum())
    prediction = fg > 0.5
    target = target.reshape(-1)
    classes = {"tp": target & prediction, "tn": ~target & ~prediction,
               "fp": ~target & prediction, "fn": target & ~prediction}
    row = {k: int(v.sum()) for k, v in classes.items()}
    tp, fp, fn = row["tp"], row["fp"], row["fn"]
    row["dice"] = 2.0 * tp / (2 * tp + fp + fn) if 2 * tp + fp + fn \
        else float("nan")
    row["ece"] = ece
    row["n"] = int(fg.numel())
    row["bins_count"] = [int(c) for c in count]
    # the program compares float32 entropies with float32 thresholds
    u = entropy.float()
    row["uncertain"] = [
        [int((m & (u > torch.tensor(th, dtype=torch.float32,
                                          device=u.device))).sum())
         for m in classes.values()] for th in thresholds]
    return row
