"""The numbers that decide ``correct``: how far what the timed path produced
lies from the plain reference, each held to its limit
(``benchmark/limits/<cell>.json``).

Eval cells, over the sampled items (a BraTS subject, an ISIC image):
- ``ece_gap``: the largest |ECE - reference ECE|;
- ``dice_gap``: the largest |Dice - reference Dice|;
- ``count_gap``: the largest difference of any count of the row (the
  confusion counts, the ten bin counts, the 4 x 11 uncertainty-error
  counts) as a share of the item's voxels.

Training cells, over the first three steps:
- ``loss_gap``: the largest |loss - reference loss| / reference loss;
- ``grad_gap``: the first gradient's worst leaf, |norm - reference norm|
  over the larger of the reference's norm of that leaf and of the median
  leaf;
- ``change_gap``: the median over the leaves of that gap of each leaf's
  change over the three steps, over the leaves whose reference gradient
  is at least a thousandth of the median leaf's (the others move under
  Adam by round-off alone). The median and not the worst leaf: in a small
  leaf (a BatchNorm's scale, a conv's bias) Adam turns the round-off of
  its near-zero gradient entries into steps of the full learning rate,
  so the worst leaf swings from seed to seed (PERF.md §6);
- ``window_loss_gap``, ``window_change_gap``: the same of the first three
  steps of the window's last epoch, which the reference replays from the
  program's state (weights and Adam's moments) at that epoch's start.
"""
from __future__ import annotations

import math

import numpy as np


def _gap(a, b) -> float:
    a, b = float(a), float(b)
    if math.isnan(a) and math.isnan(b):
        return 0.0
    return abs(a - b)


EVAL_GAPS = ("ece_gap", "dice_gap", "count_gap")


def eval_gaps(rows: dict, refs: dict) -> dict:
    """``rows`` and ``refs``: {item: row} (the program's from its CSVs, the
    reference's from ``reference.evalrows.eval_row``); an item the
    program has no row for reads as infinitely far."""
    ece = dice = count = 0.0
    for item, ref in refs.items():
        row = rows.get(item)
        if row is None:
            return dict.fromkeys(EVAL_GAPS, math.inf)
        ece = max(ece, _gap(row["ece"], ref["ece"]))
        dice = max(dice, _gap(row["dice"], ref["dice"]))
        counts = [abs(row[k] - ref[k]) for k in ("tp", "tn", "fp", "fn")]
        counts += [abs(a - b) for a, b in zip(row["bins_count"],
                                              ref["bins_count"])]
        counts += [abs(a - b) for r, s in zip(row["uncertain"],
                                              ref["uncertain"])
                   for a, b in zip(r, s)]
        if row["n"] != ref["n"]:
            counts.append(abs(row["n"] - ref["n"]))
        count = max(count, max(counts) / ref["n"])
    return {"ece_gap": ece, "dice_gap": dice, "count_gap": count}


def _leaf_gaps(got: dict, want: dict, leaves) -> list:
    """Each leaf's |norm - reference norm| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    median = float(np.median([want[k] for k in leaves]))
    return [abs(got[k] - want[k]) / max(want[k], median) for k in leaves]


def _loss_gap(got: dict, want: dict) -> float:
    if len(got["losses"]) != len(want["losses"]):
        return math.inf
    return max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                    want["losses"]))


def _change_gap(got: dict, want: dict, grad_floor: float) -> float:
    leaves = list(want["grad_norm"])
    median = float(np.median([want["grad_norm"][k] for k in leaves]))
    moving = [k for k in leaves if want["grad_norm"][k] >= grad_floor * median]
    return float(np.median(_leaf_gaps(got["change_norm"],
                                      want["change_norm"], moving)))


def train_gaps(got: dict, want: dict, grad_floor: float = 1e-3) -> dict:
    """``got``/``want``: {losses: [..], grad_norm: {leaf: norm},
    change_norm: {leaf: norm}} of the program and of the reference."""
    leaves = list(want["grad_norm"])
    grad = max(_leaf_gaps(got["grad_norm"], want["grad_norm"], leaves))
    return {"loss_gap": _loss_gap(got, want), "grad_gap": grad,
            "change_gap": _change_gap(got, want, grad_floor)}


def window_gaps(got: dict, want: dict, grad_floor: float = 1e-3) -> dict:
    """The window's checked steps: ``got`` {losses, change_norm}, ``want``
    as for :func:`train_gaps` (its first gradient picks the leaves)."""
    return {"window_loss_gap": _loss_gap(got, want),
            "window_change_gap": _change_gap(got, want, grad_floor)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): correct when every number is
    finite and within its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks
