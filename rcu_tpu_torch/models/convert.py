"""Weights bridge: a flax U-Net or PostNet tree (numpy leaves) -> the port's
state_dict.

Module names are the same on both sides (``models.unet`` mirrors flax's),
so the map is per leaf: a conv ``kernel`` HWIO -> ``weight`` OIHW, conv
``bias`` -> ``bias``; BatchNorm ``scale``/``bias`` -> ``weight``/``bias``
from ``params`` and ``mean``/``var`` -> ``running_mean``/``running_var``
from ``batch_stats``.
"""
from __future__ import annotations

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_flax(params: dict, batch_stats: dict) -> dict:
    """-> ``{name: tensor}`` loadable with ``load_state_dict(strict=True)``
    into the ``models.unet`` module of the same architecture."""
    state = {}
    for path, value in _flatten(params):
        value = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        state[".".join(path[:-1] + (_PARAM_LEAVES[path[-1]],))] = \
            torch.from_numpy(np.array(value, order="C"))
    for path, value in _flatten(batch_stats):
        prefix = ".".join(path[:-1])
        state[f"{prefix}.{_STAT_LEAVES[path[-1]]}"] = \
            torch.from_numpy(np.array(value, np.float32))
        state[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return state
