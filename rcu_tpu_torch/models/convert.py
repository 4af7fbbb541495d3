"""Weights bridge: a flax U-Net or PostNet tree (numpy leaves) -> the port's
state_dict, the way back, and the BatchNorm fold on a flax tree.

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


def flax_from_state_dict(state: dict) -> tuple:
    """The inverse of :func:`state_dict_from_flax`: -> ``(params,
    batch_stats)`` flax trees with float32 numpy leaves."""
    trees = ({}, {})
    for name, tensor in state.items():
        *path, leaf = name.split(".")
        if leaf == "num_batches_tracked":
            continue
        value = tensor.detach().float().cpu().numpy()
        is_bn = path[-1].startswith("BatchNorm")
        if leaf in ("running_mean", "running_var"):
            tree, leaf = trees[1], leaf[len("running_"):]
        elif leaf == "weight":
            tree, leaf = trees[0], "scale" if is_bn else "kernel"
            if not is_bn:
                value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        else:
            tree = trees[0]
        for key in path:
            tree = tree.setdefault(key, {})
        tree[leaf] = np.ascontiguousarray(value)
    return trees


def fold_bn_params(params: dict, batch_stats: dict,
                   epsilon: float = 1e-5) -> tuple:
    """Fold every ConvBnRelu's BatchNorm into its conv, in numpy float32 on
    the flax tree (``rcu_tpu.models.fold_bn_params``, whose arrays these
    equal): ``kernel * mul`` and ``(bias - mean) * mul + bn_bias`` with
    ``mul = scale / sqrt(var + eps)``. A ConvBnRelu is a dict holding both
    ``Conv_0`` and ``BatchNorm_0``; up-convs and heads pass through.
    Returns ``(params, batch_stats)`` with every folded ``BatchNorm_0``
    dropped, the tree of a ``fold_bn=True`` model."""
    def walk(p, s):
        out_p, out_s = {}, {}
        for key, sub in p.items():
            stats = s.get(key, {})
            if not isinstance(sub, dict):
                out_p[key] = sub
            elif "BatchNorm_0" in sub and "Conv_0" in sub:
                bnp, bns = sub["BatchNorm_0"], stats["BatchNorm_0"]
                mul = (np.asarray(bnp["scale"], np.float32)
                       / np.sqrt(np.asarray(bns["var"], np.float32)
                                 + np.float32(epsilon)))
                conv = dict(sub["Conv_0"])
                conv["kernel"] = np.asarray(conv["kernel"], np.float32) * mul
                conv["bias"] = ((np.asarray(conv["bias"], np.float32)
                                 - np.asarray(bns["mean"], np.float32)) * mul
                                + np.asarray(bnp["bias"], np.float32))
                out_p[key] = {k: (conv if k == "Conv_0" else v)
                              for k, v in sub.items() if k != "BatchNorm_0"}
                rest = {k: v for k, v in stats.items() if k != "BatchNorm_0"}
                if rest:
                    out_s[key] = rest
            else:
                out_p[key], sub_s = walk(sub, stats)
                if sub_s:
                    out_s[key] = sub_s
        return out_p, out_s

    return walk(params, batch_stats)
