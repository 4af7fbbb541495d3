"""Ensemble inference over a 2-D ``("model", "data")`` mesh
(``rcu_tpu.parallel.ensemble`` counterpart, inference part): the K members
go K / n_model to each model-axis row and are replicated along that row's
data devices (EP x DP); a batch splits over the data axis.

Each device adds its local members' softmax in member order; the rows'
partial sums are added in row order on the first row's device, then
divided by K. On a 1-D mesh every device holds all K members, and the
sum is the single device's sum.
"""
from __future__ import annotations

import torch

from rcu_tpu_torch.ops import metrics
from rcu_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, Mesh,
                                         make_mesh, mesh_predict, replicate)


def make_ensemble_mesh(n_model: int, devices=None) -> Mesh:
    """The devices (default: every card) as ``n_model`` model-axis rows
    over the data axis."""
    if devices is None:
        devices = make_mesh().devices
    n = len(devices)
    if n % n_model != 0:
        raise ValueError(f"{n} devices not divisible by {n_model} members")
    return Mesh(devices, (MODEL_AXIS, DATA_AXIS), (n_model, n // n_model))


def shard_members(members, mesh: Mesh) -> list:
    """Place the members: per data column, per model row, the row's
    members on that column's device (:func:`replicate`)."""
    members = list(members)
    rows = mesh.rows()
    if len(members) % len(rows):
        raise ValueError(f"{len(members)} members do not divide over the "
                         f"{len(rows)}-device model axis")
    per = len(members) // len(rows)
    placed = [[replicate(m, row) for m in members[r * per:(r + 1) * per]]
              for r, row in enumerate(rows)]
    return [[[copies[d] for copies in row] for row in placed]
            for d in range(len(rows[0]))]


def member_sums(column, images, predict, moments: bool = False):
    """One data column's sums over the members on ``images`` (NHWC, on the
    column's first-row device): the softmax, and with ``moments`` the
    members' entropies and squared softmax, each added in member order on
    its row's device, then the rows in order on the first row's device.
    ``predict(member, images)`` is the deterministic softmax forward."""
    totals = None
    for row in column:
        x = images.to(next(row[0].parameters()).device, non_blocking=True)
        partial = None
        for member in row:
            p = predict(member, x)
            terms = (p, metrics.entropy(p, dim=-1), p * p) if moments \
                else (p,)
            partial = terms if partial is None else tuple(
                a + b for a, b in zip(partial, terms))
        partial = tuple(t.to(images.device, non_blocking=True)
                        for t in partial)
        totals = partial if totals is None else tuple(
            a + b for a, b in zip(totals, partial))
    return totals


def ensemble_summary(sums, k: int, do_mi: bool = False,
                     do_var: bool = False) -> dict:
    """:func:`member_sums`' sums over ``k`` members -> the member-mean
    ``probabilities`` and their ``entropy``, with ``do_mi`` the
    ``mutual_info`` (the entropy less the members' mean entropy) and with
    ``do_var`` the ``variance`` (``max(E[p^2] - E[p]^2, 0)`` averaged
    over the classes), the identities the JAX package's psums use."""
    probabilities = sums[0] / k
    out = {"probabilities": probabilities,
           "entropy": metrics.entropy(probabilities, dim=-1)}
    if do_mi:
        out["mutual_info"] = out["entropy"] - sums[1] / k
    if do_var:
        var = torch.clamp_min(sums[2] / k - probabilities * probabilities,
                              0.0)
        out["variance"] = torch.mean(var, dim=-1)
    return out


def shard_ensemble_predict_fn(members, mesh: Mesh, do_mi: bool = False,
                              do_var: bool = False):
    """EP x DP ensemble inference: ``predict(model, batch)`` (``model``
    unused: the members are placed here, :func:`shard_members`) -> the
    :func:`ensemble_summary` of each data column's part of the batch
    (:func:`parallel.mesh.mesh_predict`), joined in batch order on the
    mesh's first device. The member count must divide over the model
    axis."""
    from rcu_tpu_torch.engine.steps import predict as softmax_forward
    members = list(members)
    columns = shard_members(members, mesh)

    def column_fn(column, batch, rows):
        return ensemble_summary(
            member_sums(column, batch["images"], softmax_forward,
                        moments=do_mi or do_var),
            len(members), do_mi, do_var)

    predict_fn = mesh_predict(column_fn, mesh)
    return lambda model, batch: predict_fn(columns, batch)
