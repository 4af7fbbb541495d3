"""The ensemble over a 2-D ``("model", "data")`` mesh
(``rcu_tpu.parallel.ensemble`` counterpart): the K members go K / n_model
to each model-axis row (EP), and a batch splits over the row's data
devices (DP).

Inference: each member is replicated along its row's data devices; each
device adds its local members' softmax in member order; the rows'
partial sums are added in row order on the first row's device, then
divided by K. On a 1-D mesh every device holds all K members, and the
sum is the single device's sum.

Training (:func:`train_ensemble_fused`, ``bin/train_ensemble_fused.py``'s
counterpart): the members step in lockstep, each on its row
(:func:`member_placement`): a member's step is the mesh train step on its
row's data devices (``engine.steps.MeshTrainStep``; one device: the
single step), and each row runs its members one after another on its
first device (:func:`ensemble_step`). The JAX package stacks the members
and vmaps one step over them; the port runs each member's own step
instead of grouped convolutions: a flagship member step alone keeps the
card busy, so a fused program has little idle time to take back.
"""
from __future__ import annotations

import logging
import os

import numpy as np
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


# ------------------------------------------------------------------ training

def member_placement(k: int, mesh: Mesh = None, device=None) -> list:
    """Where each of ``k`` members trains: ``(device, row mesh)`` with the
    members over the model axis, ``k / n_model`` a row in order, each on
    its row's first data device with the row's data devices as its 1-D
    mesh (the counterpart of ``stack_states``' member axis laid over
    ``model``); without a mesh every member on ``device`` (default cuda)
    and no mesh."""
    if mesh is None:
        from rcu_tpu_torch.eval.direct import resolve_device
        return [(resolve_device(device), None)] * k
    rows = mesh.rows()
    if k % len(rows):
        raise ValueError(f"{k} members do not divide over the "
                         f"{len(rows)}-device model axis")
    per = k // len(rows)
    return [(rows[m // per][0], Mesh(rows[m // per])) for m in range(k)]


def ensemble_step(states, member_steps, batches, generators) -> list:
    """One lockstep step of every member (the counterpart of the vmapped
    step ``make_vmapped_ensemble_train_step`` sharded over the mesh,
    ``shard_ensemble_train_step``): member ``m``'s step on its own batch
    and generator, in member order, so that each row runs its members one
    after another on its device. -> each member's metrics (on its
    device)."""
    return [step(state, batch, generator) for state, step, batch, generator
            in zip(states, member_steps, batches, generators)]


class MemberRun:
    """One member of a fused ensemble run: its config, run id and dir,
    model files, data, train state, step, best score and saved epochs."""

    def __init__(self, config, run_id, run_dir, model_files):
        self.config, self.run_id, self.run_dir = config, run_id, run_dir
        self.model_files = model_files
        self.train_data = self.valid_data = None
        self.state = self.step = self.device = self.step_mesh = None
        self.best_score = None
        self.saved_epochs = []


def _check_members(configs):
    """The JAX package's refusals, word for word."""
    first = configs[0]
    for cfg in configs[1:]:
        if cfg.model.params != first.model.params:
            raise ValueError("fused ensemble members must share the model config")
        # the fused step uses the FIRST config's optimizer/epochs for every
        # member; a silently-ignored difference would write per-member
        # config.yamls claiming hyperparameters that were never used
        if (cfg.optimizer.type, cfg.optimizer.params) != \
                (first.optimizer.type, first.optimizer.params):
            raise ValueError("fused ensemble members must share the "
                             "optimizer config (train divergent members as "
                             "separate runs)")
        if cfg.epochs != first.epochs:
            raise ValueError("fused ensemble members must share epochs; got "
                             f"{cfg.epochs} vs {first.epochs}")
    names = [(cfg.train_dir, cfg.train_name) for cfg in configs]
    if len(set(names)) != len(names):
        # all members are created within the same second, so the run id does
        # not disambiguate — identical names would interleave checkpoints in
        # ONE directory and silently corrupt every member involved
        raise ValueError("fused ensemble members must have distinct "
                         "train_name values per train_dir; got "
                         f"{[n for _, n in names]}")


def _feed(member):
    """A member's train batches: on its device, or on the host (pinned for
    a card) where its row splits them over several data devices."""
    from rcu_tpu_torch.data.loader import prefetch
    loader = member.train_data.loader
    if member.step_mesh is None or len(member.step_mesh.data_devices) == 1:
        return prefetch(iter(loader), member.device)
    return prefetch(iter(loader), "cpu", pin=member.device.type == "cuda")


def train_ensemble_fused(configs, mesh: Mesh = None, device=None) -> list:
    """Train all K members in lockstep (replaces K sequential runs,
    config/train_ensemble/). Each member keeps its own data (its
    ``others.split_k``, its loader seeded ``seed + i``), run dir,
    checkpoints (best and the 3 last, in the JAX package's flax schema)
    and best tracking, so ``strategies.test_ensemble`` reads the run dirs
    as K separate runs'.

    ``configs``: one train config a member (the same model, optimizer and
    epochs; distinct names). Member ``i`` is initialized from
    ``configs[i].seed + i``; every member trains with the first config's
    optimizer and epochs, ``min`` of the members' batch counts steps an
    epoch, the batch padded to the mesh's data axis, member ``m``'s step
    ``s`` of epoch ``e`` drawing from ``seeded_generator((seed, e, s,
    m))``; each member is validated every epoch (mean subject Dice,
    :func:`_validate_member`). ``mesh``: a ``("model", "data")`` mesh
    (:func:`make_ensemble_mesh`) whose model axis divides K; without one
    every member trains on ``device`` (default cuda). TF32 is off while
    it runs. -> the :class:`MemberRun` records."""
    from rcu_tpu_torch.data.split import load_split
    from rcu_tpu_torch.engine import checkpoint as ckpt_lib
    from rcu_tpu_torch.engine import config as cfg_lib
    from rcu_tpu_torch.engine import databuild
    from rcu_tpu_torch.engine import steps as steps_lib
    from rcu_tpu_torch.engine.state import create_train_state
    from rcu_tpu_torch.engine.train import reserve_run_dir
    from rcu_tpu_torch.eval.device import full_float32
    from rcu_tpu_torch.models import get_model, get_optimizer
    from rcu_tpu_torch.parallel.mesh import pad_batch_size_to_mesh
    from rcu_tpu_torch.utils import logs as logs_lib

    k = len(configs)
    first = configs[0]
    _check_members(configs)
    placement = member_placement(k, mesh, device)
    optimizer = get_optimizer(first.optimizer.type, first.optimizer.params)
    row_steps = {}
    members = []
    for i, cfg in enumerate(configs):
        run_id, run_dir = reserve_run_dir(cfg)
        m = MemberRun(cfg, run_id, run_dir,
                      ckpt_lib.ModelFiles.create(run_dir, run_id))
        cfg_lib.save(cfg, os.path.join(run_dir, "config.yaml"))
        ckpt_lib.backup_model_parameters(m.model_files, cfg.model,
                                         cfg.optimizer)
        train_subjects = valid_subjects = None
        if cfg.split:
            train_subjects, valid_subjects, _ = load_split(
                cfg.split, cfg.others.get("split_k"))
        bs = cfg.train_data.batch_size
        if mesh is not None:
            bs = pad_batch_size_to_mesh(bs, mesh)
        m.train_data = databuild.build_data(cfg.train_data,
                                            subjects=train_subjects,
                                            seed=cfg.seed + i, batch_size=bs)
        m.valid_data = databuild.build_data(cfg.valid_data,
                                            subjects=valid_subjects,
                                            seed=cfg.seed)
        m.device, m.step_mesh = placement[i]
        key = None if m.step_mesh is None else m.step_mesh.devices
        if key not in row_steps:
            row_steps[key] = steps_lib.make_train_step(mesh=m.step_mesh)
        m.step = row_steps[key]
        members.append(m)
    logs_lib.setup_logging(members[0].run_dir)
    epochs = first.epochs
    nb_steps = min(m.train_data.nb_batches for m in members)

    with full_float32():
        for i, (m, cfg) in enumerate(zip(members, configs)):
            m.state = create_train_state(
                get_model(first.model.type, first.model.params), optimizer,
                cfg.seed + i, m.device)
        for epoch in range(epochs):
            feeds = []
            for m in members:
                m.train_data.loader.set_epoch(epoch)
                feeds.append(_feed(m))
            metrics = None
            try:
                for s in range(nb_steps):
                    metrics = ensemble_step(
                        [m.state for m in members], [m.step for m in members],
                        [next(f) for f in feeds],
                        [steps_lib.seeded_generator((first.seed, epoch, s, j),
                                                    m.device)
                         for j, m in enumerate(members)])
            finally:
                for f in feeds:
                    f.close()
            logging.info("fused ensemble epoch %d/%d losses %s", epoch + 1,
                         epochs, "-" if metrics is None else
                         [round(float(x["loss"]), 4) for x in metrics])
            for i, m in enumerate(members):
                score = _validate_member(m)
                payload = {**m.state.to_flax(), "epoch": epoch,
                           "best_score": np.float32(score)}
                if m.best_score is None or score > m.best_score:
                    m.best_score = score
                    prev = ckpt_lib.find_best_checkpoint_epoch(m.model_files)
                    if prev is not None:
                        ckpt_lib.delete_checkpoint(m.model_files, prev,
                                                   best=True)
                    ckpt_lib.save_checkpoint(m.model_files, payload, epoch,
                                             best=True)
                ckpt_lib.save_checkpoint(m.model_files, payload, epoch)
                m.saved_epochs.append(epoch)
                while len(m.saved_epochs) > 3:
                    ckpt_lib.delete_checkpoint(m.model_files,
                                               m.saved_epochs.pop(0))
                logging.info("  member %d: valid score %.4f (best %.4f)", i,
                             score, m.best_score)
    return members


def _validate_member(member) -> float:
    """Mean subject Dice of one member over its valid loader (the
    deterministic forward on its device, the assembler of its valid
    indexing); -inf where no subject assembled."""
    from rcu_tpu_torch.data.loader import prefetch
    from rcu_tpu_torch.engine import databuild
    from rcu_tpu_torch.engine.steps import make_predict_fn
    from rcu_tpu_torch.ops import metrics as metrics_lib

    data = member.valid_data
    asm = databuild.build_assembler(data.dataset,
                                    member.config.valid_data.indexing,
                                    ("probabilities",))
    predict = make_predict_fn()
    model = member.state.model.eval()
    scores = []
    with torch.no_grad():
        for batch in prefetch(iter(data.loader), member.device,
                              stage="valid"):
            out = predict(model, batch)
            asm.add_batch({"probabilities": out["probabilities"].cpu().numpy()},
                          batch["subject_index"].cpu().numpy(),
                          batch["slice_index"].cpu().numpy(),
                          batch["valid"].cpu().numpy())
            for si in asm.subjects_ready():
                subject = asm.get_assembled_subject(si)
                info = databuild.direct_subject_info(data.dataset, si)
                prediction = np.argmax(subject["probabilities"], axis=-1)
                target = np.squeeze(np.asarray(info["labels"]))
                if target.ndim > prediction.ndim:
                    target = target[..., 0]
                scores.append(float(metrics_lib.dice(
                    prediction, (target > 0.5).astype(np.uint8))))
    return float(np.mean(scores)) if scores else float("-inf")
