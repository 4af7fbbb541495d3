"""The training run (``rcu_tpu.engine.train`` counterpart): one device or a
mesh, the JAX package's run directory, resume, validation and checkpoint
retention.

- run dir ``<train_dir>/<run_id>_<train_name>``, reserved by an exclusive
  create; a ``train_name`` that starts with a run id resumes that run from
  its last epoch checkpoint;
- ``config.yaml``, ``log.txt`` and ``model_<run_id>/model.json`` in it,
  the checkpoints ``model_<run_id>/checkpoints/checkpoint_ep###[-best]
  .ckpt`` in the JAX package's encoding and tree layout;
- each epoch reshuffles the train loader with ``seed + epoch`` and runs a
  step a batch with the generator of ``(seed, epoch, step)``; validation
  (every ``valid_every_nth`` epochs: ``(epoch + 1) % nth == 0``) predicts
  the valid loader, assembles each subject and scores it with the
  ``eval_subject_fn``; the best mean score is kept.

The run is on ``cuda`` unless the caller passes ``device``; cuDNN and
matmul TF32 are off while it runs (the caller's flags come back after, also
on error), so that float32 training is float32.

With ``mesh`` (a ``parallel.Mesh``) the state lives on the mesh's first
device, the train and valid batch sizes round up to its data axis
(``parallel.pad_batch_size_to_mesh``), the batches stay on the host
(pinned where the mesh holds a card) and the train step, a mesh step
(``steps.make_*train_step(mesh=)``), splits each over the data devices;
validation runs the predict function of the mesh
(``steps.make_*predict_fn(mesh)``) on one eval-mode replica a data
device (``parallel.replicate``); checkpoints are written from the first
device.
"""
from __future__ import annotations

import logging
import math
import os
import time
import typing

import numpy as np
import torch

from rcu_tpu_torch.data.loader import prefetch
from rcu_tpu_torch.data.split import load_split
from rcu_tpu_torch.engine import checkpoint as ckpt_lib
from rcu_tpu_torch.engine import config as cfg_lib
from rcu_tpu_torch.engine import databuild, hooks as hooks_lib, steps as steps_lib
from rcu_tpu_torch.engine.state import TrainState, create_train_state
from rcu_tpu_torch.eval.device import full_float32
from rcu_tpu_torch.eval.direct import resolve_device
from rcu_tpu_torch.models import get_model, get_optimizer
from rcu_tpu_torch.ops import metrics as metrics_lib
from rcu_tpu_torch.parallel.mesh import pad_batch_size_to_mesh, replicate
from rcu_tpu_torch.utils import ids as ids_lib
from rcu_tpu_torch.utils import logs as logs_lib
from rcu_tpu_torch.utils import profiling


def default_eval_subject_fn(subject_data: dict, info: dict) -> typing.Tuple[dict, float]:
    """Per-subject validation: Dice of the argmax and the log loss as
    ``ce``. Returns (results, score = Dice)."""
    probabilities = subject_data["probabilities"]
    prediction = np.argmax(probabilities, axis=-1)
    target = np.squeeze(np.asarray(info["labels"]))
    if target.ndim > prediction.ndim:  # multi-channel labels: gt is channel 0
        target = target[..., 0]
    target = (target > 0.5).astype(np.uint8)
    dice = metrics_lib.dice(prediction, target)
    ce = metrics_lib.log_loss(
        probabilities.reshape(-1, probabilities.shape[-1]), target)
    return {"dice": dice, "ce": ce}, dice


def reserve_run_dir(config) -> typing.Tuple[str, str]:
    """A new run id and its run dir ``<train_dir>/<run_id>_<train_name>``,
    reserved by an exclusive create: ids have 1-second resolution, so
    that two runs started in the same second never share one."""
    for _ in range(5):
        run_id = ids_lib.unique_identifier()
        run_dir = os.path.join(config.train_dir,
                               f"{run_id}_{config.train_name}")
        try:
            os.makedirs(run_dir, exist_ok=False)
            return run_id, run_dir
        except FileExistsError:
            time.sleep(1.0)
    raise RuntimeError(f"could not find a free train run dir under "
                       f"{config.train_dir} for train_name="
                       f"{config.train_name!r} after 5 attempts")


class TrainLoop:
    """One training run. The strategies pass their own ``train_step``
    (``steps.make_*train_step``), ``predict_fn`` (``predict(model, batch)``
    -> entries) and ``eval_subject_fn``; ``hooks`` replaces the default
    hook list (which needs ``tensorboardX``). With ``mesh`` the step and
    the predict function must be the mesh's (the defaults are)."""

    def __init__(self, config: cfg_lib.TrainConfiguration,
                 train_step=None, predict_fn=None, eval_subject_fn=None,
                 hooks: list = None, mesh=None, model=None, optimizer=None,
                 validation_entries: tuple = ("probabilities",), device=None):
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self.validation_entries = tuple(validation_entries)
        if model is None:
            if config.model is None:
                raise ValueError("config.model is required")
            model = get_model(config.model.type, config.model.params)
        if optimizer is None:
            if config.optimizer is None:
                raise ValueError("config.optimizer is required")
            optimizer = get_optimizer(config.optimizer.type,
                                      config.optimizer.params)
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step or steps_lib.make_train_step(mesh=mesh)
        self.predict_fn = predict_fn or steps_lib.make_predict_fn(mesh)
        self.eval_subject_fn = eval_subject_fn or default_eval_subject_fn

        leading = ids_lib.extract_leading_identifier(config.train_name)
        self.resume = bool(leading)
        if self.resume:
            self.run_id = leading
            self.run_dir = os.path.join(config.train_dir, config.train_name)
        else:
            self.run_id, self.run_dir = reserve_run_dir(config)
        self.model_files = ckpt_lib.ModelFiles.create(self.run_dir, self.run_id)

        default_hooks = [
            hooks_lib.ConsoleLogHook(config.log_every_nth),
            hooks_lib.TensorboardHook(os.path.join(self.run_dir, "tb")),
            hooks_lib.SaveBestModelHook(),
            hooks_lib.SaveNLastModelHook(3),
            hooks_lib.WriteValidationMetricsCsvHook(
                os.path.join(self.run_dir, "validation_metrics.csv")),
        ] if hooks is None else hooks
        self.hook = hooks_lib.ComposeTrainHook(default_hooks)

        self.state: TrainState = None
        self.train_data = None
        self.valid_data = None
        self.nb_params = None
        self.best_score = None
        self.resume_epoch = None

    # -- lifecycle pieces ------------------------------------------------
    def setup_directory(self):
        os.makedirs(self.run_dir, exist_ok=True)
        cfg_lib.save(self.config, os.path.join(self.run_dir, "config.yaml"))

    def load_data(self):
        cfg = self.config
        train_subjects = valid_subjects = None
        if cfg.split:
            train_subjects, valid_subjects, _ = load_split(
                cfg.split, cfg.others.get("split_k"))
        bs_train = cfg.train_data.batch_size
        bs_valid = cfg.valid_data.batch_size
        if self.mesh is not None:
            bs_train = pad_batch_size_to_mesh(bs_train, self.mesh)
            bs_valid = pad_batch_size_to_mesh(bs_valid, self.mesh)
        prediction_dir = cfg.others.get("prediction_dir")
        self.train_data = databuild.build_data(
            cfg.train_data, subjects=train_subjects, seed=cfg.seed,
            batch_size=bs_train, prediction_dir=prediction_dir)
        self.valid_data = databuild.build_data(
            cfg.valid_data, subjects=valid_subjects, seed=cfg.seed,
            batch_size=bs_valid, prediction_dir=prediction_dir)

    def init_state(self):
        """The model initialized from the config seed on the run's device,
        a fresh optimizer state, and model.json."""
        self.state = create_train_state(self.model, self.optimizer,
                                        self.config.seed, self.device)
        self.nb_params = sum(p.numel() for p in self.model.parameters())
        ckpt_lib.backup_model_parameters(self.model_files, self.config.model,
                                         self.config.optimizer)

    def save_checkpoint(self, epoch: int, best: bool = False):
        payload = {**self.state.to_flax(), "epoch": epoch,
                   "best_score": np.float32(self.best_score
                                            if self.best_score is not None
                                            else -np.inf)}
        ckpt_lib.save_checkpoint(self.model_files, payload, epoch, best)

    def load_checkpoint(self, at) -> int:
        path = ckpt_lib.find_checkpoint_file(self.model_files, at)
        if path is None:
            raise FileNotFoundError(f"no checkpoint '{at}' in "
                                    f"{self.model_files.weight_checkpoint_dir}")
        raw = ckpt_lib.load_checkpoint(path)
        self.state.load_flax(raw)
        best = float(raw["best_score"])
        self.best_score = best if math.isfinite(best) else None
        return int(raw["epoch"])

    # -- main ------------------------------------------------------------
    def run(self):
        resume_at = None
        if self.resume:
            resume_at = ckpt_lib.find_last_checkpoint_epoch(self.model_files)
        if resume_at is None:
            self.setup_directory()
        logs_lib.setup_logging(self.run_dir)

        with full_float32():
            self.load_data()
            self.init_state()
            if resume_at is not None:
                self.load_checkpoint(resume_at)
                logging.info("resumed run %s at epoch %d", self.run_id,
                             resume_at)
            self.resume_epoch = resume_at  # last completed epoch
            self.hook.on_startup(self)
            first_epoch = 0 if resume_at is None else resume_at + 1
            for epoch in range(first_epoch, self.config.epochs):
                self.state.epoch = epoch
                self.hook.on_epoch_start(self, epoch)
                self._train_epoch(epoch)
                if self._need_validation(epoch):
                    self._validate(epoch)
                self.hook.on_epoch_end(self, epoch)
            self.hook.on_termination(self)
        return self

    def _need_validation(self, epoch: int) -> bool:
        """``(epoch + 1) % nth == 0``: epochs nth-1, 2nth-1, ..."""
        return (epoch + 1) % self.config.valid_every_nth == 0

    def _feed(self, loader, stage: str):
        """The loader's batches: on the run's device, or on a mesh on the
        host (pinned where the mesh holds a card), where the step or the
        predict function copies each device its part; ``stage`` names the
        feed's spans."""
        if self.mesh is None:
            return prefetch(iter(loader), self.device, stage=stage)
        return prefetch(iter(loader), "cpu", pin=self.device.type == "cuda",
                        stage=stage)

    def _train_epoch(self, epoch: int):
        loader = self.train_data.loader
        loader.set_epoch(epoch)
        nb_batches = self.train_data.nb_batches
        metric_sums: dict = {}
        nb = 0
        for i, batch in enumerate(self._feed(loader, "train")):
            with profiling.span("train.step", i):
                generator = steps_lib.step_generator(self.config.seed, epoch,
                                                     i, self.device)
                metrics = self.train_step(self.state, batch, generator)
                # the sums stay on the device: the loop never waits on a step
                for k, v in metrics.items():
                    metric_sums[k] = metric_sums.get(k, 0.0) + v
            profiling.count("train.steps")
            nb += 1
            with profiling.span("train.hooks", i):
                self.hook.on_training_batch_end(self, epoch, i, nb_batches,
                                                metrics)
        with profiling.span("train.epoch_end"):
            means = {k: float(v) / max(nb, 1) for k, v in metric_sums.items()}
            self.hook.on_training_end(self, epoch, means)

    def _validate(self, epoch: int):
        asm = databuild.build_assembler(self.valid_data.dataset,
                                        self.config.valid_data.indexing,
                                        self.validation_entries)
        dataset = self.valid_data.dataset
        scores, subject_results = [], []
        model = self.state.model.eval()
        if self.mesh is not None:
            model = replicate(model, self.mesh.data_devices)
        with torch.no_grad():
            for batch in self._feed(self.valid_data.loader, "valid"):
                outputs = self.predict_fn(model, batch)
                fetched = {e: outputs[e].cpu().numpy()
                           for e in self.validation_entries if e in outputs}
                asm.add_batch(fetched, batch["subject_index"].cpu().numpy(),
                              batch["slice_index"].cpu().numpy(),
                              batch["valid"].cpu().numpy())
                for subject_index in asm.subjects_ready():
                    subject_data = asm.get_assembled_subject(subject_index)
                    info = databuild.direct_subject_info(dataset,
                                                         subject_index)
                    results, score = self.eval_subject_fn(subject_data, info)
                    scores.append(score)
                    subject_results.append(results)
                    self.hook.on_validation_subject_end(
                        self, epoch, info["subject"], results)
        leftover = asm.flush()
        if leftover:
            logging.warning(
                "validation epoch %d: %d subject(s) were only partially "
                "assembled and were dropped: %s — check that valid_data has "
                "no slice-dropping selection strategy", epoch, len(leftover),
                [dataset.subjects[i] for i in leftover])
        if not scores:
            logging.warning("validation epoch %d produced no assembled "
                            "subjects; epoch not scored", epoch)
            self.hook.on_validation_end(self, epoch, float("nan"), False,
                                        subject_results)
            return
        score = float(np.mean(scores))
        is_best = self.best_score is None or score > self.best_score
        if is_best:
            self.best_score = score
            self.state.best_score = score
        self.hook.on_validation_end(self, epoch, score, is_best,
                                    subject_results)
