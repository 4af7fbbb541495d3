"""The staged test loop (``rcu_tpu.engine.test`` counterpart): a checkpoint's
predictions over a test split, written as the per-subject NIfTI artifacts
that the offline eval (``cli.eval_uncertainty``) and auxiliary_segm's
baselines read.

Artifacts in the run dir ``<test_dir>/<test_id>_<test_name>`` (reserved by
an exclusive create; by default ``test_dir`` is ``test/`` beside the
model's train run dir):
- ``<subject>_probabilities.nii.gz``: the foreground probability, float32;
- ``<subject>_prediction.nii.gz``: the argmax, uint8;
- a strategy's ``_sigma`` (the predicted class's sigma) or
  ``_confidence`` (the auxiliary nets' foreground);
- ``metrics.csv`` (a row per subject), ``config.yaml`` and ``log.txt``;
- with ``symlink_inputs`` (image folders: ISIC), links to each subject's
  image and ground truth.

The loader's batches (``data.loader.prefetch``: read ahead, pinned) run
through ``predict_fn`` on the device with TF32 off, one batch in flight
while the last one's outputs come back in one copy and are assembled into
subjects on the host; a subject's artifacts go to a background writer
pool, whose ``flush()`` at the end re-raises any failed write. The run is
on ``cuda`` unless the caller passes ``device``.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.data.loader import prefetch
from rcu_tpu_torch.data.split import load_split
from rcu_tpu_torch.engine import config as cfg_lib
from rcu_tpu_torch.engine import databuild, hooks as hooks_lib, steps as steps_lib
from rcu_tpu_torch.eval.device import Fetch, full_float32
from rcu_tpu_torch.eval.direct import (_primary_test_at, load_model,
                                       resolve_device)
from rcu_tpu_torch.ops import metrics as metrics_lib
from rcu_tpu_torch.parallel.mesh import pad_batch_size_to_mesh, replicate
from rcu_tpu_torch.utils import ids as ids_lib
from rcu_tpu_torch.utils import logs as logs_lib
from rcu_tpu_torch.utils.writerpool import WriterPool


def default_test_eval_fn(subject_data: dict, info: dict) -> dict:
    """Dice of the argmax against the ground truth (channel 0 of
    multi-channel labels)."""
    prediction = np.argmax(subject_data["probabilities"], axis=-1)
    target = np.squeeze(np.asarray(info["labels"]))
    if target.ndim > prediction.ndim:
        target = target[..., 0]
    target = (target > 0.5).astype(np.uint8)
    return {"dice": metrics_lib.dice(prediction, target)}


def write_artifact(loop: "TestLoop", array, subject: str, postfix: str,
                   props):
    """Queue ``<subject>_<postfix>.nii.gz`` on the loop's writer pool."""
    loop.pool.submit(nifti.write, array,
                     os.path.join(loop.run_dir, f"{subject}_{postfix}.nii.gz"),
                     props)


def default_artifact_fn(loop: "TestLoop", subject: str, subject_data: dict,
                        info: dict):
    """``_probabilities`` (the foreground), ``_prediction`` (the argmax)
    and, where the outputs hold them, ``_sigma`` and ``_confidence``."""
    props = info["properties"]
    probabilities = subject_data["probabilities"]
    write_artifact(loop, np.squeeze(probabilities[..., 1]).astype(np.float32),
                   subject, "probabilities", props)
    write_artifact(loop, np.squeeze(np.argmax(probabilities, axis=-1)
                                    .astype(np.uint8)),
                   subject, "prediction", props)
    for entry in ("sigma", "confidence"):
        if entry in subject_data:
            write_artifact(loop, np.squeeze(np.asarray(subject_data[entry]))
                           .astype(np.float32), subject, entry, props)


def symlink_subject_inputs(loop: "TestLoop", subject: str, info: dict):
    """Links to the subject's raw inputs (image, ground truth) in the run
    dir."""
    for entries in info.get("files", {}).values():
        for path in entries.values():
            if not path or not os.path.exists(path):
                continue
            link = os.path.join(loop.run_dir, os.path.basename(path))
            if not os.path.lexists(link):
                os.symlink(os.path.abspath(path), link)


class TestLoop:
    """One test run. ``predict_fn(model, batch[, rng])`` -> the entries
    (``steps.make_*predict_fn``; ``rng``, the ints ``(seed, batch index)``
    that name the batch's random stream, with ``needs_rng``), default the
    deterministic softmax; ``model`` a model with its weights, by default
    ``config.model_dir``'s at ``config.test_at`` ('best' where unset;
    epoch 0 is an epoch). ``external_state``: ``predict_fn`` carries its
    models (the ensemble), and no model is loaded. ``eval_subject_fn``
    gives a subject's ``metrics.csv`` row, ``artifact_fn`` writes its
    artifacts.

    ``mesh`` (a ``parallel.Mesh``): the batch size rounds up to its data
    axis, the model is replicated on the data devices
    (``parallel.replicate``; ``model`` is then the list of copies that a
    mesh predict function takes, ``steps.make_*predict_fn(mesh=)``), the
    loader's batches stay on the host and each splits over the devices,
    and the outputs come back joined in batch order: the artifacts are
    the single device's."""
    __test__ = False  # not a pytest class

    def __init__(self, config: cfg_lib.TestConfiguration, predict_fn=None,
                 model=None, entries: tuple = ("probabilities",),
                 eval_subject_fn=None, artifact_fn=None, hooks: list = None,
                 mesh=None, needs_rng: bool = False,
                 symlink_inputs: bool = False, external_state: bool = False,
                 run_dir_base: str = None, device=None):
        if model is None:
            if external_state and predict_fn is None:
                raise ValueError("external_state without a model requires an "
                                 "explicit predict_fn")
            if not external_state and not config.model_dir:
                raise ValueError("config.model_dir or an explicit model is "
                                 "required")
        self.config = config
        self.mesh = mesh
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self.needs_rng = needs_rng
        self.symlink_inputs = symlink_inputs
        self.entries = tuple(entries)
        self.eval_subject_fn = eval_subject_fn or default_test_eval_fn
        self.artifact_fn = artifact_fn or default_artifact_fn
        self.external_state = external_state
        self.model = model
        self.predict_fn = predict_fn or steps_lib.make_predict_fn(mesh)

        test_dir = config.test_dir
        if not test_dir and config.model_dir:
            test_dir = os.path.join(os.path.dirname(config.model_dir), "test")
        test_dir = test_dir or run_dir_base
        if not test_dir:
            raise ValueError("one of config.test_dir, config.model_dir or "
                             "run_dir_base must locate the test run dir")
        # ids have 1-second resolution: reserve the run dir with an
        # exclusive create, so that two runs started in the same second
        # never share one (their artifacts and metrics would interleave)
        self.test_id = ids_lib.unique_identifier()
        for _ in range(5):
            candidate = os.path.join(test_dir, f"{self.test_id}_{config.test_name}")
            try:
                os.makedirs(candidate, exist_ok=False)
                break
            except FileExistsError:
                pass
            time.sleep(1.0)
            self.test_id = ids_lib.unique_identifier()
        else:
            raise RuntimeError(
                f"could not find a free test run dir under {test_dir} for "
                f"test_name={config.test_name!r} after 5 attempts — refusing "
                "to share a run dir (artifacts/metrics would interleave)")
        self.run_dir = candidate
        self.test_dir = test_dir
        self.hook = hooks_lib.ComposeTestHook(
            hooks if hooks is not None else [
                hooks_lib.ConsoleTestLogHook(),
                hooks_lib.WriteTestMetricsCsvHook(
                    os.path.join(self.run_dir, "metrics.csv"))])
        self.pool = WriterPool()
        self.test_data = None

    def load_state(self):
        """The checkpoint's model on the run's device, unless the caller
        gave one or the predict function carries its own."""
        if self.model is None and not self.external_state:
            self.model = load_model(self.config.model_dir,
                                    _primary_test_at(self.config), self.device)
        if self.model is not None:
            self.model.eval()
            if self.mesh is not None:
                self.model = replicate(self.model, self.mesh.data_devices)

    def run(self):
        logs_lib.setup_logging(self.run_dir)
        cfg = self.config
        cfg_lib.save(cfg, os.path.join(self.run_dir, "config.yaml"))
        subjects = None
        if cfg.split:
            _, _, subjects = load_split(cfg.split, cfg.others.get("split_k"))
        batch_size = cfg.test_data.batch_size
        if self.mesh is not None:
            batch_size = pad_batch_size_to_mesh(batch_size, self.mesh)
        self.test_data = databuild.build_data(
            cfg.test_data, subjects=subjects, seed=cfg.seed,
            batch_size=batch_size,
            prediction_dir=cfg.others.get("prediction_dir"))
        dataset = self.test_data.dataset
        subject_results = []
        try:
            with full_float32(), torch.inference_mode():
                self.load_state()
                self.hook.on_startup(self)
                self._predict(dataset, subject_results)
        finally:
            # a failed background write must surface, also when the loop
            # itself raised (it then chains through __context__)
            self.pool.flush()
        self.hook.on_test_end(self, subject_results)
        self.hook.on_termination(self)
        return self

    def _predict(self, dataset, subject_results):
        asm = databuild.build_assembler(dataset, self.config.test_data.indexing,
                                        self.entries)
        nb_batches = self.test_data.nb_batches
        pending = None  # the last batch's outputs, on their way to the host
        # on a mesh the batches stay on the host (pinned where the mesh
        # holds a card): the predict function copies each device its part
        device, pin = (self.device, None) if self.mesh is None else \
            ("cpu", self.device.type == "cuda")
        for i, batch in enumerate(prefetch(iter(self.test_data.loader),
                                           device, pin=pin, stage="test")):
            args = (self.model, batch) + \
                (((self.config.seed, i),) if self.needs_rng else ())
            outputs = self.predict_fn(*args)
            fetch = Fetch({**{e: outputs[e] for e in self.entries},
                            **{k: batch[k] for k in
                               ("subject_index", "slice_index", "valid")}})
            if pending is not None:
                self._assemble(asm, dataset, subject_results, *pending,
                               nb_batches)
            pending = (i, fetch)
        if pending is not None:
            self._assemble(asm, dataset, subject_results, *pending, nb_batches)
        leftover = asm.flush()
        if leftover:
            names = [dataset.subjects[si] for si in leftover]
            raise RuntimeError(
                "test loop ended with partially assembled subjects (missing "
                f"slices, no artifacts written): {names}")

    def _assemble(self, asm, dataset, subject_results, i, fetch, nb_batches):
        host = fetch.result()
        asm.add_batch({e: host[e] for e in self.entries},
                      host["subject_index"], host["slice_index"],
                      host["valid"])
        self.hook.on_test_batch_end(self, i, nb_batches)
        for subject_index in asm.subjects_ready():
            subject_data = asm.get_assembled_subject(subject_index)
            info = databuild.direct_subject_info(dataset, subject_index)
            results = self.eval_subject_fn(subject_data, info)
            subject_results.append(results)
            self.artifact_fn(self, info["subject"], subject_data, info)
            if self.symlink_inputs:
                symlink_subject_inputs(self, info["subject"], info)
            self.hook.on_test_subject_end(self, info["subject"], subject_data,
                                          results)
