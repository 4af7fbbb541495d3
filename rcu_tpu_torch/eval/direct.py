"""Direct one-pass test+eval: checkpoint -> per-volume MC-dropout inference
+ calibration/uncertainty eval -> the eval CSV families, with no NIfTI
artifacts in between (``rcu_tpu.eval.direct`` counterpart).

Ported: the ``mc`` and ``deterministic`` (``mc=0``) protocols on volume
stores, one device, the flat CSV layout. The other strategy families,
native-2D datasets, meshes and the bf16/fast-decoder/int8/BN-fold variants
are later slices and raise ``NotImplementedError``.

:func:`evaluate_direct` builds the dataset and the model from a test config
and its checkpoint; :func:`evaluate_subjects` is the core, and takes any
dataset object with ``subjects``, ``read_volume``, ``shape`` and ``files``.
"""
from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.data.split import load_split
from rcu_tpu_torch.engine import checkpoint as ckpt_lib
from rcu_tpu_torch.engine import databuild
from rcu_tpu_torch.eval import hooks as ev_hooks
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.models.convert import unet_state_dict_from_flax

DEFAULT_THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
_ECE_COLUMNS = ("ece", "dice", "tp", "tn", "fp", "fn", "n")


def resolve_device(device=None) -> torch.device:
    """``cuda`` unless the caller asks for another device; never a silent
    fallback to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' "
                           "(CLI: -device cpu) to run on the CPU")
    return device


class _EvalSinks:
    """The run's CSV families in ``out_dir``: calibration bins, the ece_dice
    row, one correction CSV per threshold and the run minmax summary."""

    def __init__(self, out_dir, run_id, thresholds):
        os.makedirs(out_dir, exist_ok=True)
        self.run_id = run_id
        self.calib = ev_hooks.WriteCsvHook(os.path.join(
            out_dir, dirs.CALIBRATION_PLACEHOLDER.format(run_id)))
        self.ece = ev_hooks.WriteCsvHook(
            os.path.join(out_dir, dirs.ECE_PLACEHOLDER.format(run_id)),
            entries=_ECE_COLUMNS)
        self.corr = [ev_hooks.WriteCsvHook(os.path.join(
            out_dir, dirs.UNCERTAINTY_PLACEHOLDER.format(
                run_id, f"{threshold:.2f}".replace(".", ""))))
            for threshold in thresholds]
        self.minmax_path = os.path.join(
            out_dir, dirs.MINMAX_PLACEHOLDER.format(run_id))
        self.bounds = {"min": [], "max": []}
        self.nonfinite = []  # subjects with NaN/inf ECE; finish() raises

    def write_subject(self, subject, row):
        """``row``: the host (numpy) eval dict of one subject."""
        ece = float(row["ece"])
        if not np.isfinite(ece):
            # an empty eval mask bins zero voxels: write the row anyway, keep
            # going, and fail in finish() once every CSV is written
            self.nonfinite.append(subject)
            logging.error("subject '%s': non-finite ECE (%s), finish() will "
                          "raise", subject, ece)
        corr = row["correction"]
        self.calib.on_subject({
            "bins_count": row["bins_count"].astype(np.int64),
            "bins_avg_confidence": row["bins_avg_confidence"],
            "bins_positive_fraction": row["bins_positive_fraction"],
            "bins_non_zero": row["bins_non_zero"],
            "ece": ece,
            "dice": float(row["dice"]),
        }, subject, self.run_id)
        self.ece.on_subject({k: ev_hooks.csv_value(k, row[k])
                             for k in _ECE_COLUMNS}, subject, self.run_id)
        for ti, hook in enumerate(self.corr):
            hook.on_subject({k: ev_hooks.csv_value(k, corr[k][ti])
                             for k in ev_hooks.CORRECTION_KEYS}, subject,
                            self.run_id)
        self.bounds["min"].append(float(row["conf_min"]))
        self.bounds["max"].append(float(row["conf_max"]))

    def finish(self):
        for hook in (self.calib, self.ece, *self.corr):
            hook.on_run_end(self.run_id)
        if self.bounds["min"]:
            ev_hooks.write_summary_csv(self.minmax_path, self.bounds)
        if self.nonfinite:
            raise ValueError(
                f"{len(self.nonfinite)} subject(s) produced a non-finite ECE: "
                f"{', '.join(self.nonfinite[:5])} — the subject's eval mask "
                "selected zero voxels. Every CSV was still written (NaN rows "
                "mark the affected subjects).")


def load_model(model_dir: str, test_at, device) -> torch.nn.Module:
    """The checkpoint's U-Net with its weights, on ``device``."""
    mf = ckpt_lib.ModelFiles.from_model_dir(model_dir)
    model_node, _ = ckpt_lib.load_model_parameters(mf)
    model = get_model(model_node.type, model_node.params)
    path = ckpt_lib.find_checkpoint_file(mf, test_at)
    if path is None:
        raise FileNotFoundError(f"no checkpoint '{test_at}' in {model_dir}")
    raw = ckpt_lib.load_checkpoint(path)
    model.load_state_dict(unet_state_dict_from_flax(raw["params"],
                                                    raw["batch_stats"]))
    return model.to(device)


def foreground_mask(dataset, subject, shape) -> np.ndarray:
    """BraTS t2>0 head-support mask from the RAW t2 NIfTI recorded in the
    store's files metadata (the stored channels are z-scored, so
    thresholding them would select above-mean voxels)."""
    t2_path = (dataset.files(subject) or {}).get("images", {}).get("t2")
    if not t2_path or not os.path.exists(t2_path):
        raise ValueError(
            f"subject '{subject}' has no raw t2 source file recorded in the "
            "store, so the foreground mask cannot be derived. Pass "
            "masked=False to evaluate unmasked.")
    arr, _ = nifti.read(t2_path)
    fg = np.squeeze(np.asarray(arr)) > 0
    if fg.shape != tuple(shape):
        raise ValueError(
            f"subject '{subject}': raw-t2 mask shape {fg.shape} does not "
            f"match the target shape {tuple(shape)}")
    return fg


def _check_mc_protocol(config, dataset):
    """Raise for the strategy families that are not ported yet (the JAX
    driver's auto-detection order)."""
    mf = ckpt_lib.ModelFiles.from_model_dir(config.model_dir)
    model_node, _ = ckpt_lib.load_model_parameters(mf)
    if model_node.params.get("sigma_out"):
        raise NotImplementedError("the aleatoric strategy is not ported yet")
    if config.others.get("model_dir") is not None:
        raise NotImplementedError(
            "ensemble/auxiliary_feat strategies are not ported yet")
    subject = dataset.subjects[0]
    if len(dataset.shape(subject, "images")) != 4:
        raise NotImplementedError("native-2D datasets are not ported yet")
    labels_shape = tuple(dataset.shape(subject, "labels"))
    if len(labels_shape) >= 4 and labels_shape[-1] == 2:
        raise NotImplementedError("the auxiliary_segm strategy is not ported yet")


def evaluate_direct(config, out_dir: str, run_id: str = "baseline",
                    mc: int = None, thresholds=DEFAULT_THRESHOLDS,
                    masked: bool = True, device=None) -> dict:
    """Fused inference + eval for every test-split subject of ``config``;
    writes the ``eval_calibration_*``, ``eval_ece_*``,
    ``eval_uncertainty_*_th*`` and ``eval_summary_minmax_*`` CSVs into
    ``out_dir`` and returns the per-subject ECE dict.

    ``mc`` counts the MC-dropout samples (default ``others.mc`` or 20;
    ``mc=0`` is the deterministic protocol). ``masked`` applies the BraTS
    t2>0 foreground mask to the ECE bins. Runs on ``cuda`` unless
    ``device`` says otherwise. Convolutions follow torch's TF32 setting:
    the f32 parity bar holds with ``torch.backends.cudnn.allow_tf32 =
    False``, which the CLI sets."""
    device = resolve_device(device)
    if mc is None:
        cfg_mc = config.others.get("mc")
        mc = 20 if cfg_mc is None else int(cfg_mc)
    subjects = None
    if config.split:
        _, _, subjects = load_split(config.split, config.others.get("split_k"))
        if not subjects:
            raise ValueError(f"no test subjects: split {config.split!r} has "
                             "an empty test set")
    databuild.build_transform(config.test_data.transform)
    dataset = databuild.build_data(config.test_data, subjects=subjects)
    try:
        _check_mc_protocol(config, dataset)
        test_at = "best" if config.test_at in (None, "") else config.test_at
        model = load_model(config.model_dir, test_at, device)
        return evaluate_subjects(model, dataset, out_dir, run_id=run_id,
                                 mc=int(mc),
                                 batch_size=config.test_data.batch_size,
                                 seed=config.seed, thresholds=thresholds,
                                 masked=masked, device=device)
    finally:
        dataset.close()


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu().numpy()


def evaluate_subjects(model, dataset, out_dir: str, *, run_id: str = "baseline",
                      mc: int = 20, batch_size: int = 32, seed: int = 20,
                      thresholds=DEFAULT_THRESHOLDS, masked: bool = True,
                      device=None) -> dict:
    """The direct eval's core over ``dataset.subjects`` (see module doc).

    Subject ``i``'s MC stream is ``(seed, i)`` (``eval.pipeline``)."""
    device = resolve_device(device)
    sinks = _EvalSinks(out_dir, run_id, thresholds)
    eces = {}
    for si, subject in enumerate(dataset.subjects):
        t0 = time.time()
        volume = np.asarray(dataset.read_volume(subject, "images"), np.float32)
        if volume.ndim != 4:
            raise NotImplementedError("native-2D datasets are not ported yet")
        labels = np.asarray(dataset.read_volume(subject, "labels"))
        if labels.ndim > 3:  # trailing channel axis -> the gt channel
            labels = labels[..., 0]
        target = labels > 0.5
        mask = foreground_mask(dataset, subject, target.shape) if masked \
            else np.ones(target.shape, bool)
        out = pipeline.volume_mc_eval(
            model, mc, batch_size, torch.from_numpy(volume).to(device),
            torch.from_numpy(target).to(device),
            torch.from_numpy(mask).to(device), thresholds, rng=(seed, si))
        row = _to_host(out)
        sinks.write_subject(subject, row)
        eces[subject] = float(row["ece"])
        logging.info("direct eval %s ece=%.5f (%.2fs)", subject,
                     eces[subject], time.time() - t0)
    sinks.finish()
    return eces
