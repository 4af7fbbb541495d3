"""The offline eval's metric passes (``rcu_tpu.eval.actions`` counterpart;
the CLI is ``cli.eval_uncertainty``).

A pass is one load-prepare-reduce unit over a run's subjects: a Loader
request, a preparation pipeline (rescales, fold, two-class stack,
entropy), a reduction and its CSV sinks. The subject's host arrays go to
the pass's device as tensors; preparation is torch ops there, and each of
the ``ece_dice``, ``calib`` and ``bnf_ue`` passes is one launch of the
hand-written eval kernel a subject (``eval.kernels``; all 11 thresholds
of ``bnf_ue`` in that one launch), ``minmax`` one ``torch.aminmax``.
On a mesh (``get_actions(mesh=)``) each of those is one launch (one
``aminmax``) per data device on its share of the voxels, the sums added
on the first device (``parallel.inference.ShardedSubjectEval``).

The four-step protocol (``setup_eval``, ``start_eval``, ``eval_subject``,
``finish_eval``) and the CSV names, columns and result-id suffixes are the
JAX package's.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.eval import analysis, hooks as ev_hooks, kernels
from rcu_tpu_torch.eval.direct import resolve_device
from rcu_tpu_torch.eval.evaldata import EvalData
from rcu_tpu_torch.eval.hooks import CORRECTION_KEYS, csv_value
from rcu_tpu_torch.parallel.inference import ShardedSubjectEval

ALL_THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)

def _on(device, sample: dict) -> dict:
    """The Loader's numpy arrays as tensors on ``device``; other values
    (image properties) as they are."""
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray)
            else v for k, v in sample.items()}


class MetricPass:
    """A configurable eval pass. ``configure(pass_, eval_data)`` is called
    once per run (when the run's confidence entry and result id are known)
    and sets ``id_``, ``load_spec``, ``prepare``, ``sinks`` and
    ``measure`` (the prepared tensors -> one row dict per sink).

    ``kern`` is the reductions' suite: ``eval.kernels`` on ``device``, or
    with a ``mesh`` ``parallel.inference.ShardedSubjectEval`` (the
    subject prepared on the mesh's first device, its voxels split over
    the data devices, one kernel launch each)."""

    def __init__(self, configure, device=None, mesh=None):
        self._configure = configure
        self.device = resolve_device(device if mesh is None
                                     else mesh.devices[0])
        self.kern = kernels if mesh is None else ShardedSubjectEval(mesh)
        self.id_ = ""
        self.load_spec = {}
        self.prepare = None
        self.sinks = ()
        self.measure = None
        self._history = {}

    def setup_eval(self, eval_data: EvalData):
        # a pass is reused across runs: the history starts empty, or run N's
        # summary (the minmax bounds) would take in every earlier run's
        self._history = {}
        self._configure(self, eval_data)

    def start_eval(self):
        print(self.id_)
        for sink in self.sinks:
            sink.on_run_start(self.id_)

    def eval_subject(self, sf, loader: analysis.Loader):
        sample = _on(self.device, loader.get_data(sf, **self.load_spec))
        if self.prepare:
            sample = self.prepare(sample)
        rows = self.measure(sample)
        for sink, row in zip(self.sinks, rows):
            sink.on_subject(row, sf.subject, self.id_)
            for key, value in row.items():
                self._history.setdefault(key, []).append(value)

    def finish_eval(self):
        for sink in self.sinks:
            sink.on_run_end(self._history, self.id_)


def _host(out: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in out.items()}


def minmax_pass(min_max_dir: str, device=None, mesh=None) -> MetricPass:
    """Min and max of the run's confidence entry; its summary CSV is what
    every ``global`` rescale pass reads."""
    os.makedirs(min_max_dir, exist_ok=True)

    def configure(p, eval_data):
        prep, p.id_ = analysis.get_confidence_entry_preparation(
            eval_data, "probabilities")
        p.prepare = analysis.ComposePreparation([prep])
        p.load_spec = {"entry": eval_data.confidence_entry}
        p.sinks = (ev_hooks.WriteSummaryCsvHook(
            os.path.join(min_max_dir, dirs.MINMAX_PLACEHOLDER.format(p.id_)),
            confidence_entry=eval_data.confidence_entry),)

        def measure(sample):
            out = _host(p.kern.min_max(sample["probabilities"]))
            return [{"min": float(out["min"]), "max": float(out["max"])}]
        p.measure = measure

    return MetricPass(configure, device, mesh)


def _masked(details: str) -> bool:
    return details == "foreground"


def ece_pass(base_dir: str, details: str, rescale_confidence="subject",
             rescale_sigma="subject", min_max_dir: str = None,
             device=None, mesh=None) -> MetricPass:
    """ECE (on the t2 foreground for BraTS), Dice and confusion counts."""
    masked = _masked(details)
    out_dir = os.path.join(
        base_dir, dirs.ECE_FOREGROUND_NAME if masked else dirs.ECE_NAME)
    os.makedirs(out_dir, exist_ok=True)
    columns = ("ece", "dice", "tp", "tn", "fp", "fn", "n")

    def configure(p, eval_data):
        p.prepare, p.id_ = analysis.get_probability_preparation(
            eval_data, rescale_confidence=rescale_confidence,
            rescale_sigma=rescale_sigma, min_max_dir=min_max_dir)
        p.load_spec = {"entry": eval_data.confidence_entry, "t2_mask": masked}
        p.sinks = (ev_hooks.WriteCsvHook(
            os.path.join(out_dir, dirs.ECE_PLACEHOLDER.format(p.id_)),
            entries=columns),)

        def measure(sample):
            out = _host(p.kern.ece_dice_confusion(
                sample["probabilities"], sample["target"],
                sample["prediction"], sample["mask"] if masked else None))
            return [{k: csv_value(k, out[k]) for k in columns}]
        p.measure = measure

    return MetricPass(configure, device, mesh)


def calibration_pass(base_dir: str, details: str = "",
                     rescale_confidence="subject", rescale_sigma="subject",
                     min_max_dir: str = None, device=None,
                     mesh=None) -> MetricPass:
    """ECE, the 4 x 10 reliability-bin columns (``bins_*_00..09``) and
    Dice."""
    masked = _masked(details)
    out_dir = os.path.join(base_dir, dirs.CALIB_NAME)
    os.makedirs(out_dir, exist_ok=True)

    def configure(p, eval_data):
        p.prepare, p.id_ = analysis.get_probability_preparation(
            eval_data, rescale_confidence=rescale_confidence,
            rescale_sigma=rescale_sigma, min_max_dir=min_max_dir)
        p.load_spec = {"entry": eval_data.confidence_entry, "t2_mask": masked}
        p.sinks = (ev_hooks.WriteBinsCsvHook(os.path.join(
            out_dir, dirs.CALIBRATION_PLACEHOLDER.format(p.id_))),)

        def measure(sample):
            out = _host(p.kern.calibration_bins(
                sample["probabilities"], sample["target"],
                sample["prediction"], sample["mask"] if masked else None))
            # the bin vectors first, then ece, then dice: the column order
            # of the CSV contract
            return [{
                "bins_count": out["bins_count"].astype(np.int64),
                "bins_avg_confidence": out["bins_avg_confidence"],
                "bins_positive_fraction": out["bins_positive_fraction"],
                "bins_non_zero": out["bins_non_zero"],
                "ece": float(out["ece"]),
                "dice": float(out["dice"]),
            }]
        p.measure = measure

    return MetricPass(configure, device, mesh)


def threshold_codes(thresholds) -> list:
    """The two-decimal codes of the thresholds in the CSV names; codes that
    collide (0.125 and 0.12) would overwrite each other's file, so they
    raise ``ValueError``."""
    codes = [f"{t:.2f}".replace(".", "") for t in thresholds]
    if len(set(codes)) != len(codes):
        raise ValueError(
            f"thresholds {tuple(thresholds)} collide in the two-decimal CSV "
            f"filename encoding ({codes}); choose thresholds distinct at "
            "two decimals")
    return codes


def correction_pass(thresholds, base_dir: str, rescale_confidence="",
                    rescale_sigma="global", min_max_dir: str = None,
                    device=None, mesh=None) -> MetricPass:
    """The uncertainty / correction analysis: every threshold's row from
    one kernel launch, one CSV sink per threshold."""
    thresholds = tuple(thresholds)
    codes = threshold_codes(thresholds)
    out_dir = os.path.join(base_dir, dirs.UNCERTAINTY_NAME)
    os.makedirs(out_dir, exist_ok=True)

    def configure(p, eval_data):
        p.prepare, p.id_ = analysis.get_uncertainty_preparation(
            eval_data, rescale_confidence=rescale_confidence,
            rescale_sigma=rescale_sigma, min_max_dir=min_max_dir)
        p.load_spec = {"entry": eval_data.confidence_entry}
        p.sinks = tuple(
            ev_hooks.WriteCsvHook(os.path.join(
                out_dir, dirs.UNCERTAINTY_PLACEHOLDER.format(p.id_, code)), None)
            for code in codes)

        def measure(sample):
            out = _host(p.kern.correction_eval(
                sample["prediction"], sample["target"], sample["uncertainty"],
                thresholds))
            return [{k: csv_value(k, out[k][ti]) for k in CORRECTION_KEYS}
                    for ti in range(len(thresholds))]
        p.measure = measure

    return MetricPass(configure, device, mesh)


_PASS_BUILDERS = {
    "minmax": lambda min_max_dir, base_dir, details, **where:
        minmax_pass(min_max_dir, **where),
    "ece_dice": lambda min_max_dir, base_dir, details, **where:
        ece_pass(base_dir, details, rescale_confidence="subject",
                 rescale_sigma="global", min_max_dir=min_max_dir, **where),
    "calib": lambda min_max_dir, base_dir, details, **where:
        calibration_pass(base_dir, details, rescale_confidence="subject",
                         rescale_sigma="global", min_max_dir=min_max_dir,
                         **where),
    "bnf_ue": lambda min_max_dir, base_dir, details, **where:
        correction_pass(ALL_THRESHOLDS, base_dir,
                        rescale_confidence="subject", rescale_sigma="global",
                        min_max_dir=min_max_dir, **where),
}


def get_actions(action_names, min_max_dir, base_dir, ece_details, mesh=None,
                device=None):
    """The passes of ``action_names`` (unknown names are skipped, as in the
    JAX package), on ``device`` (default cuda), or with ``mesh`` sharded
    over it (:class:`MetricPass`)."""
    return [_PASS_BUILDERS[name](min_max_dir, base_dir, ece_details,
                                 device=device, mesh=mesh)
            for name in action_names if name in _PASS_BUILDERS]
