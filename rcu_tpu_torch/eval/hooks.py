"""Eval CSV writers with the exact schemas of ``rcu_tpu.eval.hooks``, and the
correction row's column contract of ``rcu_tpu.eval.actions``.

A writer takes a run's rows through ``on_run_start``, ``on_subject`` and
``on_run_end(results_history, run_id)``; it writes its file at the run's
end.
- array results unfold into zero-padded indexed columns
  ``{key}_{i:0{nb_digits}d}`` (e.g. ``bins_count_00`` .. ``bins_count_09``);
- bins CSVs re-expand masked bins to the fixed 10 columns with zeros;
- summary (minmax) CSVs have header ``confidence_entry,min,max`` and one
  row: the min of the subjects' minima, the max of their maxima.
"""
from __future__ import annotations

import csv
import os

import numpy as np

# CSV column order of the correction result rows
CORRECTION_KEYS = (
    "tpu", "tnu", "fpu", "fnu", "tp", "tn", "fp", "fn",
    "dice_benefit", "accuracy_benefit", "dice", "accuracy",
    "corrected_dice", "corrected_accuracy",
    "dice_benefit_correct", "accuracy_benefit_correct",
    "corrected_add_dice", "corrected_add_accuracy",
)
_COUNT_KEYS = {"tpu", "tnu", "fpu", "fnu", "tp", "tn", "fp", "fn", "n"}
_BOOL_KEYS = {"dice_benefit", "accuracy_benefit", "dice_benefit_correct",
              "accuracy_benefit_correct"}


def csv_value(key: str, value):
    """Host scalar -> the python type the CSV column carries."""
    v = np.asarray(value)
    if key in _COUNT_KEYS:
        return int(v)
    if key in _BOOL_KEYS:
        return bool(v)
    return float(v)


class EvalHook:
    def on_run_start(self, run_id: str):
        pass

    def on_subject(self, results: dict, subject_name: str, run_id: str):
        pass

    def on_run_end(self, results_history: dict, run_id: str):
        pass


class WriteCsvHook(EvalHook):
    """One row per subject; the header comes from the first row's keys
    unless ``entries`` fixes it."""

    def __init__(self, file_path: str, entries=None):
        self.file_path = file_path
        self.rows = []
        self.entries = None if entries is None else list(entries)
        self.header = None

    @staticmethod
    def _unfold_results(results: dict) -> dict:
        unfolded = {}
        for key, value in results.items():
            if isinstance(value, np.ndarray):
                value = value.tolist()
            if isinstance(value, (list, tuple)):
                nb_digits = len(str(len(value)))
                for i, v in enumerate(value):
                    unfolded[f"{key}_{i:0{nb_digits}d}"] = v
            else:
                unfolded[key] = value
        return unfolded

    def on_subject(self, results: dict, subject_name: str, run_id: str):
        results = self._unfold_results(results)
        if self.entries is None:
            self.entries = list(results.keys())
        if self.header is None:
            self.header = ["test_id", "subject_name"] + self.entries
        missing = [e for e in self.entries if e not in results]
        if missing:
            raise KeyError(
                f"subject '{subject_name}' is missing result entries {missing} "
                f"required by the CSV header of {self.file_path}")
        self.rows.append([run_id, subject_name]
                         + [results[e] for e in self.entries])

    def on_run_end(self, results_history: dict, run_id: str):
        os.makedirs(os.path.dirname(self.file_path), exist_ok=True)
        with open(self.file_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(self.header or (["test_id", "subject_name"]
                                            + (self.entries or [])))
            writer.writerows(self.rows)


class WriteBinsCsvHook(WriteCsvHook):
    """Bins given for the nonzero bins only expand to the fixed-width
    columns, zeros elsewhere; full-length bins pass as they are."""

    def on_subject(self, results: dict, subject_name: str, run_id: str):
        non_zero = np.asarray(results["bins_non_zero"])
        for key in ("bins_count", "bins_avg_confidence", "bins_positive_fraction"):
            value = np.asarray(results[key])
            if value.shape != non_zero.shape:  # compressed -> expand
                expanded = np.zeros_like(non_zero, dtype=value.dtype)
                expanded[non_zero] = value
                results[key] = expanded
            else:
                results[key] = value
        super().on_subject(results, subject_name, run_id)


class WriteSummaryCsvHook(EvalHook):
    """The run's summary row: ``summary_fn`` of each entry's history."""

    def __init__(self, file_path: str, entries=("min", "max"),
                 summary_fn=(np.min, np.max), confidence_entry="probabilities"):
        if len(entries) != len(summary_fn):
            raise ValueError("entries and summary_fn must be of same length")
        self.file_path = file_path
        self.entries = list(entries)
        self.summary_fn = list(summary_fn)
        self.confidence_entry = confidence_entry

    def on_run_end(self, results_history: dict, run_id: str):
        os.makedirs(os.path.dirname(self.file_path), exist_ok=True)
        with open(self.file_path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["confidence_entry"] + self.entries)
            summary = [fn(results_history[e])
                       for e, fn in zip(self.entries, self.summary_fn)]
            writer.writerow([self.confidence_entry] + summary)
