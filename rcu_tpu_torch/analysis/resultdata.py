"""Eval CSV discovery and the strategies' display names (the port's copy of
``rcu_tpu.analysis.resultdata``, over ``rcu_tpu_torch.directories``).

Globs the eval dirs for the CSV filename contracts and maps
``{result_id: {category: file | {threshold: file}}}``. Result ids carry the
``_rescale`` / ``_globalrescale`` suffixes of the eval preparation.
"""
from __future__ import annotations

import collections
import glob
import os
import re
import warnings

from rcu_tpu_torch import directories as dirs

brats_selection_id_name_dict = {
    "baseline": "baseline",
    "center": "center",
    "baseline_mc": "baseline+MC",
    "center_mc": "center+MC",
    "ensemble": "ensemble",
    "auxiliary_feat_rescale": "auxiliary feat.",
    "auxiliary_segm_rescale": "auxiliary segm.",
    "aleatoric_globalrescale": "aleatoric",
}

isic_selection_id_name_dict = dict(brats_selection_id_name_dict)


def _files_in_dir(base_dir: str, dir_name: str, placeholder: str) -> dict:
    directory = os.path.join(base_dir, dir_name)
    pattern = placeholder.replace("{}", "*")
    regex = re.compile("^" + placeholder.replace(".", r"\.")
                       .replace("{}", "(.*)") + "$")
    has_threshold = placeholder.count("{}") == 2

    out: dict = {}
    for path in sorted(glob.glob(os.path.join(directory, pattern))):
        m = regex.match(os.path.basename(path))
        if not m:
            continue
        if has_threshold:
            out.setdefault(m.group(1), {})[m.group(2)] = path
        else:
            out[m.group(1)] = path
    return out


class ResultsData:
    """Discovery over one dataset's eval dir; ``ece_category`` differs between
    brats (ece_foreground) and isic (ece)."""

    def __init__(self, base_dir: str, ece_category: str):
        self.base_dir = base_dir
        self.ece_category = ece_category
        self.category_dict = {
            dirs.CALIB_NAME: _files_in_dir(base_dir, dirs.CALIB_NAME,
                                           dirs.CALIBRATION_PLACEHOLDER),
            ece_category: _files_in_dir(base_dir, ece_category,
                                        dirs.ECE_PLACEHOLDER),
            dirs.MINMAX_NAME: _files_in_dir(base_dir, dirs.MINMAX_NAME,
                                            dirs.MINMAX_PLACEHOLDER),
            dirs.UNCERTAINTY_NAME: _files_in_dir(base_dir, dirs.UNCERTAINTY_NAME,
                                                 dirs.UNCERTAINTY_PLACEHOLDER),
        }
        self.id_category_dict: dict = {}
        for category, id_files in self.category_dict.items():
            for id_, f in id_files.items():
                self.id_category_dict.setdefault(id_, {})[category] = f

    def get_files(self, ids: list, categories: list, thresholds: list = None):
        out = []
        for id_ in ids:
            if id_ not in self.id_category_dict:
                warnings.warn(f'missing id "{id_}"')
                continue
            for category in categories:
                if category not in self.id_category_dict[id_]:
                    warnings.warn(f'missing category "{category}" in id "{id_}"')
                    continue
                entry = self.id_category_dict[id_][category]
                if isinstance(entry, dict):
                    if thresholds is None:
                        items = sorted(entry.items())
                    else:
                        for t in thresholds:
                            if t not in entry:
                                # a silently dropped threshold makes a
                                # plot or table with fewer curves read as
                                # complete
                                warnings.warn(
                                    f'missing threshold "{t}" in category '
                                    f'"{category}" in id "{id_}"')
                        items = [(t, entry[t]) for t in thresholds
                                 if t in entry]
                    for threshold, f in items:
                        out.append((f, id_, category, threshold))
                else:
                    out.append((entry, id_, category, None))
        if not out:
            return (), (), (), ()
        files, file_ids, file_categories, file_thresholds = zip(*out)
        return files, file_ids, file_categories, file_thresholds

    def get_ids(self):
        return list(self.id_category_dict.keys())

    def get_categories(self):
        return list(self.category_dict.keys())


class BratsResultData(ResultsData):
    def __init__(self, base_dir=None):
        super().__init__(base_dir or dirs.BRATS_EVAL_DIR, dirs.ECE_FOREGROUND_NAME)


class IsicResultData(ResultsData):
    def __init__(self, base_dir=None):
        super().__init__(base_dir or dirs.ISIC_EVAL_DIR, dirs.ECE_NAME)


def selection(task: str):
    """(the dataset's :class:`ResultsData`, the paper's {result id: display
    name} in table order) of ``"brats"``; any other task is ISIC's, as in
    the JAX tools."""
    if task == "brats":
        return BratsResultData(), collections.OrderedDict(
            brats_selection_id_name_dict)
    return IsicResultData(), collections.OrderedDict(
        isic_selection_id_name_dict)
