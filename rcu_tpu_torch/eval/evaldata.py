"""The offline eval's run registry (``rcu_tpu.eval.evaldata`` counterpart):
the 8 strategy ids -> their prediction dirs (``directories``) and
confidence entry ('probabilities' | 'confidence' | 'sigma'), joined with
the ground truth; the BraTS predictions must be the test split's
subjects, the ISIC ones the ground truth's."""
from __future__ import annotations

import os
import typing

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data import collector as collect
from rcu_tpu_torch.data import split as split_lib


class EvalData:
    def __init__(self, id_, eval_path, confidence_entry: str = "probabilities",
                 subject_files=None):
        self.id_ = id_
        self.eval_path = eval_path
        self.confidence_entry = confidence_entry
        self.subject_files = subject_files if subject_files is not None else []


def _registry(predict_dir, names):
    return {key: EvalData(key, os.path.join(predict_dir, sub_dir), entry)
            for key, (sub_dir, entry) in names.items()}


def brats_eval_data():
    return _registry(dirs.BRATS_PREDICT_DIR, {
        "baseline": (dirs.BRATS_BASELINE_PREDICT, "probabilities"),
        "baseline_mc": (dirs.BRATS_BASELINE_MC_PREDICT, "probabilities"),
        "center": (dirs.BRATS_CENTER_PREDICT, "probabilities"),
        "center_mc": (dirs.BRATS_CENTER_MC_PREDICT, "probabilities"),
        "ensemble": (dirs.BRATS_ENSEMBLE_PREDICT, "probabilities"),
        "auxiliary_feat": (dirs.BRATS_AUX_FEAT_PREDICT, "confidence"),
        "auxiliary_segm": (dirs.BRATS_AUX_SEGM_PREDICT, "confidence"),
        "aleatoric": (dirs.BRATS_ALEATORIC_PREDICT, "sigma"),
    })


def isic_eval_data():
    return _registry(dirs.ISIC_PREDICT_DIR, {
        "baseline": (dirs.ISIC_BASELINE_PREDICT, "probabilities"),
        "baseline_mc": (dirs.ISIC_BASELINE_MC_PREDICT, "probabilities"),
        "center": (dirs.ISIC_CENTER_PREDICT, "probabilities"),
        "center_mc": (dirs.ISIC_CENTER_MC_PREDICT, "probabilities"),
        "ensemble": (dirs.ISIC_ENSEMBLE_PREDICT, "probabilities"),
        "auxiliary_feat": (dirs.ISIC_AUX_FEAT_PREDICT, "confidence"),
        "auxiliary_segm": (dirs.ISIC_AUX_SEGM_PREDICT, "confidence"),
        "aleatoric": (dirs.ISIC_ALEATORIC_PREDICT, "sigma"),
    })


def _with_predictions(entry: EvalData, gt_subject_files):
    prediction_collector = collect.PostfixPredictionCollector(
        entry.eval_path, ["prediction", entry.confidence_entry],
        ["labels", "misc"])
    return collect.combine(gt_subject_files,
                           prediction_collector.get_subject_files())


def _check_subjects(entry, combined, want):
    """The joined predictions must be exactly ``want``: a raise, not an
    ``assert`` (``-O`` drops those), with the difference named."""
    have = set(sf.subject for sf in combined)
    if have != set(want):
        raise ValueError(
            f"run '{entry.id_}' ({entry.eval_path}): the predicted subjects "
            f"differ from the expected set: missing {sorted(set(want) - have)}, "
            f"extra {sorted(have - set(want))}")


def get_brats_data(eval_data: typing.Union[EvalData, list],
                   in_dir: str = None, split_file: str = None):
    """Join the ground truth with each run's predictions; the predictions
    must be the split's test subjects."""
    in_dir = in_dir or dirs.BRATS_ORIG_DATA_DIR
    split_file = split_file or os.path.join(dirs.SPLITS_DIR,
                                            "split_brats18_100-25-160.json")
    was_list = not isinstance(eval_data, EvalData)
    eval_data = list(eval_data) if was_list else [eval_data]
    gt_subject_files = collect.Brats17Collector(in_dir).get_subject_files()
    _, _, test_subjects = split_lib.load_split(split_file)
    for entry in eval_data:
        combined = _with_predictions(entry, gt_subject_files)
        _check_subjects(entry, combined, test_subjects)
        entry.subject_files = combined
    return eval_data if was_list else eval_data[0]


def get_isic_data(eval_data: typing.Union[EvalData, list], in_dir: str = None):
    """Join the ISIC ground truth with each run's predictions; every ground
    truth image must have its predictions."""
    in_dir = in_dir or dirs.ISIC_PREPROCESSED_TEST_DATA_DIR
    was_list = not isinstance(eval_data, EvalData)
    eval_data = list(eval_data) if was_list else [eval_data]
    gt_subject_files = collect.IsicCollector(in_dir).get_subject_files()
    for entry in eval_data:
        combined = _with_predictions(entry, gt_subject_files)
        _check_subjects(entry, combined, [sf.subject for sf in gt_subject_files])
        entry.subject_files = combined
    return eval_data if was_list else eval_data[0]


def get_brats_eval_data(to_eval: list, **kw):
    reg = brats_eval_data()
    return get_brats_data([reg[e] for e in to_eval], **kw)


def get_isic_eval_data(to_eval: list, **kw):
    reg = isic_eval_data()
    return get_isic_data([reg[e] for e in to_eval], **kw)
