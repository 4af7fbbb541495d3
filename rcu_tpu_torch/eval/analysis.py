"""The offline eval's subject loader and preparation pipelines
(``rcu_tpu.eval.analysis`` counterparts).

The :class:`Loader` reads a subject's files on the host (numpy NIfTI, PIL
for the ISIC PNGs) and caches them while the subject lasts. The
preparation steps are torch ops on the tensors of the pass's device; the
``get_*_preparation`` builders give the result-id suffixes the analysis
layer keys on (``_rescale``, ``_globalrescale``).
"""
from __future__ import annotations

import csv
import os

import numpy as np

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.ops import prepare as prep_ops
from rcu_tpu_torch.utils import labels as label_lib


def read_image(path: str):
    """NIfTI for volumes, PIL for 2-D png/jpg (the ISIC ground truth)."""
    lower = str(path).lower()
    if lower.endswith((".png", ".jpg", ".jpeg", ".bmp")):
        from PIL import Image
        arr = np.asarray(Image.open(path))
        return arr, nifti.ImageProperties(size=(arr.shape[1], arr.shape[0]))
    return nifti.read(path)


def read_min_max(min_max_file: str):
    with open(min_max_file, "r") as f:
        reader = csv.reader(f)
        next(reader)
        _, min_, max_ = next(reader)
    return float(min_), float(max_)


class Loader:
    """Per-subject cached host reads for the offline eval.

    ``get_data`` takes the confidence ``entry`` of the prediction artifacts
    and switches for the derived arrays; a subject's arrays are served
    from the cache until a subject (or artifact path) changes."""

    def __init__(self):
        self.cached_entries = {}
        self.cached_subject_id = None

    def get_data(self, subject_file, entry: str = "probabilities", *,
                 target: bool = True, prediction: bool = True,
                 t2_mask: bool = False, borders: tuple = (),
                 images: tuple = (), properties: bool = False) -> dict:
        """The ``to_eval`` dict of numpy arrays for one subject.

        ``borders`` may name ``"target"`` and/or ``"prediction"``; each
        adds ``<name>_border`` (EDT band mask) and ``<name>_distance``.
        ``images`` lists raw image entries (e.g. ``("t2",)``) to include."""
        ident = (subject_file.subject,
                 tuple(sorted(subject_file.flat_entries().items())))
        if ident != self.cached_subject_id:
            self.cached_entries.clear()
            self.cached_subject_id = ident

        to_eval = {}
        misc_np, props = self._get_misc(subject_file, entry)
        to_eval[entry] = misc_np
        if properties:
            to_eval["img_properties"] = props
        if target:
            to_eval["target"] = self._get_target(subject_file)
        if prediction:
            to_eval["prediction"] = self._get_prediction(subject_file)
        for which in borders:
            mask, distance = self._get_dist_and_border(subject_file, which)
            to_eval[f"{which}_border"] = mask
            to_eval[f"{which}_distance"] = distance
        if t2_mask:
            to_eval["mask"] = self._get_t2_mask(subject_file)
        for image_type in images:
            to_eval[image_type] = self._get_image(subject_file, image_type)
        return to_eval

    def _cached(self, key, fn):
        if key not in self.cached_entries:
            self.cached_entries[key] = fn()
        value = self.cached_entries[key]
        return value.copy() if isinstance(value, np.ndarray) else value

    def _get_misc(self, sf, entry):
        def load():
            return read_image(sf.categories["misc"].entries[entry])
        arr, props = self._cached(f"misc:{entry}", load)
        return arr.copy(), props

    def _get_target(self, sf):
        def load():
            arr, _ = read_image(sf.categories["labels"].entries["gt"])
            arr = arr.astype(np.uint8)
            arr[arr > 0] = 1  # labels 0..4 or {0, 255} -> binary
            return arr
        return self._cached("target", load)

    def _get_prediction(self, sf):
        def load():
            arr, _ = read_image(sf.categories["labels"].entries["prediction"])
            return arr.astype(np.uint8)
        return self._cached("prediction", load)

    def _get_image(self, sf, entry):
        def load():
            return read_image(sf.categories["images"].entries[entry])[0]
        return self._cached(f"image:{entry}", load)

    def _get_t2_mask(self, sf):
        def load():
            return read_image(sf.categories["images"].entries["t2"])[0] > 0
        return self._cached("t2mask", load)

    def _get_dist_and_border(self, sf, which):
        key_b, key_d = f"{which}_border", f"{which}_distance"
        if key_b not in self.cached_entries:
            base = self._get_target(sf) if which == "target" \
                else self._get_prediction(sf)
            distance, mask = label_lib.border_mask(base.astype(bool),
                                                   distance_in=1, distance_out=1)
            self.cached_entries[key_b] = mask
            self.cached_entries[key_d] = distance
        return self.cached_entries[key_b].copy(), self.cached_entries[key_d].copy()


# ---------------------------------------------------------------------------
# prepare pipeline (functions of the to_eval dict of tensors)
# ---------------------------------------------------------------------------

class ComposePreparation:
    def __init__(self, prepare_data_list: list):
        self.prepare_data_list = list(prepare_data_list)

    def __call__(self, to_eval: dict) -> dict:
        for p in self.prepare_data_list:
            to_eval = p(to_eval)
        return to_eval


class AddBackgroundProbabilities:
    def __call__(self, to_eval):
        prep_ops.check_min_max(to_eval["probabilities"])
        to_eval["probabilities"] = prep_ops.add_background_probability(
            to_eval["probabilities"])
        return to_eval


class RescaleLinear:
    def __init__(self, entry, min_, max_, epsilon=1e-5):
        self.entry, self.min, self.max, self.epsilon = entry, min_, max_, epsilon

    def __call__(self, to_eval):
        to_eval[self.entry] = prep_ops.rescale_linear(
            to_eval[self.entry], self.min, self.max, self.epsilon)
        return to_eval


class RescaleSubjectMinMax:
    def __init__(self, entry, epsilon=1e-5):
        self.entry, self.epsilon = entry, epsilon

    def __call__(self, to_eval):
        to_eval[self.entry] = prep_ops.rescale_subject_min_max(
            to_eval[self.entry], self.epsilon)
        return to_eval


class ToForegroundProbabilities:
    """Fold a [0, 1] uncertainty map by the prediction; a map out of range
    (e.g. a sigma map not rescaled) or a non-binary prediction raises."""

    def __call__(self, to_eval):
        uncertainty = to_eval["probabilities"]
        prediction = to_eval["prediction"]
        if uncertainty.shape != prediction.shape:
            raise ValueError(f"shapes must agree. Found {tuple(uncertainty.shape)} "
                             f"and {tuple(prediction.shape)}")
        prep_ops.check_min_max(uncertainty)
        if int(prediction.max()) > 1:
            raise ValueError("Found class larger than 1. Only works for "
                             "binary problems")
        to_eval["probabilities"] = \
            prep_ops.uncertainty_to_foreground_probabilities(uncertainty,
                                                             prediction)
        return to_eval


class ToEntropy:
    def __init__(self, entropy_entry="uncertainty"):
        self.entropy_entry = entropy_entry

    def __call__(self, to_eval):
        to_eval[self.entropy_entry] = prep_ops.normalized_entropy(
            to_eval["probabilities"], 2)
        # float noise can push the entropy a hair past 1: warn, not fail
        prep_ops.check_min_max(to_eval[self.entropy_entry], only_warn=True)
        return to_eval


class MoveEntry:
    def __init__(self, from_entry, to_entry):
        self.from_entry, self.to_entry = from_entry, to_entry

    def __call__(self, to_eval):
        to_eval[self.to_entry] = to_eval[self.from_entry]
        return to_eval


def _get_rescale_prep_and_idstr(eval_data, rescale_type: str,
                                min_max_dir: str = None):
    """'' | 'subject' (-> '_rescale') | 'global' (-> '_globalrescale',
    the bounds of the run's minmax CSV)."""
    if rescale_type == "global":
        min_max_path = os.path.join(
            min_max_dir, dirs.MINMAX_PLACEHOLDER.format(eval_data.id_))
        min_, max_ = read_min_max(min_max_path)
        return RescaleLinear(eval_data.confidence_entry, min_, max_), "_globalrescale"
    if rescale_type == "subject":
        return RescaleSubjectMinMax(eval_data.confidence_entry), "_rescale"
    return None, ""


def get_probability_preparation(eval_data, rescale_confidence="subject",
                                rescale_sigma="subject", min_max_dir=None):
    """The confidence entry -> two-class probabilities; -> (preparation,
    result id)."""
    prepare = []
    if eval_data.confidence_entry == "probabilities":
        prepare.append(AddBackgroundProbabilities())
        return ComposePreparation(prepare), eval_data.id_
    rescale_type = rescale_confidence if eval_data.confidence_entry == "confidence" \
        else rescale_sigma
    id_ = eval_data.id_
    prep, prep_id = _get_rescale_prep_and_idstr(eval_data, rescale_type, min_max_dir)
    if prep is not None:
        prepare.append(prep)
        id_ += prep_id
    prepare.extend([MoveEntry(eval_data.confidence_entry, "probabilities"),
                    ToForegroundProbabilities(),
                    AddBackgroundProbabilities()])
    return ComposePreparation(prepare), id_


def get_uncertainty_preparation(eval_data, rescale_confidence="",
                                rescale_sigma="global", min_max_dir=None):
    """The confidence entry -> a [0, 1] uncertainty map; -> (preparation,
    result id)."""
    prepare = []
    if eval_data.confidence_entry == "probabilities":
        prepare.append(AddBackgroundProbabilities())
        prepare.append(ToEntropy())
        return ComposePreparation(prepare), eval_data.id_
    rescale_type = rescale_confidence if eval_data.confidence_entry == "confidence" \
        else rescale_sigma
    id_ = eval_data.id_
    prep, prep_id = _get_rescale_prep_and_idstr(eval_data, rescale_type, min_max_dir)
    if prep is not None:
        prepare.append(prep)
        id_ += prep_id
    prepare.append(MoveEntry(eval_data.confidence_entry, "uncertainty"))
    return ComposePreparation(prepare), id_


def get_confidence_entry_preparation(eval_data, to_entry):
    return MoveEntry(eval_data.confidence_entry, to_entry), eval_data.id_
