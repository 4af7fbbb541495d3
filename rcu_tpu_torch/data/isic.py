"""ISIC-2017 image-folder dataset (``rcu_tpu.data.isic.IsicFolderDataset``
counterpart), with the read interface of ``data.h5.SubjectDataset``
(``subjects``, ``shape``, ``read_volume``, ``files``, ``close``) so that
the direct eval and training's loader take either. Each subject is one
2-D image, its own single index (``read_slice`` is ``read_volume``).

- images are the resized jpg/png files, read as RGB uint8 (H, W, 3);
- labels are the ``*_segmentation.png`` masks with values {0, 255}; the
  config's ``rescale`` transform maps them to [0, 1], not this class;
- with ``prediction_dir``, each subject's baseline prediction
  (``<subject>_prediction.nii.gz``, 0/1) joins the labels as a second
  channel, multiplied by 255 to share the gt's range before the rescale
  (the reference's quirk, kept).

PIL is imported inside the methods that read images, never at module top:
the card's machine may lack it.
"""
from __future__ import annotations

import os

import numpy as np

from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.data.collector import IsicCollector


def _open(path):
    from PIL import Image
    return Image.open(path)


class IsicFolderDataset:
    def __init__(self, root_dir: str, subject_subset=None,
                 with_superpixels: bool = False, prediction_dir: str = None):
        self.dataset_path = root_dir
        collector = IsicCollector(root_dir, with_superpixels)
        self._subject_files = {sf.subject: sf
                               for sf in collector.get_subject_files()}
        subjects = sorted(self._subject_files)
        if subject_subset is not None:
            subset = set(subject_subset)
            missing = subset - set(subjects)
            if missing:
                raise ValueError(f"subjects not in dataset: {sorted(missing)}")
            subjects = [s for s in subjects if s in subset]
        self.subjects = subjects
        self.subject_subset = list(subjects)
        self.prediction_dir = prediction_dir
        self.with_superpixels = with_superpixels

    def categories(self, subject: str = None):
        cats = ["images", "labels"]
        if self.with_superpixels:
            cats.append("superpixels")
        return cats

    def _path(self, subject, category, entry):
        return self._subject_files[subject].categories[category].entries[entry]

    def shape(self, subject: str, category: str = "images"):
        """From the image header, without decoding the pixels."""
        if category == "superpixels":
            sp = _open(self._path(subject, "images", "superpixels"))
            w, h = sp.size
            nb_ch = len(sp.getbands())
            return (h, w) if nb_ch == 1 else (h, w, nb_ch)
        w, h = _open(self._path(subject, "images", "image")).size
        if category == "images":
            return (h, w, 3)
        return (h, w, 2) if self.prediction_dir else (h, w)

    def read_volume(self, subject: str, category: str):
        if category == "images":
            return np.asarray(
                _open(self._path(subject, "images", "image")).convert("RGB"))
        if category == "superpixels":
            return np.asarray(_open(self._path(subject, "images",
                                               "superpixels")))
        gt = np.asarray(_open(self._path(subject, "labels", "gt")).convert("L"))
        if not self.prediction_dir:
            return gt
        pred, _ = nifti.read(os.path.join(self.prediction_dir,
                                          f"{subject}_prediction.nii.gz"))
        pred = np.squeeze(pred).astype(np.uint8) * 255  # the x255 quirk
        return np.stack([gt, pred], axis=-1)

    def read_slice(self, subject: str, index: int, category: str):
        return self.read_volume(subject, category)

    def properties(self, subject: str) -> nifti.ImageProperties:
        h, w, _ = self.shape(subject)
        return nifti.ImageProperties(size=(w, h))

    def files(self, subject: str) -> dict:
        sf = self._subject_files[subject]
        return {c: dict(cat.entries) for c, cat in sf.categories.items()}

    def close(self):
        """Nothing to release: each read opens and closes its file."""
