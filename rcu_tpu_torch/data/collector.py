"""Filesystem collectors -> subject file lists (``rcu_tpu.data.collector``
counterparts of ``Category``, ``SubjectFile`` and ``IsicCollector``).

A :class:`SubjectFile` is a subject name plus
``categories[category].entries[entry] -> path``.
"""
from __future__ import annotations

import dataclasses
import glob
import os


@dataclasses.dataclass
class Category:
    entries: dict


class SubjectFile:
    def __init__(self, subject: str, **categories: dict):
        self.subject = subject
        self.categories = {name: Category(entries=dict(entries))
                           for name, entries in categories.items()}

    def flat_entries(self):
        return {(c, e): p for c, cat in self.categories.items()
                for e, p in cat.entries.items()}


class IsicCollector:
    """ISIC-2017 layout: ``<root>_Data/ISIC_<id>.jpg|png`` (and, with
    superpixels, ``ISIC_<id>_superpixels.png``) and
    ``<root>_Part1_GroundTruth/ISIC_<id>_segmentation.png``."""

    def __init__(self, root_dir: str, with_superpixels: bool = False):
        self.root_dir = root_dir
        self.with_superpixels = with_superpixels

    def get_subject_files(self) -> list:
        data_dir = self.root_dir + "_Data"
        gt_dir = self.root_dir + "_Part1_GroundTruth"
        image_paths = sorted(
            p for p in glob.glob(os.path.join(data_dir, "ISIC_*"))
            if not p.endswith("_superpixels.png"))
        subject_files = []
        for img in image_paths:
            subject = os.path.basename(img)[:12]  # 'ISIC_' + 7-digit id
            gt = os.path.join(gt_dir, f"{subject}_segmentation.png")
            if not os.path.exists(gt):
                raise ValueError(f"missing ground truth {gt}")
            images = {"image": img}
            if self.with_superpixels:
                sp = os.path.join(data_dir, f"{subject}_superpixels.png")
                if not os.path.exists(sp):
                    raise ValueError(f"missing superpixels {sp}")
                images["superpixels"] = sp
            subject_files.append(SubjectFile(subject, images=images,
                                             labels={"gt": gt}))
        return subject_files
