"""Filesystem collectors -> subject file lists (``rcu_tpu.data.collector``,
copied): the BraTS and ISIC raw-data layouts, the prediction artifacts of
a test run, and their join.

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


class Brats17Collector:
    """BraTS17/18 layout:
    ``<root>/[HGG|LGG]/<subject>/<subject>_{flair,t1,t1ce,t2,seg}.nii.gz``."""

    IMAGE_ENTRIES = ("flair", "t1", "t1ce", "t2")

    def __init__(self, root_dir: str, with_grade: bool = True):
        self.root_dir = root_dir
        self.with_grade = with_grade

    def get_subject_files(self) -> list:
        pattern = os.path.join(self.root_dir, "*", "*") if self.with_grade \
            else os.path.join(self.root_dir, "*")
        subject_dirs = sorted(d for d in glob.glob(pattern) if os.path.isdir(d))
        subject_files = []
        for d in subject_dirs:
            subject = os.path.basename(d)
            images, labels = {}, {}
            for entry in self.IMAGE_ENTRIES:
                path = os.path.join(d, f"{subject}_{entry}.nii.gz")
                if not os.path.exists(path):
                    raise ValueError(f"missing image file {path}")
                images[entry] = path
            seg = os.path.join(d, f"{subject}_seg.nii.gz")
            if not os.path.exists(seg):
                raise ValueError(f"missing label file {seg}")
            labels["gt"] = seg
            sf = SubjectFile(subject, images=images, labels=labels)
            if self.with_grade:
                sf.grade = os.path.basename(os.path.dirname(d))
            subject_files.append(sf)
        return subject_files


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


class PostfixPredictionCollector:
    """``<subject>_<postfix>.nii.gz`` artifacts of a prediction dir, the
    i-th postfix into the i-th category ('prediction' under 'labels', the
    confidence entry under 'misc'). A subject that lacks one of the
    postfixes (an interrupted test run) raises."""

    def __init__(self, prediction_dir: str, post_fixes: list, categories: list):
        self.prediction_dir = prediction_dir
        self.post_fixes = list(post_fixes)
        self.categories = list(categories)

    def get_subject_files(self) -> list:
        by_subject: dict = {}
        for postfix, category in zip(self.post_fixes, self.categories):
            paths = sorted(glob.glob(
                os.path.join(self.prediction_dir, f"*_{postfix}.nii.gz")))
            if not paths:
                raise ValueError(
                    f"no '*_{postfix}.nii.gz' files in {self.prediction_dir}")
            for p in paths:
                subject = os.path.basename(p)[: -len(f"_{postfix}.nii.gz")]
                by_subject.setdefault(subject, {}).setdefault(category, {})[postfix] = p
        want = set(self.post_fixes)
        for subject, cats in sorted(by_subject.items()):
            have = {pf for cat in cats.values() for pf in cat}
            if have != want:
                raise ValueError(
                    f"subject '{subject}' in {self.prediction_dir} is "
                    f"missing artifacts {sorted(want - have)} (has "
                    f"{sorted(have)}) — incomplete test run?")
        return [SubjectFile(s, **cats) for s, cats in sorted(by_subject.items())]


def combine(*subject_file_lists) -> list:
    """Merge the categories of same-subject SubjectFiles across the lists,
    for the subjects present in all of them. A subject of the last list
    (the predictions) that the others lack raises ``KeyError``."""
    keeps = [set(sf.subject for sf in lst) for lst in subject_file_lists]
    keep = set.intersection(*keeps)
    for lst_keep, lst in zip(keeps, subject_file_lists):
        extra = lst_keep - keep
        if extra and lst is subject_file_lists[-1]:
            raise KeyError(
                f"prediction subjects {sorted(extra)} have no counterpart "
                "in the ground-truth collection(s)")
    merged: dict = {}
    for lst in subject_file_lists:
        for sf in lst:
            if sf.subject not in keep:
                continue
            tgt = merged.setdefault(sf.subject, {})
            for cname, cat in sf.categories.items():
                tgt.setdefault(cname, {}).update(cat.entries)
    return [SubjectFile(s, **cats) for s, cats in sorted(merged.items())]
