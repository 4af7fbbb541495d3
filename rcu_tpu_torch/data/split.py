"""Subject splits (``rcu_tpu.data.split``): the on-disk JSON layout and the
partitioning helpers of the split CLIs.

The layout is a single object with ``train`` / ``valid`` / ``test`` keys
(in that order) whose values are flat subject-name lists, or
lists-of-lists for fold files indexed with a fold number at load time;
:func:`save_split` writes it with ``json.dump``'s default separators, byte
for byte the JAX package's file.

The stratified helpers call ``sklearn.model_selection`` with the caller's
``random_state``, as the JAX package does, so a regenerated split equals
the vendored JSONs of ``config/splits/`` (seed 100). ``sklearn`` is
imported inside them: the card's machine has none, and splits are made
where the data is.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SubjectSplit:
    """A train/valid/test assignment of subject names. Members may be flat
    lists (a single split) or lists-of-lists (one entry per fold)."""

    train: list
    valid: list
    test: Optional[list] = None

    def fold(self, k: int) -> "SubjectSplit":
        """Fold ``k`` of a folded split file."""
        test = [] if self.test is None else self.test[k]
        return SubjectSplit(self.train[k], self.valid[k], test)

    def save(self, path: str) -> None:
        payload = {"train": self.train, "valid": self.valid, "test": self.test}
        with open(path, "w") as fp:
            json.dump(payload, fp)

    @classmethod
    def load(cls, path: str, k: Optional[int] = None) -> "SubjectSplit":
        with open(path) as fp:
            payload = json.load(fp)
        split = cls(payload["train"], payload["valid"], payload["test"])
        return split if k is None else split.fold(k)


def save_split(file: str, train_subjects: list, valid_subjects: list,
               test_subjects: list = None) -> None:
    SubjectSplit(train_subjects, valid_subjects, test_subjects).save(file)


def load_split(file: str, k: int = None) -> Tuple[list, list, list]:
    """-> (train, valid, test) subject lists, fold ``k`` of a folded file."""
    split = SubjectSplit.load(file, k)
    return split.train, split.valid, split.test


def _resolve_counts(sizes: Sequence, total: int) -> List[int]:
    """``sizes`` (absolute ints or fractions) as absolute counts. Only a
    three-way split takes its last group as the remainder; a two-way
    fractional split floors both counts and may leave rounding leftovers
    in neither group, as the JAX package's does."""
    if all(isinstance(s, int) for s in sizes):
        if sum(sizes) != total:
            raise ValueError(
                f"absolute split sizes {tuple(sizes)} must cover all "
                f"{total} subjects exactly")
        counts = list(sizes)
    elif all(isinstance(s, float) for s in sizes):
        if abs(sum(sizes) - 1.0) > 1e-12:
            raise ValueError(
                f"fractional split sizes {tuple(sizes)} must total 1.0")
        counts = [int(total * s) for s in sizes]
    else:
        raise ValueError(
            f"split sizes must be all-int or all-float, got {tuple(sizes)}")
    if len(counts) == 3:
        counts[2] = total - counts[0] - counts[1]
    return counts


def split_subjects(subjects: list, sizes: Sequence) -> tuple:
    """Consecutive groups of an ordered subject list; a three-way split's
    last group is anchored to the end of the list."""
    counts = _resolve_counts(sizes, len(subjects))
    groups, cursor = [], 0
    for n in counts[:-1]:
        groups.append(subjects[cursor:cursor + n])
        cursor += n
    if len(counts) == 3:
        groups.append(subjects[len(subjects) - counts[-1]:])
    else:
        groups.append(subjects[cursor:cursor + counts[-1]])
    return tuple(groups)


def split_subjects_k_fold(subjects: list, k: int) -> list:
    """Rotation k-fold: fold i holds out the i-th contiguous block; ->
    [(kept, held out)]."""
    if len(subjects) % k:
        raise ValueError(
            f"k-fold needs len(subjects) divisible by k, got "
            f"{len(subjects)} subjects for k={k}")
    block = len(subjects) // k
    folds = []
    for i in range(k):
        held_out = subjects[i * block:(i + 1) * block]
        kept = subjects[:i * block] + subjects[(i + 1) * block:]
        folds.append((kept, held_out))
    return folds


def split_subject_k_fold_stratified(subjects: list, stratification: list,
                                    k: int) -> list:
    """Label-stratified k-fold (sklearn's deterministic StratifiedKFold)."""
    from sklearn.model_selection import StratifiedKFold
    folds = []
    for kept_idx, held_idx in StratifiedKFold(n_splits=k).split(
            subjects, stratification):
        folds.append(([subjects[i] for i in kept_idx],
                      [subjects[i] for i in held_idx]))
    return folds


def create_stratified_shuffled_split(subjects: list, stratification: list,
                                     counts: Sequence, seed: int = 100):
    """Two chained stratified shuffles: valid carved off, then test, with
    the JAX package's calls and arguments, so that ``seed`` gives its
    split."""
    from sklearn.model_selection import train_test_split
    rest, valid, rest_strat, _ = train_test_split(
        subjects, stratification, test_size=counts[1], random_state=seed,
        shuffle=True, stratify=np.asarray(stratification))
    if len(counts) < 3:
        return rest, valid
    train, test = train_test_split(
        rest, test_size=counts[2], random_state=seed, shuffle=True,
        stratify=np.asarray(rest_strat))
    return train, valid, test
