"""Create the ISIC split JSONs (``scripts/create_isic_subtrain_split.py``
counterpart; same flags, seeds, file names and bytes) over the
preprocessed ISIC training subjects.

  python -m rcu_tpu_torch.cli.create_isic_subtrain_split [--type k-fold] \
      [--data_dir D] [--out_dir O]

- ensemble: k=10 train-only jackknife folds (the 10 ensemble members);
- k-fold: k=5 cross-validation, a fold's valid doubling as its test;
- resplit-train: the first 10 % of a shuffle by ``random.Random(100)``
  (a stream of its own: the caller's global RNG is untouched).
"""
import argparse
import os
import random

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data import split as split_lib
from rcu_tpu_torch.data.collector import IsicCollector


def _jackknife_members(names):
    """k=10 leave-one-fold-out training sets; no validation or test."""
    k = 10
    train_folds = [t for t, _ in split_lib.split_subjects_k_fold(names, k)]
    filename = f"split_isic-train_k{k}_{len(train_folds[0])}-0-0.json"
    return filename, train_folds, k * [None], None


def _cross_validation(names):
    """k=5 cross-validation; per fold, validation == test."""
    k = 5
    folds = split_lib.split_subjects_k_fold(names, k)
    train_folds = [t for t, _ in folds]
    valid_folds = [v for _, v in folds]
    nb_valid = len(names) // k
    filename = (f"split_isic_cv_k{k}_"
                f"{len(names) - nb_valid}-{nb_valid}-{nb_valid}.json")
    return filename, train_folds, valid_folds, valid_folds


def _subtrain_tenth(names):
    """The first 10 % of a seed-100 shuffle as the reduced training set."""
    shuffled = list(names)
    random.Random(100).shuffle(shuffled)
    nb_sub = int(len(shuffled) * 0.10)
    sub_train, _ = split_lib.split_subjects(
        shuffled, (nb_sub, len(shuffled) - nb_sub))
    return f"split_isic_sub_{nb_sub}-0-0.json", sub_train, [None], None


RECIPES = {
    "ensemble": _jackknife_members,
    "k-fold": _cross_validation,
    "resplit-train": _subtrain_tenth,
}


def main(split_type: str, data_dir: str = None, out_dir: str = None):
    try:
        recipe = RECIPES[split_type]
    except KeyError:
        raise ValueError(f'invalid split type "{split_type}"') from None
    data_dir = data_dir or dirs.ISIC_PREPROCESSED_TRAIN_DATA_DIR
    out_dir = out_dir or dirs.SPLITS_DIR
    os.makedirs(out_dir, exist_ok=True)
    names = [sf.subject for sf in
             IsicCollector(data_dir, with_superpixels=True)
             .get_subject_files()]
    filename, train, valid, test = recipe(names)
    split_lib.save_split(os.path.join(out_dir, filename), train, valid, test)
    print(f"wrote {filename}")


def cli():
    parser = argparse.ArgumentParser(description="ISIC split file creation")
    parser.add_argument("--type", type=str, default="k-fold",
                        choices=sorted(RECIPES))
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    args = parser.parse_args()
    print(f"split type: {args.type}")
    main(args.type, args.data_dir, args.out_dir)


if __name__ == "__main__":
    cli()
