"""Create the BraTS18 split JSONs (``scripts/create_brats18_split.py``
counterpart; same flags, seeds, file names and bytes).

  python -m rcu_tpu_torch.cli.create_brats18_split [--type default] \
      [--data_dir D] [--out_dir O]

- default: stratified (HGG/LGG) shuffled 100/25/rest split, seed 100;
- ensemble: k=10 jackknife of the train set (shared valid and test);
- k-fold: k=5 stratified cross-validation over train + valid (a fold's
  valid is its test);
- resplit-train: the first 10 train subjects (not stratified).
Needs ``sklearn``: run it where the data is.
"""
import argparse
import os

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data import split as split_lib
from rcu_tpu_torch.data.collector import Brats17Collector


def main(split_type: str, data_dir: str = None, out_dir: str = None):
    if split_type not in ("default", "ensemble", "k-fold", "resplit-train"):
        raise ValueError(f'invalid split type "{split_type}"')
    data_dir = data_dir or dirs.BRATS_ORIG_DATA_DIR
    out_dir = out_dir or dirs.SPLITS_DIR
    os.makedirs(out_dir, exist_ok=True)

    subject_files = Brats17Collector(data_dir).get_subject_files()
    subject_names = [sf.subject for sf in subject_files]
    grade_ints = [0 if getattr(sf, "grade", "HGG") == "HGG" else 1
                  for sf in subject_files]

    nb_train, nb_valid = 100, 25
    nb_test = len(subject_names) - nb_train - nb_valid
    train, valid, test = split_lib.create_stratified_shuffled_split(
        subject_names, grade_ints, (nb_train, nb_valid, nb_test), seed=100)

    if split_type == "default":
        name = f"split_brats18_{nb_train}-{nb_valid}-{nb_test}.json"
        split_lib.save_split(os.path.join(out_dir, name), train, valid, test)
    elif split_type == "ensemble":
        k = 10
        train_k = [t for t, _ in split_lib.split_subjects_k_fold(train, k)]
        name = f"split_brats18_k{k}_{len(train) - k}-{nb_valid}-{nb_test}.json"
        split_lib.save_split(os.path.join(out_dir, name), train_k,
                             k * [valid], k * [test])
    elif split_type == "k-fold":
        k = 5
        grade_of = dict(zip(subject_names, grade_ints))
        to_fold = train + valid
        folds = split_lib.split_subject_k_fold_stratified(
            to_fold, [grade_of[s] for s in to_fold], k)
        train_k = [t for t, _ in folds]
        valid_k = [v for _, v in folds]
        nb_v = len(to_fold) // k
        name = f"split_brats18_cv_k{k}_{len(to_fold) - nb_v}-{nb_v}-{nb_v}.json"
        split_lib.save_split(os.path.join(out_dir, name), train_k, valid_k,
                             valid_k)
    elif split_type == "resplit-train":
        nb_new = 10
        new_train, _ = split_lib.split_subjects(
            train, (nb_new, len(train) - nb_new))
        name = f"split_brats18_sub_{nb_new}-{nb_valid}-{nb_test}.json"
        split_lib.save_split(os.path.join(out_dir, name), new_train, valid,
                             test)


def cli():
    parser = argparse.ArgumentParser(description="BraTS split file creation")
    parser.add_argument("--type", type=str, default="default")
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    args = parser.parse_args()
    print(f"split type: {args.type}")
    main(args.type, args.data_dir, args.out_dir)


if __name__ == "__main__":
    cli()
