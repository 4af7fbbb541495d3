"""Build the BraTS18 H5 subject stores (``scripts/create_brats18_dataset.py``
counterpart; same flags, defaults, file names and errors).

  python -m rcu_tpu_torch.cli.create_brats18_dataset [--type train] \
      [--in_dir D] [--split_file F] [--prediction_path P]

Modes: train | test | train_with_predictions | test_with_predictions.
Per subject: the 4 modalities stacked channel-last, each channel z-scored
over the volume, the labels binarized (0..4 -> 0/1), and, with
predictions, a prediction run's ``<subject>_prediction.nii.gz`` as a
second labels channel (the auxiliary-segm input); the grade (HGG/LGG)
and the source files are recorded. The store holds images (Z, Y, X, 4)
float32 and labels (Z, Y, X[, 2]) uint8 (``data.h5.DatasetWriter``).
Needs ``h5py``: run it where the data is.
"""
import argparse
import os

import numpy as np

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.data.collector import Brats17Collector
from rcu_tpu_torch.data.h5 import DatasetWriter
from rcu_tpu_torch.data.split import load_split

MODALITIES = ("flair", "t1", "t1ce", "t2")
STORE_NAMES = {
    ("train", False): "brats18_train_reduced_norm.h5",
    ("test", False): "brats18_test_reduced_norm.h5",
    ("train", True): "brats18_train_wpred_reduced_norm.h5",
    ("test", True): "brats18_test_wpred_reduced_norm.h5",
}


def normalize_per_channel(images: np.ndarray) -> np.ndarray:
    """Per-channel z-score over the volume (a channel of std 0 is only
    centred)."""
    out = np.empty_like(images, np.float32)
    for c in range(images.shape[-1]):
        ch = images[..., c].astype(np.float32)
        std = ch.std()
        out[..., c] = (ch - ch.mean()) / (std if std > 0 else 1.0)
    return out


def build_brats_dataset(in_dir: str, out_file: str, split_file: str,
                        is_train_data: bool, prediction_path: str = None):
    """The store of the split's train + valid subjects (``is_train_data``)
    or of its test subjects, in subject-name order."""
    subject_files = Brats17Collector(in_dir).get_subject_files()
    train, valid, test = load_split(split_file)
    keep = set((train + valid) if is_train_data else test)
    subject_files = sorted((sf for sf in subject_files if sf.subject in keep),
                           key=lambda sf: sf.subject)
    if set(sf.subject for sf in subject_files) != keep:
        missing = keep - set(sf.subject for sf in subject_files)
        raise ValueError(f"subjects in split but not on disk: {sorted(missing)}")

    os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
    with DatasetWriter(out_file) as writer:
        for i, sf in enumerate(subject_files):
            print(f"[{i + 1}/{len(subject_files)}] {sf.subject}", flush=True)
            channels, props = [], None
            for entry in MODALITIES:
                arr, props = nifti.read(sf.categories["images"].entries[entry])
                channels.append(arr.astype(np.float32))
            images = normalize_per_channel(np.stack(channels, axis=-1))
            gt, _ = nifti.read(sf.categories["labels"].entries["gt"])
            labels = (np.asarray(gt) != 0).astype(np.uint8)
            if prediction_path is not None:
                pred, _ = nifti.read(os.path.join(
                    prediction_path, f"{sf.subject}_prediction.nii.gz"))
                labels = np.stack([labels, pred.astype(np.uint8)], axis=-1)
            files = {"images": dict(sf.categories["images"].entries),
                     "labels": dict(sf.categories["labels"].entries)}
            writer.add_subject(sf.subject,
                               {"images": images, "labels": labels},
                               props=props,
                               meta={"grade": getattr(sf, "grade", "")},
                               files=files)
    print(f"wrote {out_file}")


def main(creation_type: str, in_dir: str = None, split_file: str = None,
         prediction_path: str = None):
    if creation_type not in ("train", "test", "train_with_predictions",
                             "test_with_predictions"):
        raise ValueError(f'invalid creation type "{creation_type}"')
    in_dir = in_dir or dirs.BRATS_ORIG_DATA_DIR
    split_file = split_file or os.path.join(dirs.SPLITS_DIR,
                                            "split_brats18_100-25-160.json")
    is_train = creation_type.startswith("train")
    with_pred = creation_type.endswith("with_predictions")
    if with_pred and prediction_path is None:
        prediction_path = os.path.join(
            dirs.BRATS_PREDICT_DIR,
            dirs.BRATS_CV_PREDICT if is_train else dirs.BRATS_BASELINE_PREDICT)
    out_file = os.path.join(
        dirs.DATASET_DIR,
        STORE_NAMES[("train" if is_train else "test", with_pred)])
    build_brats_dataset(in_dir, out_file, split_file, is_train,
                        prediction_path if with_pred else None)


def cli():
    parser = argparse.ArgumentParser(description="BraTS18 H5 dataset creation")
    parser.add_argument("--type", type=str, default="train",
                        help="train | test | train_with_predictions | "
                             "test_with_predictions")
    parser.add_argument("--in_dir", type=str, default=None)
    parser.add_argument("--split_file", type=str, default=None)
    parser.add_argument("--prediction_path", type=str, default=None)
    args = parser.parse_args()
    main(args.type, args.in_dir, args.split_file, args.prediction_path)


if __name__ == "__main__":
    cli()
