"""ISIC-2017 preprocessing (``scripts/prepare_isic_data.py`` counterpart;
same flags, file names, directory suffixes and pixels): every task split
resampled to the 192x256 working size.

  python -m rcu_tpu_torch.cli.prepare_isic_data [--in_root R] [--out_dir O]

Lesion photographs resample bilinearly; the ground-truth masks and the
superpixel index maps stay label-valued (nearest neighbour). ``PIL`` is
imported when an image is resampled.
"""
import argparse
import os

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.data.collector import IsicCollector

TARGET_WH = (256, 192)  # PIL order (w, h): 192x256 (h, w)

# (collector category, entry) -> (output dir suffix, PIL filter name);
# an entry a subject lacks is skipped
RESAMPLE_PLAN = {
    ("images", "image"): ("_Data", "BILINEAR"),
    ("labels", "gt"): ("_Part1_GroundTruth", "NEAREST"),
    ("images", "superpixels"): ("_Data", "NEAREST"),
}


def process_data(out_dir: str, task_dir: str):
    """Resample one task split (its ``_Data`` / ``_Part1_GroundTruth``
    sibling dirs) into the same layout under ``out_dir``."""
    from PIL import Image
    task = os.path.basename(task_dir)
    print(f"Process: {task}")
    subject_files = IsicCollector(task_dir,
                                  with_superpixels=True).get_subject_files()
    for suffix, _ in RESAMPLE_PLAN.values():
        os.makedirs(os.path.join(out_dir, task + suffix), exist_ok=True)
    for i, sf in enumerate(subject_files):
        print(f"[{i + 1}/{len(subject_files)}] {sf.subject}", flush=True)
        for (category, entry), (suffix, resample) in RESAMPLE_PLAN.items():
            path = sf.categories[category].entries.get(entry)
            if not path:
                continue
            Image.open(path).resize(TARGET_WH, getattr(Image, resample)).save(
                os.path.join(out_dir, task + suffix, os.path.basename(path)))


def main(in_root: str = None, out_dir: str = None):
    out_dir = out_dir or dirs.ISIC_PREPROCESSED_DIR
    os.makedirs(out_dir, exist_ok=True)
    task_dirs = ([os.path.join(in_root, d) for d in
                  ("ISIC-2017_Training", "ISIC-2017_Validation",
                   "ISIC-2017_Test_v2")] if in_root else
                 [dirs.ISIC_ORIG_TRAIN_DATA_DIR, dirs.ISIC_ORIG_VALID_DATA_DIR,
                  dirs.ISIC_ORIG_TEST_DATA_DIR])
    for task_dir in task_dirs:
        process_data(out_dir, task_dir)


def cli():
    parser = argparse.ArgumentParser(description="ISIC preprocessing (resize)")
    parser.add_argument("--in_root", type=str, default=None)
    parser.add_argument("--out_dir", type=str, default=None)
    args = parser.parse_args()
    main(args.in_root, args.out_dir)


if __name__ == "__main__":
    cli()
