"""Tiny cells of each driver at a size a CPU test can hold, added as
files (a configuration, traffic and limits each) to a copy of the
benchmark, the way a later change adds a cell."""
from __future__ import annotations

import json
import os
import shutil


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TH = [0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95]
MODEL = {"depth": 2, "dropout": 0.05, "nb_classes": 2, "start_filters": 4}

CONFIGS = {
    "tiny_brats": {"model": {"unet": {**MODEL, "in_channels": 4}},
                   "optimizer": {"adam": {"lr": 0.0001}},
                   "data": {"kind": "brats_volumes", "shape": [8, 16, 16],
                            "channels": 4, "eval_pool": 2, "masked": True}},
    "tiny_isic": {"model": {"unet": {**MODEL, "in_channels": 3}},
                  "optimizer": {"adam": {"lr": 0.0001}},
                  "data": {"kind": "isic_images", "shape": [16, 24],
                           "channels": 3, "eval_pool": 10, "masked": False,
                           "transform": [{"rescale": {
                               "entries": ["images", "labels"],
                               "lower": 0, "upper": 1}}]}},
}
TRAFFIC = {
    "tiny_mc": {"driver": "direct_eval", "strategy": "mc", "mc": 3,
                "dtype": "float32", "fast_decoder": False, "batch_size": 4,
                "thresholds": TH, "check_items": 2, "warmup_items": 1,
                "items_per_s": 10},
    "tiny_det": {"driver": "direct_eval", "strategy": "deterministic",
                 "mc": 0, "dtype": "float32", "fast_decoder": True,
                 "batch_size": 4, "thresholds": TH, "check_items": 2,
                 "warmup_items": 1, "items_per_s": 10},
    "tiny_train": {"driver": "train", "dtype": "float32", "subjects": 3,
                   "batch_size": 4, "num_workers": 1, "epochs_per_s": 7},
}
# a float32 program on the CPU against the float32 reference: rounding only
EVAL_LIMITS = {"ece_gap": 1e-4, "dice_gap": 1e-4, "count_gap": 1e-3}
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 0.2,
                "window_loss_gap": 1e-4, "window_change_gap": 0.2}
CELLS = {"tiny_brats_mc": ("tiny_brats", "tiny_mc", EVAL_LIMITS),
         "tiny_brats_det": ("tiny_brats", "tiny_det", EVAL_LIMITS),
         "tiny_isic_mc": ("tiny_isic", "tiny_mc", EVAL_LIMITS),
         "tiny_brats_train": ("tiny_brats", "tiny_train", TRAIN_LIMITS)}
TEST_METRIC = '''"""window_share: a test-only reader, found by its name: 100
where the record has a window."""


def read(record):
    return 100.0 if record.get("window_s") else None
'''


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


def make_root(tmp_path) -> str:
    """A root holding ``BENCHMARK.json`` with the repository's entries plus
    the tiny cells and a test-only metric, and a copy of ``benchmark/``
    plus their files."""
    root = str(tmp_path / "root")
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for name, config in CONFIGS.items():
        path = f"benchmark/configs/{name}.json"
        _write(os.path.join(root, path), config)
        spec["configs"].append({"name": name, "source": "test", "file": path,
                                "reduced": [], "why": "test"})
    for name, traffic in TRAFFIC.items():
        _write(os.path.join(root, f"benchmark/traffic/{name}.json"), traffic)
    for cell, (config, traffic, limits) in CELLS.items():
        _write(os.path.join(root, f"benchmark/limits/{cell}.json"), limits)
        spec["workloads"].append({"name": cell, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    eval_cells = [c for c, (_, t, _) in CELLS.items()
                  if TRAFFIC[t]["driver"] == "direct_eval"]
    for entry in spec["end_to_end"]:
        if entry["name"] == "eval_voxels_per_s":
            entry["workloads"] += eval_cells
        if entry["name"] == "train_slices_per_s":
            entry["workloads"].append("tiny_brats_train")
    _write(os.path.join(root, "benchmark/metrics/window_share.py"),
           TEST_METRIC)
    spec["per_layer"].append({"name": "window_share", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "setup_s",
                              "workloads": list(CELLS)})
    _write(os.path.join(root, "BENCHMARK.json"), spec)
    return root
