"""Dataset-pooled ECE against the mean subject ECE, per strategy
(``bin/table_supplmat_ece_dataset_vs_meansubject.py`` counterpart, numpy
and the stdlib ``csv`` module, no pandas).

The strategies are the calibration CSVs' own ``test_id`` values. A dataset
without results is skipped with a printed line; one without calibration
CSVs ends the tool (``SystemExit``), as in the JAX tool.

  python -m rcu_tpu_torch.cli.table_supplmat_ece_dataset_vs_meansubject
"""
import argparse

import numpy as np

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.analysis import frames, latex, resultdata as resdata


def per_run(frame: dict) -> tuple:
    """(mean subject ECE, dataset ECE of the count-pooled bins); the CSV's
    ECE must match the one recomputed from its bins."""
    conf, frac, counts = frames.get_bins(frame)
    bin_sum = counts.sum(axis=0)
    avg_conf = (conf * counts).sum(axis=0) / bin_sum
    pos_frac = (frac * counts).sum(axis=0) / bin_sum
    proportions = counts / counts.sum(axis=1, keepdims=True)
    ece = (np.abs(conf - frac) * proportions).sum(axis=1)
    if not np.allclose(np.asarray(ece), frame["ece"], atol=1e-5):
        raise AssertionError
    ds_ece = (np.abs(avg_conf - pos_frac) * bin_sum / bin_sum.sum()).sum()
    return ece.mean(), float(ds_ece)


def dataset_vs_mean_subject_ece(df: dict, ids_names) -> tuple:
    """-> (display names, {"ece": ..., "ds_ece": ...}), NaN for a strategy
    without rows."""
    found = {test_id: per_run(frames.rows(df, df["test_id"] == test_id))
             for test_id in frames.unique_sorted(df["test_id"])}
    missing = (np.nan, np.nan)
    values = np.array([found.get(id_, missing) for id_ in ids_names],
                      dtype=np.float64).reshape(len(ids_names), 2)
    return list(ids_names.values()), {"ece": values[:, 0],
                                      "ds_ece": values[:, 1]}


def gather(task: str) -> tuple:
    data, ids_names = resdata.selection(task)
    files, file_ids, _, _ = data.get_files(list(ids_names), [dirs.CALIB_NAME])
    if not files:
        # the JAX tool's text, word for word
        raise SystemExit(
            f"no calibration CSVs found for {task} — run bin/eval_uncertainty.py "
            "with the 'calib' action first")
    df = frames.stack([frames.read_csv(f) for f in files], list(file_ids))
    return dataset_vs_mean_subject_ece(df, ids_names)


def in_percent(part: tuple) -> tuple:
    names, cols = part
    return names, {k: np.round(v * 100, 3) for k, v in cols.items()}


def main():
    parts = []
    for task in ("brats", "isic"):
        try:
            parts.append(in_percent(gather(task)))
        except Exception as e:  # missing results for one dataset is fine
            print(f"skipping {task}: {e}")
    if parts:
        # keyed in order, as the JAX tool keys its parts
        latex_str = latex.to_latex(dict(zip(["brats", "isic"], parts)))
        print(latex_str)
        return latex_str


def cli():
    argparse.ArgumentParser(description="ece dataset vs mean-subject").parse_args()
    main()


if __name__ == "__main__":
    cli()
