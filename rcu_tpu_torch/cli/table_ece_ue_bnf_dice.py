"""Main paper table (``bin/table_ece_ue_bnf_dice.py`` counterpart, numpy and
the stdlib ``csv`` module, no pandas): per strategy the mean ECE (%), the
best threshold's uncertainty-error dice and benefit ratio, and the Dice,
each with its dense rank, rank 1 in bold.

The means are over the rows of every threshold file of a strategy, each
row carrying its subject's best-threshold values, as the JAX tool merges
them: a subject weighs as many rows as it has threshold files.

  python -m rcu_tpu_torch.cli.table_ece_ue_bnf_dice
"""
import argparse
import re

import numpy as np

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.analysis import frames, latex, resultdata as resdata

ENTRIES = ["ece", "error", "benefit", "dice"]
PRECISION = [3, 3, 2, 3]
UNCERTAINTY_COLUMNS = ["test_id", "subject_name", "corrected_dice", "fp",
                       "fn", "fnu", "fpu", "tnu", "tpu", "dice"]
MEAN_COLUMNS = ["ece", "dice", "benefit_threshold", "benefit",
                "error_threshold", "error"]


def _check_dice(frame: dict, ece_frame: dict):
    """The threshold file's dice equals the ECE file's, row by row, at 5
    decimals."""
    a, b = frame["dice"], ece_frame["dice"]
    if len(a) != len(b):
        raise ValueError("Can only compare identically-labeled Series objects")
    if not (np.round(a, 5) == np.round(b, 5)).all():
        raise AssertionError


def gather_information(task: str):
    """-> (the selection's display names, ``{column: per-name means}``,
    NaN for a strategy without results): the columns of
    ``MEAN_COLUMNS``."""
    data, ids_names = resdata.selection(task)
    ece_cat = dirs.ECE_FOREGROUND_NAME if task == "brats" else dirs.ECE_NAME
    files, file_ids, _, file_thresholds = data.get_files(
        list(ids_names), [dirs.UNCERTAINTY_NAME])
    files_ece, ids_ece, _, _ = data.get_files(list(ids_names), [ece_cat])
    ece_dict = dict(zip(ids_ece, files_ece))

    run_ids, frames_ = [], []
    for file_path, id_, threshold in zip(files, file_ids, file_thresholds):
        if id_ not in ece_dict:
            print(f"missing ece id_ {id_}")
            continue
        frame = frames.columns(frames.read_csv(file_path), UNCERTAINTY_COLUMNS)
        ece_frame = frames.read_csv(ece_dict[id_])
        _check_dice(frame, ece_frame)
        del frame["dice"]
        frame = frames.merge(
            frame, frames.columns(ece_frame, ["subject_name", "ece", "dice"]),
            ["subject_name"])
        frames_.append(frame)
        run_ids.append(f"{id_}_th{threshold}")

    if not frames_:
        # the JAX tool's text, word for word
        raise SystemExit(
            f"no eval CSVs found for {task} under the configured eval dir — "
            "run bin/eval_uncertainty.py first (see rcu_tpu/directories.py)")
    df = frames.stack(frames_, run_ids)
    df["threshold"] = np.array([frames.threshold_from_run_id(s)
                                for s in df["run_id"]])
    df["dice_diff"] = df["corrected_dice"] - df["dice"]
    df["benefit"] = df["dice_diff"] > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        df["error"] = (2 * (df["fnu"] + df["fpu"])) / (
            df["fn"] + df["fp"] + df["fnu"] + df["fpu"] + df["tnu"]
            + df["tpu"])

    keys = ["test_id", "subject_name"]
    merged = frames.columns(df, keys + ["ece", "dice"])
    for entry in ("benefit", "error"):
        best = get_best_thresholds(
            frames.columns(df, ["run_id"] + keys + ["threshold", entry]), entry)
        merged = frames.merge(merged, {
            "test_id": best["test_id"], "subject_name": best["subject_name"],
            f"{entry}_threshold": best["threshold"], entry: best[entry]}, keys)

    groups = {}
    for name in MEAN_COLUMNS:
        test_ids, means = frames.group_mean(merged["test_id"], merged[name])
        groups[name] = dict(zip(test_ids, means))
    names = list(ids_names.values())
    return names, {name: np.array([groups[name].get(id_, np.nan)
                                   for id_ in ids_names])
                   for name in MEAN_COLUMNS}


def get_best_thresholds(df: dict, entry: str) -> dict:
    """Per strategy (``test_id``, sorted), the rows of the threshold file
    (``run_id``) whose subject-mean of ``entry`` is largest, the first of
    the sorted run ids on a tie."""
    best, run_ids = [], []
    for test_id in frames.unique_sorted(df["test_id"]):
        group = frames.rows(df, df["test_id"] == test_id)
        keys, means = frames.group_mean(group["run_id"], group[entry])
        run_id_max = frames.first_max(keys, means)
        best.append(frames.rows(df, df["run_id"] == run_id_max))
        run_ids.append(run_id_max)
    return frames.stack([{k: v for k, v in b.items() if k != "run_id"}
                         for b in best], run_ids)


def _dense_rank(values: np.ndarray, ascending: bool) -> np.ndarray:
    if np.isnan(values).any():
        # pandas' text for the integer cast of a NaN rank, word for word
        raise ValueError(
            "Cannot convert non-finite values (NA or inf) to integer."
            "Replace or remove non-finite values or cast to an integer type"
            "that supports these values (e.g. 'Int64')")
    distinct = np.unique(values)
    rank = np.searchsorted(distinct, values) + 1
    return rank if ascending else len(distinct) + 1 - rank


def prepare_for_print(table) -> tuple:
    """(names, means) -> (the names with any result, ``{entry: "value
    (dense rank)" cells}``): ECE in percent; each entry rounded to its
    precision and ranked on the rounded values, ascending for ECE only."""
    names, cols = table
    keep = ~np.all([np.isnan(cols[e]) for e in ENTRIES], axis=0)
    kept = [n for n, k in zip(names, keep) if k]
    out = {}
    for entry, prec in zip(ENTRIES, PRECISION):
        values = cols[entry][keep] * (100 if entry == "ece" else 1)
        values = np.round(values, prec)
        ranks = _dense_rank(values, ascending=entry == "ece")
        out[entry] = np.array([f"{v} ({r})" for v, r in
                               zip(values.tolist(), ranks.tolist())],
                              dtype=object)
    return kept, out


def to_latex(parts: dict) -> str:
    """``{dataset: prepare_for_print(...)}`` -> the table's LaTeX, ``±`` as
    ``$\\pm$`` and each rank-1 value in bold."""
    latex_str = latex.to_latex(parts).replace(
        "±", r"$\pm$")
    return re.sub(r"([0-9]*\.?[0-9]*) \(1\)", r"\\textbf{\g<1>} (1)",
                  latex_str)


def main():
    parts = {task: prepare_for_print(gather_information(task))
             for task in ("brats", "isic")}
    latex_str = to_latex(parts)
    print(latex_str)
    return latex_str


def cli():
    argparse.ArgumentParser(description="main paper table").parse_args()
    main()


if __name__ == "__main__":
    cli()
