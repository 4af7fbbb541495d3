"""Uncertainty-error precision and recall over the thresholds, one curve a
strategy (``bin/plot_supplmat_error_prec_recall.py`` counterpart).

:func:`precision_recall_points` computes every plotted point with numpy;
:func:`render_precision_recall` draws them through matplotlib, imported
there alone.

  python -m rcu_tpu_torch.cli.plot_supplmat_error_prec_recall [--ds brats|isic]
"""
import argparse
import os

import numpy as np

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.analysis import frames, pyplot, resultdata as resdata


def load_df(task: str):
    """-> (the uncertainty CSVs' rows with their ``run_id`` and
    ``threshold``, the selection's {result id: display name})."""
    data, ids_names = resdata.selection(task)
    files, file_ids, _, file_thresholds = data.get_files(
        list(ids_names), [dirs.UNCERTAINTY_NAME])
    if not files:
        # the JAX tool's text, word for word
        raise SystemExit(
            f"no uncertainty CSVs found for {task} — run bin/eval_uncertainty.py "
            "with the 'bnf_ue' action first")
    df = frames.concat_threshold_frames(zip(file_ids, files, file_thresholds))
    return df, ids_names


def _sort_order(values: np.ndarray) -> np.ndarray:
    """pandas' ``sort_values`` order: the non-NaN values by numpy's
    quicksort (ties as it leaves them), then the NaNs."""
    nan = np.isnan(values)
    idx = np.arange(len(values))
    order = idx[~nan][values[~nan].argsort(kind="quicksort")]
    return np.concatenate([order, idx[nan]])


def precision_recall_points(df: dict, ids_names) -> list:
    """[(name, precision, recall)]: per strategy (the rows whose ``test_id``
    is the result id) the subject-mean error precision and recall of each
    threshold, in ascending precision."""
    def counts(key):
        return df[key].astype(float)

    ue_sens = frames.error_recall(counts("fp"), counts("fn"), counts("fpu"),
                                  counts("fnu"))
    ue_prec = frames.error_precision(counts("tpu"), counts("tnu"),
                                     counts("fpu"), counts("fnu"))
    out = []
    for run_id, name in ids_names.items():
        mask = df["test_id"] == run_id
        if not mask.any():
            continue
        thresholds = df["threshold"][mask]
        _, prec = frames.group_mean(thresholds, ue_prec[mask])
        _, sens = frames.group_mean(thresholds, ue_sens[mask])
        order = _sort_order(prec)
        out.append((name, prec[order], sens[order]))
    return out


def render_precision_recall(points, outfile, with_legend=False):
    plt = pyplot()
    fig, ax = plt.subplots()
    for name, prec, sens in points:
        ax.plot(prec, sens, label=name, marker=".", markersize=6,
                linewidth=0.5)
    ax.tick_params(axis="both", which="major", labelsize=12)
    if with_legend:
        ax.legend()
    ax.set_xlim(0.0, 0.6)
    plt.xlabel("precision", fontsize=14)
    plt.ylabel("recall", fontsize=14)
    plt.savefig(outfile)
    plt.close(fig)


def main(dataset: str):
    if dataset not in ("brats", "isic"):
        raise ValueError('dataset must be "isic" or "brats"')
    df, ids_names = load_df(dataset)
    plot_dir = dirs.BRATS_PLOT_DIR if dataset == "brats" else dirs.ISIC_PLOT_DIR
    out_dir = os.path.join(plot_dir, "suppl_mat")
    os.makedirs(out_dir, exist_ok=True)
    render_precision_recall(
        precision_recall_points(df, ids_names),
        os.path.join(out_dir, f"error_prec_recall_{dataset}.svg"))


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds", type=str, nargs="?", default="brats")
    args = parser.parse_args()
    main(args.ds)


if __name__ == "__main__":
    cli()
