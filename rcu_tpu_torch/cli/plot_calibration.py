"""Reliability diagrams: the dataset-level count-weighted curve of each
strategy, per-subject curves, and the over/under-confidence percentages
(``bin/plot_calibration.py`` counterpart).

Every plotted point comes from a numpy function that does not draw
(:func:`all_runs_curves`, :func:`subject_curves`);
:func:`render_reliability` and :func:`save_legend` draw them through
matplotlib, imported there alone (the tables' machines may lack it).

  python -m rcu_tpu_torch.cli.plot_calibration [--ds brats|isic]
"""
import argparse
import os

import numpy as np

from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.analysis import frames, pyplot, resultdata as resdata

BRATS_SUBJECTS = ["Brats18_TCIA01_390_1", "Brats18_CBICA_AUN_1",
                  "Brats18_CBICA_ASY_1"]
ISIC_SUBJECTS = ["ISIC_0012388", "ISIC_0012654", "ISIC_0012447"]


def load_calibration_df(task: str):
    """-> (the calibration CSVs' rows, ``run_id`` their file's result id;
    the selection's {result id: display name})."""
    data, ids_names = resdata.selection(task)
    files, file_ids, _, _ = data.get_files(list(ids_names), [dirs.CALIB_NAME])
    if not files:
        # the JAX tool's text, word for word
        raise SystemExit(
            f"no calibration CSVs found for {task} — run bin/eval_uncertainty.py "
            "with the 'calib' action first")
    df = frames.stack([frames.read_csv(f) for f in files], list(file_ids))
    return df, ids_names


def _runs(df: dict, ids_names):
    """(display name, the run's rows) of each selected run present."""
    present = set(df["run_id"].tolist())
    for run_id, name in ids_names.items():
        if run_id in present:
            yield name, frames.rows(df, df["run_id"] == run_id)


def all_runs_curves(df: dict, ids_names) -> list:
    """[(name, confidence, accuracy)]: each run's dataset-level curve over
    its non-empty bins."""
    out = []
    for name, group in _runs(df, ids_names):
        avg_conf, pos_frac, _ = frames.dataset_level_reliability(group)
        out.append((name, np.ma.compressed(avg_conf),
                    np.ma.compressed(pos_frac)))
    return out


def subject_curves(df: dict, ids_names, subject_name: str):
    """[(name, confidence, accuracy)] of one subject's bins in each run; None
    where the subject has no rows."""
    group = frames.rows(df, df["subject_name"] == subject_name)
    if frames.n_rows(group) == 0:
        return None
    out = []
    for name, rows in _runs(group, ids_names):
        conf, frac, _ = frames.get_bins(rows)
        out.append((name, np.ma.compressed(conf), np.ma.compressed(frac)))
    return out


def render_reliability(curves, path, legend=False):
    """A reliability diagram: the diagonal, then each (name, x, y)."""
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    plt.xlabel("confidence", fontsize=18)
    plt.ylabel("accuracy", fontsize=18)
    ax.plot([0, 1], [0, 1], "--", color="Black")
    for name, x, y in curves:
        ax.plot(x, y, "-", label=name)
    ax.tick_params(axis="both", which="major", labelsize=14)
    if legend:
        plt.legend()
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)


def save_legend(ids_names, out_dir):
    plt = pyplot()
    fig_legend = plt.figure(figsize=(11.5, 0.5))
    fig, ax = plt.subplots()
    bars = [ax.plot(range(2), range(2), label=name)[0]
            for name in ids_names.values()]
    fig_legend.legend(bars, list(ids_names.values()), loc="center",
                      ncol=len(ids_names), frameon=False)
    fig_legend.savefig(os.path.join(out_dir, "legend.svg"), bbox_inches="tight")
    plt.close("all")


def miscalibration_percentage(df: dict, ids_names, task):
    """The signed calibration error's 90th percentile over the runs, and the
    shares of subjects over, under and well calibrated against it; prints
    them and returns (over, under, well)."""
    voxelwise = []
    for _, group in _runs(df, ids_names):
        conf, frac, counts = frames.get_bins(group)
        bin_sum = counts.sum(axis=0)
        avg_conf = np.ma.compressed((conf * counts).sum(axis=0) / bin_sum)
        pos_frac = np.ma.compressed((frac * counts).sum(axis=0) / bin_sum)
        voxelwise.append((pos_frac - avg_conf).mean())

    threshold = np.percentile(np.asarray(voxelwise), 90)

    subjectwise = []
    for subject in frames.unique_sorted(df["subject_name"]):
        group = frames.rows(df, df["subject_name"] == subject)
        run_errors = []
        for _, rows in _runs(group, ids_names):
            conf, frac, _ = frames.get_bins(rows)
            run_errors.append((frac - conf).mean())
        if run_errors:  # a subject can miss runs (a partial eval)
            subjectwise.append(np.mean(run_errors))
    calib_mean = np.asarray(subjectwise)

    under = (calib_mean > threshold).mean()
    over = (calib_mean < -threshold).mean()
    well = np.logical_and(calib_mean <= threshold,
                          calib_mean >= -threshold).mean()
    print(f"[{task}] overall_err:{threshold:.3f} \t overconfident: {over:.2f} "
          f"\t underconfident: {under:.2f} \t well-calibrated: {well:.2f}")
    return over, under, well


def main(dataset: str):
    if dataset not in ("brats", "isic"):
        raise ValueError('dataset must be "isic" or "brats"')
    df, ids_names = load_calibration_df(dataset)
    if dataset == "brats":
        subjects = BRATS_SUBJECTS
        out_dir = os.path.join(dirs.BRATS_PLOT_DIR, dirs.CALIB_NAME)
    else:
        subjects = ISIC_SUBJECTS
        out_dir = os.path.join(dirs.ISIC_PLOT_DIR, dirs.CALIB_NAME)
    os.makedirs(out_dir, exist_ok=True)
    render_reliability(all_runs_curves(df, ids_names),
                       os.path.join(out_dir, f"summary_all_{dataset}.svg"))
    for subject_name in subjects:
        curves = subject_curves(df, ids_names, subject_name)
        if curves is not None:
            render_reliability(curves, os.path.join(
                out_dir, f"subject_{subject_name}.svg"))
    save_legend(ids_names, out_dir)
    miscalibration_percentage(df, ids_names, dataset)


def cli():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ds", type=str, nargs="?", default="brats")
    args = parser.parse_args()
    main(args.ds)


if __name__ == "__main__":
    cli()
