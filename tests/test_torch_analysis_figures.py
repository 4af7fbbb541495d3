"""The port's figure tools (``rcu_tpu_torch.cli.plot_calibration``,
``rcu_tpu_torch.cli.plot_supplmat_error_prec_recall``) against the JAX
tools of ``bin/`` on the same eval trees (``test_torch_analysis_tables``'
builders).

Every figure either tool saves is caught at ``Figure.savefig``: its file
name and each line's label and x/y data must be equal, and the port's
numeric cores (which draw nothing) must give the same arrays. The
miscalibration line must print the same text, and the errors (an ECE that
disagrees with its bins, no CSVs) must be the same.
"""
import os

import matplotlib
import numpy as np
import pytest
from matplotlib.figure import Figure

from rcu_tpu_torch.cli import plot_calibration as port_calib
from rcu_tpu_torch.cli import plot_supplmat_error_prec_recall as port_pr
from tests.test_torch_analysis_tables import (
    BRATS_SUBJECTS, break_calibration, build_action_tree, build_port_tree,
    drop_subject, load_bin, point, run_both, same_error, variant,
    written_cases, written_tree)

matplotlib.use("Agg")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("analysis_figures")
    written = written_tree(root)
    return {
        "actions": build_action_tree(str(root / "actions"))["BRATS_EVAL_DIR"],
        "written": written,
        "cases": variant(written, root, "cases", *written_cases(written),
                         lambda p: drop_subject(p, "ensemble",
                                                BRATS_SUBJECTS[1])),
        "port": build_port_tree(root / "port"),
    }


@pytest.fixture
def saved(monkeypatch):
    """[(file name, [(label, x, y) of every line of every axes])] of each
    figure saved, in order; the files are written as well."""
    figures = []
    write = Figure.savefig

    def catch(fig, path, *args, **kwargs):
        figures.append((os.path.basename(path), [
            (line.get_label(), np.asarray(line.get_xdata(), np.float64),
             np.asarray(line.get_ydata(), np.float64))
            for ax in fig.axes for line in ax.get_lines()]))
        return write(fig, path, *args, **kwargs)

    monkeypatch.setattr(Figure, "savefig", catch)
    return figures


def same_figures(got, want):
    assert [name for name, _ in got] == [name for name, _ in want]
    for (name, lines), (_, want_lines) in zip(got, want):
        assert len(lines) == len(want_lines), name
        for (label, x, y), (w_label, w_x, w_y) in zip(lines, want_lines):
            assert label == w_label, name
            assert np.array_equal(x, w_x) and np.array_equal(y, w_y), \
                (name, label)


def same_curves(curves, lines):
    """A numeric core's [(name, x, y)] against the drawn lines (the
    reliability diagrams' diagonal first)."""
    assert [(n, x.tolist(), y.tolist()) for n, x, y in curves] == \
        [(n, x.tolist(), y.tolist()) for n, x, y in lines]


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", ["actions", "written", "port"])
def test_calibration_figures(trees, tmp_path, monkeypatch, saved, capsys,
                             name):
    """The three kinds of SVG and the legend, the same lines; the
    miscalibration line."""
    jax_tool = load_bin("plot_calibration")
    subjects = BRATS_SUBJECTS[:2] + ["s01", "absent"]
    for mod in (jax_tool, port_calib):
        monkeypatch.setattr(mod, "BRATS_SUBJECTS", subjects)
    point(monkeypatch, BRATS_EVAL_DIR=trees[name],
          BRATS_PLOT_DIR=str(tmp_path / "jax"))
    capsys.readouterr()
    jax_tool.main("brats")
    jax_out = capsys.readouterr().out
    want = list(saved)
    saved.clear()
    point(monkeypatch, BRATS_PLOT_DIR=str(tmp_path / "port"))
    port_calib.main("brats")
    assert capsys.readouterr().out == jax_out
    assert jax_out.startswith("[brats] overall_err:")
    same_figures(saved, want)
    names = [n for n, _ in want]
    assert names[0] == "summary_all_brats.svg" and names[-1] == "legend.svg"
    assert len(names) == 2 + (2 if name != "port" else 1)
    assert sorted(os.listdir(tmp_path / "port" / "calibration")) == \
        sorted(os.listdir(tmp_path / "jax" / "calibration")) == sorted(names)

    df, ids_names = port_calib.load_calibration_df("brats")
    same_curves(port_calib.all_runs_curves(df, ids_names), want[0][1][1:])
    for fig_name, lines in want[1:-1]:
        subject = fig_name[len("subject_"):-len(".svg")]
        same_curves(port_calib.subject_curves(df, ids_names, subject),
                    lines[1:])
    assert port_calib.subject_curves(df, ids_names, "absent") is None
    jax_df, jax_ids = jax_tool.load_calibration_df("brats")
    assert port_calib.miscalibration_percentage(df, ids_names, "brats") == \
        jax_tool.miscalibration_percentage(jax_df, jax_ids, "brats")


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_calibration_errors(trees, tmp_path, monkeypatch, saved):
    """An ECE that disagrees with its bins fails before any file; a dataset
    without calibration CSVs ends the tool; a dataset name is checked."""
    jax_tool = load_bin("plot_calibration")
    bad = variant(trees["written"], tmp_path, "bad",
                  lambda p: break_calibration(p, "ensemble"))
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    for tree, error in ((bad, AssertionError), (empty, SystemExit)):
        point(monkeypatch, BRATS_EVAL_DIR=tree,
              BRATS_PLOT_DIR=str(tmp_path / "plots"))
        (jax_err, _), (port_err, _) = run_both(
            lambda: jax_tool.main("brats"), lambda: port_calib.main("brats"))
        assert isinstance(jax_err, error)
        same_error(jax_err, port_err)
        assert saved == []
    (jax_err, _), (port_err, _) = run_both(
        lambda: jax_tool.main("other"), lambda: port_calib.main("other"))
    assert isinstance(jax_err, ValueError)
    same_error(jax_err, port_err)


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", ["actions", "written", "cases", "port"])
def test_precision_recall_figure(trees, tmp_path, monkeypatch, saved, name):
    """The same SVG name and points: threshold means over the rows present
    (``cases``: a subject missing from two thresholds, a strategy without
    uncertainty CSVs), in ascending precision."""
    jax_tool = load_bin("plot_supplmat_error_prec_recall")
    point(monkeypatch, BRATS_EVAL_DIR=trees[name],
          BRATS_PLOT_DIR=str(tmp_path / "jax"))
    jax_tool.main("brats")
    want = list(saved)
    saved.clear()
    point(monkeypatch, BRATS_PLOT_DIR=str(tmp_path / "port"))
    port_pr.main("brats")
    same_figures(saved, want)
    assert [n for n, _ in want] == ["error_prec_recall_brats.svg"]
    assert os.path.exists(tmp_path / "port" / "suppl_mat" /
                          "error_prec_recall_brats.svg")
    points = port_pr.precision_recall_points(*port_pr.load_df("brats"))
    same_curves(points, want[0][1])
    assert len(points) == {"actions": 3, "written": 8, "cases": 7,
                           "port": 3}[name]


def test_precision_recall_sort_keeps_quicksort_ties():
    """Equal precisions keep numpy quicksort's order (pandas' sort), NaN
    last."""
    import pandas as pd
    values = np.array([0.3, np.nan, 0.1, 0.3, 0.2, 0.1, np.nan, 0.3] * 3)
    frame = pd.DataFrame({"ue_prec": values, "i": np.arange(len(values))})
    want = frame.sort_values("ue_prec")["i"].to_numpy()
    assert np.array_equal(port_pr._sort_order(values), want)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_precision_recall_without_csvs(tmp_path, monkeypatch):
    jax_tool = load_bin("plot_supplmat_error_prec_recall")
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    point(monkeypatch, BRATS_EVAL_DIR=empty, ISIC_EVAL_DIR=empty)
    for ds in ("brats", "isic", "other"):
        (jax_err, _), (port_err, _) = run_both(
            lambda: jax_tool.main(ds), lambda: port_pr.main(ds))
        assert isinstance(jax_err, ValueError if ds == "other" else SystemExit)
        same_error(jax_err, port_err)


def test_error_precision_recall_conventions():
    """0/0 is 1 in both; the JAX functions' results bitwise."""
    from rcu_tpu.analysis import frames as jax_frames
    from rcu_tpu_torch.analysis import frames
    rng = np.random.default_rng(2)
    c = {k: rng.integers(0, 3, 200).astype(float)
         for k in ("tpu", "tnu", "fpu", "fnu", "fp", "fn")}
    assert np.array_equal(
        frames.error_recall(c["fp"], c["fn"], c["fpu"], c["fnu"]),
        jax_frames.pandas_error_recall(c["fp"], c["fn"], c["fpu"], c["fnu"]),
        equal_nan=True)
    assert np.array_equal(
        frames.error_precision(c["tpu"], c["tnu"], c["fpu"], c["fnu"]),
        jax_frames.pandas_error_precision(c["tpu"], c["tnu"], c["fpu"],
                                          c["fnu"]), equal_nan=True)
    zeros = np.zeros(1)
    assert frames.error_recall(zeros, zeros, zeros, zeros)[0] == 1.0
    assert frames.error_precision(zeros, zeros, zeros, zeros)[0] == 1.0
