"""The port's analysis layer (``rcu_tpu_torch.analysis``) and its two tables
against the JAX tools (``bin/table_ece_ue_bnf_dice.py``,
``bin/table_supplmat_ece_dataset_vs_meansubject.py``) on the same eval
trees, with both packages' ``directories`` pointed at them.

The trees:
- ``actions``: the JAX package's eval actions over seeded NIfTI
  predictions of three strategies (one per confidence entry), the
  ``tests/test_analysis.py`` pattern;
- ``written``: all eight selection ids written through the JAX direct
  eval's CSV sinks (``tests/test_analysis_parity.build_eval_tree``), and
  copies of it with written cases: tied ``benefit`` means, a subject
  missing from two threshold files, a strategy with ECE but no
  uncertainty CSVs, one with uncertainty CSVs but no ECE, a calibration
  CSV whose ece disagrees with its bins;
- ``port``: the port's own ``evaluate_subjects(..., layout="eval_tree",
  device="cpu")`` on a tiny seeded U-Net.

Bars: the printed LaTeX byte for byte; the numeric frames within 1e-12
relative (the port parses the CSVs' floats as pandas' default parser does,
so they are equal); the same errors, warnings and ``SystemExit`` texts.
The tree builders are shared by the figure and image test files.
"""
import csv
import glob
import importlib.util
import io
import os
import shutil
import sys
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from rcu_tpu import directories as jax_dirs
from rcu_tpu.data import nifti
from rcu_tpu.data.split import save_split
from rcu_tpu.eval import actions as jax_actions
from rcu_tpu.eval import analysis as jax_analysis
from rcu_tpu.eval import evaldata as jax_evaldata
from rcu_tpu_torch import directories as port_dirs
from rcu_tpu_torch.analysis import frames, latex, resultdata
from rcu_tpu_torch.cli import table_ece_ue_bnf_dice as port_table
from rcu_tpu_torch.cli import (
    table_supplmat_ece_dataset_vs_meansubject as port_supp)
from tests.test_analysis_parity import build_eval_tree

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN_DIR = os.path.join(REPO_ROOT, "bin")

# the paper's example subjects (the figure and image tools select them)
BRATS_SUBJECTS = ["Brats18_TCIA01_390_1", "Brats18_CBICA_AUN_1",
                  "Brats18_CBICA_ASY_1"]
ISIC_SUBJECTS = ["ISIC_0012388", "ISIC_0012654", "ISIC_0012447"]
SHAPE = (3, 10, 10)
# one run per confidence entry: run id -> (entry, directories slot)
ACTION_RUNS = {"baseline": ("probabilities", "BASELINE"),
               "aleatoric": ("sigma", "ALEATORIC"),
               "auxiliary_feat": ("confidence", "AUX_FEAT")}
REL = 1e-12


def load_bin(name):
    """A JAX tool of ``bin/``, loaded fresh."""
    if BIN_DIR not in sys.path:
        sys.path.insert(0, BIN_DIR)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(BIN_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ trees

def build_action_tree(root: str) -> dict:
    """Ground truth, seeded predictions of ``ACTION_RUNS`` and the JAX eval
    actions' four CSV families -> the directories' values."""
    rng = np.random.RandomState(4)
    gt_dir = os.path.join(root, "Training")
    pred_dir = os.path.join(root, "preds")
    for s in BRATS_SUBJECTS:
        d = os.path.join(gt_dir, "HGG", s)
        os.makedirs(d)
        seg = (rng.rand(*SHAPE) < 0.3).astype(np.uint8)
        for e in ("flair", "t1", "t1ce", "t2"):
            nifti.write(rng.rand(*SHAPE).astype(np.float32) + 0.1,
                        os.path.join(d, f"{s}_{e}.nii.gz"))
        nifti.write(seg, os.path.join(d, f"{s}_seg.nii.gz"))
        for name, (entry, _) in ACTION_RUNS.items():
            run = os.path.join(pred_dir, name)
            os.makedirs(run, exist_ok=True)
            probs = rng.rand(*SHAPE).astype(np.float32)
            nifti.write(probs, os.path.join(run, f"{s}_{entry}.nii.gz"))
            nifti.write((probs > 0.5).astype(np.uint8),
                        os.path.join(run, f"{s}_prediction.nii.gz"))
    split_dir = os.path.join(root, "splits")
    os.makedirs(split_dir)
    split_file = os.path.join(split_dir, "split_brats18_100-25-160.json")
    save_split(split_file, [], [], BRATS_SUBJECTS)
    eval_dir = os.path.join(root, "eval")
    min_max_dir = os.path.join(eval_dir, "minmax")
    for name, (entry, _) in ACTION_RUNS.items():
        ed = jax_evaldata.get_brats_data(
            jax_evaldata.EvalData(name, os.path.join(pred_dir, name), entry),
            in_dir=gt_dir, split_file=split_file)
        for a in jax_actions.get_actions(
                ["minmax", "ece_dice", "calib", "bnf_ue"], min_max_dir,
                eval_dir, "foreground"):
            a.setup_eval(ed)
            a.start_eval()
            for sf in ed.subject_files:
                a.eval_subject(sf, jax_analysis.Loader())
            a.finish_eval()
    return {"BRATS_EVAL_DIR": eval_dir, "BRATS_ORIG_DATA_DIR": gt_dir,
            "BRATS_PREDICT_DIR": pred_dir, "SPLITS_DIR": split_dir,
            **{f"BRATS_{slot}_PREDICT": name
               for name, (_, slot) in ACTION_RUNS.items()}}


def build_port_tree(root) -> str:
    """The port's direct eval (deterministic, MC, aleatoric) of a tiny
    seeded U-Net on a 4-subject store, eval_tree layout; -> the eval dir."""
    from rcu_tpu_torch.data.h5 import SubjectDataset
    from rcu_tpu_torch.eval.direct import evaluate_subjects
    from rcu_tpu_torch.models.unet import UNet
    from tests.test_torch_direct import make_store
    dataset = SubjectDataset(make_store(root))
    torch.manual_seed(0)
    params = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4)
    model = UNet(**params).eval()
    sigma_model = UNet(**params, sigma_out=True).eval()
    out = str(root / "eval")
    for models, strategy, run_id, mc in (
            (model, "deterministic", "baseline", 0),
            (model, "mc", "baseline_mc", 2),
            (sigma_model, "aleatoric", "aleatoric", 0)):
        evaluate_subjects(models, dataset, out, strategy=strategy,
                          run_id=run_id, mc=mc, batch_size=2, device="cpu",
                          layout="eval_tree")
    dataset.close()
    return out


def rewrite_csv(path, fn):
    """Replace a CSV's rows by ``fn(header, rows)``."""
    with open(path, newline="") as f:
        header, *rows = list(csv.reader(f))
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(header)
        writer.writerows(fn(header, rows))


def uncertainty_files(eval_dir, result_id):
    return sorted(glob.glob(os.path.join(
        eval_dir, "uncertainty", f"eval_uncertainty_{result_id}_th*.csv")))


def tie_benefits(eval_dir, result_id):
    """Every threshold file of ``result_id`` with the same benefit pattern:
    the first subject's corrected dice above its dice, the others' below,
    so that every threshold's benefit mean ties."""
    def fn(header, rows):
        c, d = header.index("corrected_dice"), header.index("dice")
        for i, row in enumerate(rows):
            row[c] = repr(float(row[d]) + (0.01 if i == 0 else -0.01))
        return rows
    for path in uncertainty_files(eval_dir, result_id):
        rewrite_csv(path, fn)


def drop_subject(eval_dir, result_id, subject, codes=("020", "060")):
    for code in codes:
        rewrite_csv(os.path.join(
            eval_dir, "uncertainty",
            f"eval_uncertainty_{result_id}_th{code}.csv"),
            lambda h, rows: [r for r in rows if r[1] != subject])


def break_calibration(eval_dir, result_id):
    """One row's ece off its bins by 0.01."""
    def fn(header, rows):
        e = header.index("ece")
        rows[1][e] = repr(float(rows[1][e]) + 0.01)
        return rows
    rewrite_csv(os.path.join(eval_dir, "calibration",
                             f"eval_calibration_{result_id}.csv"), fn)


def written_tree(root, task="brats", seed=7) -> str:
    """All eight selection ids through the JAX sinks."""
    path = os.path.join(str(root), f"written_{task}_{seed}")
    build_eval_tree(path, masked=task == "brats",
                    subjects=BRATS_SUBJECTS if task == "brats"
                    else ISIC_SUBJECTS, seed=seed)
    return path


def variant(base, root, name, *edits) -> str:
    """A copy of the tree ``base`` with ``edits`` (functions of the copy)."""
    path = os.path.join(str(root), name)
    shutil.copytree(base, path)
    for edit in edits:
        edit(path)
    return path


def written_cases(written) -> list:
    """The edits of the ``cases`` tree: tied benefit means in baseline and
    aleatoric, no uncertainty CSVs for center, no ECE CSV for center_mc."""
    return [lambda p: tie_benefits(p, "baseline"),
            lambda p: tie_benefits(p, "aleatoric_globalrescale"),
            *[lambda p, f=os.path.basename(f): os.remove(
                os.path.join(p, "uncertainty", f))
              for f in uncertainty_files(written, "center")],
            lambda p: os.remove(os.path.join(
                p, "ece_foreground", "eval_ece_center_mc.csv"))]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """{name: brats eval dir} and the ISIC eval dir the main table needs
    beside each."""
    root = tmp_path_factory.mktemp("analysis_tables")
    written = written_tree(root)
    out = {
        "actions": build_action_tree(str(root / "actions"))["BRATS_EVAL_DIR"],
        "written": written,
        "cases": variant(written, root, "cases", *written_cases(written)),
        "port": build_port_tree(root / "port"),
    }
    return out, written_tree(root, "isic", seed=8), root


def point(monkeypatch, **values):
    """Both packages' directories at the same values."""
    for mod in (jax_dirs, port_dirs):
        for key, value in values.items():
            monkeypatch.setattr(mod, key, value)


def run_both(fn_jax, fn_port):
    """(result or exception, warnings as text) of each callable."""
    out = []
    for fn in (fn_jax, fn_port):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                result = fn()
            except (Exception, SystemExit) as e:  # compared below
                result = e
        out.append((result, [str(w.message) for w in caught
                             if issubclass(w.category, UserWarning)]))
    return out


def same_error(a, b):
    """The same type (pandas' own errors: their builtin base) and text."""
    assert isinstance(a, type(b)) or isinstance(b, type(a)), (a, b)
    assert str(a) == str(b)


# ------------------------------------------------------------ the frames

def test_read_csv_equals_pandas(trees):
    """Every CSV of every tree: the same columns, dtypes' kinds and values
    (floats bitwise)."""
    named, isic, _ = trees
    paths = [p for d in list(named.values()) + [isic]
             for p in glob.glob(os.path.join(d, "*", "*.csv"))]
    assert len(paths) > 200
    for path in paths:
        want = pd.read_csv(path)
        got = frames.read_csv(path)
        assert list(got) == list(want.columns), path
        for col, values in got.items():
            ref = want[col].to_numpy()
            kind = "O" if ref.dtype == object else ref.dtype.kind
            assert values.dtype.kind == kind, (path, col)
            if kind == "f":
                assert np.array_equal(values.view(np.int64),
                                      ref.view(np.int64)), (path, col)
            else:
                assert np.array_equal(values, ref), (path, col)


@pytest.mark.parametrize("text", [
    "0.1", "-0.0", "1e-05", "2.5E+20", "0.33766233921051025",
    "123456789012345678901234", "0.000000000000000000000000000123456789",
    "5", ".5", "5.", "1e-320", "2.2250738585072014e-308",
    "9.999999999999999e+307", "nan", "-inf"])
def test_parse_float_is_pandas_parser(text):
    want = pd.read_csv(io.StringIO(f"v\n{text}\n"),
                       dtype={"v": np.float64})["v"].to_numpy()[0]
    got = frames.parse_float(text)
    assert np.array_equal(np.float64(got).view(np.int64),
                          np.float64(want).view(np.int64)) or (
        np.isnan(got) and np.isnan(want)), (text, got, want)


def test_parse_float_random_reprs():
    rng = np.random.default_rng(0)
    values = np.concatenate([
        rng.random(3000).astype(np.float32).astype(np.float64),
        rng.random(3000) * 10.0 ** rng.integers(-12, 12, 3000)
        * rng.choice([-1, 1], 3000)])
    texts = [repr(float(v)) for v in values]
    want = pd.read_csv(io.StringIO(
        "v\n" + "\n".join(texts)))["v"].to_numpy()
    got = np.array([frames.parse_float(t) for t in texts])
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    # pandas' parser is not the nearest double everywhere: the port
    # follows it, not float()
    assert (got != values).any()


def test_group_mean_and_first_max_equal_pandas():
    rng = np.random.default_rng(1)
    keys = rng.choice(["b_th010", "a_th005", "c", "a_th050"], 500)
    values = rng.random(500) * 10.0 ** rng.integers(-3, 3, 500)
    values[rng.random(500) < 0.1] = np.nan
    want = pd.Series(values).groupby(keys).mean()
    got_keys, got = frames.group_mean(keys, values)
    assert got_keys == list(want.index)
    assert np.array_equal(got, want.to_numpy())
    bools = rng.random(60) < 0.5
    bkeys = np.repeat(["x_th010", "x_th005", "x_th020"], 20)
    bools[:20] = bools[20:40]  # a tie between th010 and th005
    want = pd.Series(bools).groupby(bkeys).mean()
    got_keys, got = frames.group_mean(bkeys, bools)
    assert np.array_equal(got, want.to_numpy())
    assert frames.first_max(got_keys, got) == want.idxmax()
    with pytest.raises(ValueError, match="Encountered all NA values"):
        frames.first_max(["a"], np.array([np.nan]))


def test_stack_and_merge_equal_pandas():
    a = {"subject_name": np.array(["s2", "s1", "s3"], dtype=object),
         "x": np.array([1, 2, 3])}
    b = {"subject_name": np.array(["s1", "s2", "s1"], dtype=object),
         "y": np.array([0.5, 1.5, 2.5])}
    want = pd.merge(pd.DataFrame(a), pd.DataFrame(b), on=["subject_name"])
    got = frames.merge(a, b, ["subject_name"])
    assert list(got) == list(want.columns)
    for col in got:
        assert list(got[col]) == list(want[col])
    c = {"x": np.array([4]), "z": np.array([True])}
    want = pd.concat([pd.DataFrame(a), pd.DataFrame(c)], keys=["k1", "k2"],
                     names=["run_id"])
    got = frames.stack([a, c], ["k1", "k2"])
    assert list(got["run_id"]) == list(want.index.get_level_values(0))
    assert list(got)[1:] == list(want.columns)
    for col in want.columns:
        assert [str(v) for v in got[col]] == [str(v) for v in want[col]]


@pytest.mark.parametrize("case", ["floats", "strings", "one_column_groups",
                                  "disjoint_rows"])
def test_latex_equals_pandas(case):
    nan = np.nan
    if case == "floats":
        parts = {"brats": (["b", "c", "a"], {
            "ece": np.array([1.5, nan, 3.25]),
            "ds_ece": np.array([2.0, nan, 1 / 3])}),
            "isic": (["z", "a"], {"ece": np.array([1.0000005, -0.0]),
                                  "ds_ece": np.array([1e16, 2.5e-7])})}
    elif case == "strings":
        parts = {"brats": (["x (1)", "y"], {
            "ece": np.array(["30.351 (3)", "0.0 (2)"], dtype=object),
            "dice": np.array(["0.344 (1)", "1e-05 (2)"], dtype=object)}),
            "isic": (["y"], {"ece": np.array(["0.5 (1)"], dtype=object),
                             "dice": np.array(["0.5 (1)"], dtype=object)})}
    elif case == "one_column_groups":
        parts = {"brats": (["a"], {"ece": np.array([0.25])}),
                 "isic": (["a"], {"ece": np.array([0.5])})}
    else:
        parts = {"brats": (["a", "q", "b"], {"ece": np.array([1.0, 2.0, 3.0])}),
                 "isic": (["z", "a"], {"ece": np.array([4.0, 5.0])})}
    want = pd.concat(
        [pd.DataFrame(cols, index=pd.Index(index, name="test_id"))
         for index, cols in parts.values()], axis=1, keys=list(parts))
    assert latex.to_latex(parts) == want.to_latex()


def test_resultdata_discovery_and_warnings(trees, monkeypatch):
    named, isic, _ = trees
    tree = named["cases"]
    from rcu_tpu.analysis import resultdata as jax_resultdata
    jax_data = jax_resultdata.BratsResultData(tree)
    port_data = resultdata.BratsResultData(tree)
    assert jax_data.id_category_dict == port_data.id_category_dict
    assert jax_data.get_ids() == port_data.get_ids()
    assert jax_data.get_categories() == port_data.get_categories()
    for args in ((["baseline", "nope", "center"], ["uncertainty",
                                                  "ece_foreground"]),
                 (["center", "baseline"], ["uncertainty", "calibration"],
                  ["005", "007", "095"]),
                 (["nope"], ["minmax"])):
        (jax_out, jax_warn), (port_out, port_warn) = run_both(
            lambda: jax_data.get_files(*args),
            lambda: port_data.get_files(*args))
        assert jax_out == port_out
        assert jax_warn == port_warn and jax_warn
    assert resultdata.brats_selection_id_name_dict == \
        jax_resultdata.brats_selection_id_name_dict
    assert resultdata.isic_selection_id_name_dict == \
        jax_resultdata.isic_selection_id_name_dict
    point(monkeypatch, BRATS_EVAL_DIR=tree, ISIC_EVAL_DIR=isic)
    assert resultdata.IsicResultData().id_category_dict == \
        jax_resultdata.IsicResultData().id_category_dict


# ------------------------------------------------------------ main table

def _jax_table_numbers(df):
    return list(df.index), {c: df[c].to_numpy() for c in df.columns}


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", ["actions", "written", "cases", "port"])
def test_main_table(trees, monkeypatch, capsys, name):
    """The means, the cells and the printed LaTeX of both tools."""
    named, isic, _ = trees
    point(monkeypatch, BRATS_EVAL_DIR=named[name], ISIC_EVAL_DIR=isic)
    jax_tool = load_bin("table_ece_ue_bnf_dice")
    df = jax_tool.gather_information("brats")
    names, cols = port_table.gather_information("brats")
    want_names, want = _jax_table_numbers(df)
    assert names == want_names
    assert list(cols) == list(want)
    for col, values in cols.items():
        np.testing.assert_allclose(values, want[col], rtol=REL, atol=0,
                                   err_msg=col)
    kept, cells = port_table.prepare_for_print((names, cols))
    printable = jax_tool.prepare_for_print(df)
    assert kept == list(printable.index)
    for entry in port_table.ENTRIES:
        assert list(cells[entry]) == list(printable[entry])
    if name == "cases":
        # the tied benefit means pick the first sorted run id (th005); a
        # strategy without uncertainty CSVs, or without ECE, has no row
        assert df.loc["baseline", "benefit_threshold"] == 0.05
        assert df.loc["aleatoric", "benefit_threshold"] == 0.05
        assert "center" not in kept and "center+MC" not in kept
    capsys.readouterr()

    jax_tool.main()
    jax_out = capsys.readouterr().out
    port_latex = port_table.main()
    port_out = capsys.readouterr().out
    assert port_out == jax_out and port_latex in port_out
    assert "\\textbf{" in port_out
    if name == "cases":
        assert jax_out.count("missing ece id_ center_mc\n") == 11


def test_main_table_errors(trees, tmp_path, monkeypatch):
    """A subject missing from two threshold files fails the dice check's
    comparison, a dice that differs fails the check, and a dataset with no
    CSVs ends the tool: the same error, the same text."""
    named, isic, root = trees
    missing = variant(named["written"], tmp_path, "missing_rows",
                      lambda p: drop_subject(p, "ensemble", BRATS_SUBJECTS[1]))

    def off_dice(p):
        def fn(header, rows):
            d = header.index("dice")
            rows[0][d] = repr(float(rows[0][d]) + 0.01)
            return rows
        rewrite_csv(os.path.join(p, "ece_foreground", "eval_ece_center.csv"),
                    fn)
    bad_dice = variant(named["written"], tmp_path, "bad_dice", off_dice)
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    jax_tool = load_bin("table_ece_ue_bnf_dice")
    for tree, error in ((missing, ValueError), (bad_dice, AssertionError),
                        (empty, SystemExit)):
        point(monkeypatch, BRATS_EVAL_DIR=tree, ISIC_EVAL_DIR=isic)
        (jax_err, jax_warn), (port_err, port_warn) = run_both(
            lambda: jax_tool.gather_information("brats"),
            lambda: port_table.gather_information("brats"))
        assert isinstance(jax_err, error)
        same_error(jax_err, port_err)
        assert jax_warn == port_warn
    # a dataset without results ends main() before anything prints
    point(monkeypatch, BRATS_EVAL_DIR=named["written"], ISIC_EVAL_DIR=empty)
    (jax_err, _), (port_err, _) = run_both(jax_tool.main, port_table.main)
    same_error(jax_err, port_err)


def test_main_table_rank_ties_and_rounding():
    """Dense ranks on the rounded values (ties share a rank, the next is
    one more), ascending for ECE only, numpy's rounding; a NaN cell
    refuses as pandas' integer cast does."""
    jax_tool = load_bin("table_ece_ue_bnf_dice")
    names = ["a", "b", "c", "d"]
    cols = {"ece": np.array([0.0012344, 0.0012346, 0.0012345, np.nan]),
            "error": np.array([0.12345, 0.1235, 0.12349, np.nan]),
            "benefit": np.array([0.125, 0.375, 0.125, np.nan]),
            "dice": np.array([0.7, 0.7, 0.70049, np.nan]),
            "benefit_threshold": np.zeros(4), "error_threshold": np.zeros(4)}
    df = pd.DataFrame(cols, index=pd.Index(names, name="test_id"))
    kept, cells = port_table.prepare_for_print((names, cols))
    want = jax_tool.prepare_for_print(df)
    assert kept == list(want.index) == ["a", "b", "c"]
    for entry in port_table.ENTRIES:
        assert list(cells[entry]) == list(want[entry])
    cols["error"][1] = np.nan
    df = pd.DataFrame(cols, index=pd.Index(names, name="test_id"))
    (jax_err, _), (port_err, _) = run_both(
        lambda: jax_tool.prepare_for_print(df),
        lambda: port_table.prepare_for_print((names, cols)))
    assert isinstance(jax_err, ValueError)
    same_error(jax_err, port_err)


# ----------------------------------------------------- supplementary table

@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("name", ["actions", "written", "port"])
def test_supplementary_table(trees, monkeypatch, capsys, name):
    named, isic, _ = trees
    point(monkeypatch, BRATS_EVAL_DIR=named[name], ISIC_EVAL_DIR=isic)
    jax_tool = load_bin("table_supplmat_ece_dataset_vs_meansubject")
    want = jax_tool.gather("brats")
    names, cols = port_supp.gather("brats")
    assert names == list(want.index) and want.index.name == "test_id"
    for col in ("ece", "ds_ece"):
        np.testing.assert_allclose(cols[col], want[col].to_numpy(), rtol=REL,
                                   atol=0, err_msg=col)
    capsys.readouterr()
    jax_tool.main()
    jax_out = capsys.readouterr().out
    port_latex = port_supp.main()
    port_out = capsys.readouterr().out
    assert port_out == jax_out and port_latex in port_out
    assert "\\multicolumn{2}{r}{isic}" in port_out


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_supplementary_table_skips_and_exits(trees, tmp_path, monkeypatch,
                                             capsys):
    """A calibration CSV whose ece disagrees with its bins: gather raises,
    main prints ``skipping brats:`` and keys the ISIC part as the JAX tool
    does (the first key); no calibration CSVs end the tool."""
    named, isic, _ = trees
    bad = variant(named["written"], tmp_path, "bad_calibration",
                  lambda p: break_calibration(p, "center_mc"))
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    jax_tool = load_bin("table_supplmat_ece_dataset_vs_meansubject")
    point(monkeypatch, BRATS_EVAL_DIR=bad, ISIC_EVAL_DIR=isic)
    (jax_err, _), (port_err, _) = run_both(lambda: jax_tool.gather("brats"),
                                           lambda: port_supp.gather("brats"))
    assert isinstance(jax_err, AssertionError)
    same_error(jax_err, port_err)
    capsys.readouterr()
    jax_tool.main()
    jax_out = capsys.readouterr().out
    port_supp.main()
    assert capsys.readouterr().out == jax_out
    assert jax_out.startswith("skipping brats: \n")
    point(monkeypatch, BRATS_EVAL_DIR=named["written"], ISIC_EVAL_DIR=empty)
    (jax_err, _), (port_err, _) = run_both(jax_tool.main, port_supp.main)
    assert isinstance(jax_err, SystemExit)
    same_error(jax_err, port_err)
