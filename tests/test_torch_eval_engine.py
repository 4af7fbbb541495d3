"""The port's offline eval engine (``rcu_tpu_torch.cli.eval_uncertainty``,
``eval/{actions,analysis,kernels,evaldata,hooks}``) against
``bin/eval_uncertainty.py`` on the same NIfTI tree, written once by the
JAX package's staged test runs of the six confidence protocols (baseline,
baseline_mc, ensemble, aleatoric, auxiliary_feat, auxiliary_segm) over a
BraTS-layout ground-truth tree: ``minmax``, ``ece_dice`` (on the t2
foreground), ``calib`` and ``bnf_ue`` must write the same CSV files, with
integer and boolean cells exact and floats at rtol 1e-4. The ISIC half is
``tests/test_torch_eval_engine_isic.py``.

Also: the threshold-collision ``ValueError``, the history reset of a pass
reused across runs, and the error metrics' 0/0 -> 1."""
import csv
import os

import numpy as np
import pytest
import torch

from bin import eval_uncertainty as jax_eval_cli
from rcu_tpu import directories as jax_dirs
from rcu_tpu import strategies as jax_strategies
from rcu_tpu.data import h5, nifti
from rcu_tpu.data.nifti import ImageProperties
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval import actions as jax_actions
from rcu_tpu.ops import uncertainty as jax_unc
from rcu_tpu_torch import directories as port_dirs
from rcu_tpu_torch.cli import eval_uncertainty as port_eval_cli
from rcu_tpu_torch.eval import actions, analysis, evaldata
from rcu_tpu_torch.ops import uncertainty as unc
from rcu_tpu_torch.ops.cuda import evalstats
from rcu_tpu_torch.parallel import make_mesh
from tests.test_torch_direct import _cell_equal
from tests.test_torch_test_loop import UNET, seeded_model, write_config

SUBJECTS = [f"Brats18_X_{i:02d}_1" for i in range(4)]
TEST = SUBJECTS[2:]
SHAPE = (3, 16, 20)
HEAD = 8.0  # the class heads' scale: probabilities over many bins
ACTIONS = ["minmax", "ece_dice", "calib", "bnf_ue"]  # minmax first: its own call
# strategy id -> (directories slot, test runner, others)
RUNS = {"baseline": ("BASELINE", "test_default", {}),
        "baseline_mc": ("BASELINE_MC", "test_default", {"mc": 2}),
        "ensemble": ("ENSEMBLE", "test_ensemble", None),
        "aleatoric": ("ALEATORIC", "test_aleatoric", {"is_log_sigma": False}),
        "auxiliary_feat": ("AUX_FEAT", "test_auxiliary_feat", None),
        "auxiliary_segm": ("AUX_SEGM", "test_auxiliary_segm", {})}


def gt_tree(root, rng):
    """The BraTS layout ``<root>/HGG/<subject>/<subject>_<entry>.nii.gz``:
    a lesion of each subject's own size, the four images, t2 with zero
    background support. -> {subject: (images (Z, H, W, 4), labels, t2
    path)}."""
    out = {}
    for i, s in enumerate(SUBJECTS):
        d = os.path.join(root, "HGG", s)
        os.makedirs(d)
        seg = np.zeros(SHAPE, np.uint8)
        seg[:, 4:10 + i, 5:11 + i] = 4
        images = []
        for entry in ("flair", "t1", "t1ce", "t2"):
            img = rng.rand(*SHAPE).astype(np.float32) + 0.2
            if entry == "flair":
                img += 2.0 * (seg > 0)
            if entry == "t2":
                img[img < 0.45] = 0.0
            nifti.write(img, os.path.join(d, f"{s}_{entry}.nii.gz"))
            images.append(img)
        nifti.write(seg, os.path.join(d, f"{s}_seg.nii.gz"))
        out[s] = (np.stack(images, -1), (seg > 0).astype(np.uint8),
                  os.path.join(d, f"{s}_t2.nii.gz"))
    return out


def write_store(path, volumes, baselines=None):
    """An H5 store of the tree's volumes; with ``baselines`` ({subject:
    prediction}) the labels carry [gt, baseline]."""
    with h5.DatasetWriter(path) as w:
        for s, (images, labels, t2) in volumes.items():
            if baselines is not None:
                labels = np.stack([labels, baselines[s]], -1)
            w.add_subject(s, {"images": images, "labels": labels},
                          props=ImageProperties(size=SHAPE[::-1]),
                          files={"images": {"t2": t2}})
    return path


def read_tree(root):
    """{relative path: CSV rows} of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path) as f:
                out[os.path.relpath(path, root)] = list(csv.reader(f))
    return out


def assert_same_tree(want_root, got_root, n_files):
    want, got = read_tree(want_root), read_tree(got_root)
    assert sorted(got) == sorted(want) and len(want) == n_files
    for name, rows in want.items():
        assert got[name][0] == rows[0], name
        assert len(got[name]) == len(rows) > 1, name
        for want_row, got_row in zip(rows[1:], got[name][1:]):
            for col, a, b in zip(rows[0], got_row, want_row):
                assert _cell_equal(a, b), (name, col, a, b)
    return want


def jax_runs(tmp, configs, pred_root, dataset_key):
    """The JAX package's staged test of each run into ``pred_root``;
    -> {strategy id: run dir basename}."""
    names = {}
    for run_id, config_file in configs.items():
        config = jax_cfg.load(config_file, "test-config")
        config.test_dir = pred_root
        loop = getattr(jax_strategies, RUNS[run_id][1])(
            config, **({"symlink_inputs": True} if dataset_key == "ISIC" else {}))
        names[run_id] = os.path.basename(loop.run_dir)
    return names


def point_dirs(monkeypatch, module, dataset_key, pred_root, run_names,
               eval_dir, **extra):
    """The package's ``directories``: the prediction dir and run slots,
    the eval dir and ``extra`` locations, for this test only."""
    monkeypatch.setattr(module, f"{dataset_key}_PREDICT_DIR", pred_root)
    monkeypatch.setattr(module, f"{dataset_key}_EVAL_DIR", eval_dir)
    for run_id, name in run_names.items():
        monkeypatch.setattr(module, f"{dataset_key}_{RUNS[run_id][0]}_PREDICT",
                            name)
    for key, value in extra.items():
        monkeypatch.setattr(module, key, value)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The ground-truth tree, the split, and the JAX staged test runs of
    the six protocols (auxiliary_segm on the JAX baseline run's
    predictions)."""
    tmp = tmp_path_factory.mktemp("torch_eval_engine")
    volumes = gt_tree(str(tmp / "Training"), np.random.RandomState(7))
    store = write_store(str(tmp / "test.h5"), volumes)
    splits = tmp / "splits"
    splits.mkdir()
    split = str(splits / "split_brats18_100-25-160.json")
    save_split(split, SUBJECTS[:1], SUBJECTS[1:2], TEST)
    pred_root = str(tmp / "pred")
    members = [seeded_model(tmp / f"m{k}", "unet", UNET, 70 + k,
                            head_scale=HEAD) for k in range(2)]
    segmenter = seeded_model(tmp / "segm", "unet", UNET, 72, head_scale=HEAD)
    config = lambda run_id, model_dir, others=None, dataset=store: \
        write_config(tmp / f"{run_id}.yaml", run_id, dataset, split,
                     model_dir, others)  # noqa: E731
    configs = {
        "baseline": config("baseline", members[0]),
        "baseline_mc": config("baseline_mc", members[0], {"mc": 2}),
        "ensemble": config("ensemble", members[0],
                           {"model_dir": members[1:], "test_at": "best"}),
        "aleatoric": config("aleatoric", seeded_model(
            tmp / "sigma", "unet", {**UNET, "sigma_out": True}, 73,
            head_scale=HEAD),
            {"is_log_sigma": False}),
        "auxiliary_feat": config("auxiliary_feat", seeded_model(
            tmp / "post", "postnet",
            {"nb_classes": 2, "in_channels": UNET["start_filters"]}, 74,
            head_scale=HEAD),
            {"model_dir": segmenter, "test_at": "best"}),
    }
    names = jax_runs(tmp, configs, pred_root, "BRATS")
    baselines = {s: nifti.read(os.path.join(
        pred_root, names["baseline"], f"{s}_prediction.nii.gz"))[0]
        for s in TEST}
    wpred = write_store(str(tmp / "wpred.h5"),
                        {s: volumes[s] for s in TEST}, baselines)
    names.update(jax_runs(tmp, {"auxiliary_segm": config(
        "auxiliary_segm", seeded_model(tmp / "err", "unet",
                                       {**UNET, "in_channels": 5}, 75,
                                       head_scale=HEAD),
        dataset=wpred)}, pred_root, "BRATS"))
    return tmp, pred_root, names, str(tmp / "Training"), str(splits)


def test_brats_csvs_match_jax(tree, tmp_path, monkeypatch):
    tmp, pred_root, names, gt_dir, splits = tree
    ids = list(RUNS)
    for module, out in ((jax_dirs, "jax"), (port_dirs, "port")):
        point_dirs(monkeypatch, module, "BRATS", pred_root, names,
                   str(tmp_path / out), BRATS_ORIG_DATA_DIR=gt_dir,
                   SPLITS_DIR=splits)
    # the global sigma rescale reads the minmax CSV: minmax runs first
    for acts in (ACTIONS[:1], ACTIONS[1:]):
        jax_eval_cli.main("brats", ids, acts)
    port_eval_cli.main("brats", ids, ACTIONS[:1], device="cpu")
    plain = evalstats.fused_eval_stats.plain_calls
    timings = port_eval_cli.main("brats", ids, ACTIONS[1:], device="cpu")
    # ece_dice, calib and bnf_ue: one kernel pass a subject each
    assert evalstats.fused_eval_stats.plain_calls == \
        plain + 3 * len(TEST) * len(ids)
    assert sorted(timings) == sorted(ids)
    assert all(t["subjects"] == len(TEST) for t in timings.values())
    csvs = assert_same_tree(tmp_path / "jax", tmp_path / "port", 14 * len(ids))
    assert "ece_foreground/eval_ece_aleatoric_globalrescale.csv" in csvs
    assert "calibration/eval_calibration_auxiliary_feat_rescale.csv" in csvs
    assert csvs["minmax/eval_summary_minmax_aleatoric.csv"][1][0] == "sigma"
    bins = csvs["calibration/eval_calibration_baseline.csv"]
    assert sum(int(c) > 0 for c in bins[1][2:12]) >= 3  # the planes spread


def test_thresholds_that_collide_raise(tmp_path):
    for module in (actions, jax_actions):
        with pytest.raises(ValueError, match="collide"):
            module.correction_pass((0.125, 0.12), str(tmp_path),
                                   **({"device": "cpu"} if module is actions
                                      else {}))
    assert actions.threshold_codes((0.05, 0.5)) == ["005", "050"]


def test_passes_run_on_the_card_by_default(tree, tmp_path, monkeypatch):
    """No device asked for: the passes run on the card, and raise where
    there is none; ``--devices 2`` is a mesh of two cards, and raises
    where there are fewer. On the virtual CPU mesh (``--devices 2
    --device cpu``) the four passes write the one-device CSVs, with one
    kernel launch per device, pass and subject."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            actions.get_actions(ACTIONS, str(tmp_path / "minmax"),
                                str(tmp_path), "foreground")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="cuda device"):
            port_eval_cli.main("brats", ["baseline"], ACTIONS, n_devices=2)
    mesh = make_mesh(n_devices=2, device="cpu")
    passes = actions.get_actions(ACTIONS, str(tmp_path / "minmax"),
                                 str(tmp_path), "foreground", mesh=mesh)
    assert all(p.device == torch.device("cpu") and p.kern.mesh is mesh
               for p in passes)
    tmp, pred_root, names, gt_dir, splits = tree
    ids = list(RUNS)
    for out, n_devices in (("one", None), ("mesh", 2)):
        point_dirs(monkeypatch, port_dirs, "BRATS", pred_root, names,
                   str(tmp_path / out), BRATS_ORIG_DATA_DIR=gt_dir,
                   SPLITS_DIR=splits)
        port_eval_cli.main("brats", ids, ACTIONS[:1], n_devices=n_devices,
                           device="cpu")
        plain = evalstats.fused_eval_stats.plain_calls
        port_eval_cli.main("brats", ids, ACTIONS[1:], n_devices=n_devices,
                           device="cpu")
        assert evalstats.fused_eval_stats.plain_calls - plain == \
            3 * len(TEST) * len(ids) * (n_devices or 1)
    assert_same_tree(tmp_path / "one", tmp_path / "mesh", 14 * len(ids))


def test_a_reused_pass_starts_each_run_afresh(tree, tmp_path):
    """The minmax summary of a pass reused across runs holds only its own
    run's subjects."""
    tmp, pred_root, names, gt_dir, splits = tree
    split = os.path.join(splits, "split_brats18_100-25-160.json")
    runs = [evaldata.get_brats_data(evaldata.EvalData(
        run_id, os.path.join(pred_root, names[run_id]), entry),
        in_dir=gt_dir, split_file=split)
        for run_id, entry in (("baseline", "probabilities"),
                              ("aleatoric", "sigma"))]

    def run(minmax, entry):
        minmax.setup_eval(entry)
        minmax.start_eval()
        for sf in entry.subject_files:
            minmax.eval_subject(sf, analysis.Loader())
        minmax.finish_eval()
        with open(os.path.join(minmax.sinks[0].file_path)) as f:
            return list(csv.reader(f))

    reused = actions.minmax_pass(str(tmp_path / "a"), device="cpu")
    run(reused, runs[0])
    again = run(reused, runs[1])
    fresh = run(actions.minmax_pass(str(tmp_path / "b"), device="cpu"), runs[1])
    assert again == fresh and again[1][0] == "sigma"


ERROR_CASES = {
    "random": None,
    "no errors, none uncertain": (np.ones(6, np.uint8), np.ones(6, np.uint8),
                                  np.zeros(6, np.float32)),
    "no errors": (np.ones(6, np.uint8), np.ones(6, np.uint8),
                  np.full(6, 0.9, np.float32)),
    "all uncertain": (np.array([1, 0, 1, 0, 1, 1], np.uint8),
                      np.array([1, 1, 0, 0, 1, 0], np.uint8),
                      np.ones(6, np.float32)),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_metrics_map_0_over_0_to_1(case):
    if ERROR_CASES[case] is None:
        rng = np.random.RandomState(5)
        prediction = (rng.rand(400) < 0.4).astype(np.uint8)
        target = (rng.rand(400) < 0.4).astype(np.uint8)
        uncertainty = rng.rand(400).astype(np.float32)
    else:
        prediction, target, uncertainty = ERROR_CASES[case]
    thresholds = (0.05, 0.5, 0.95)
    want = jax_unc.uncertainty_error_metrics(prediction, target, uncertainty,
                                             thresholds)
    got = unc.uncertainty_error_metrics(torch.from_numpy(prediction),
                                        torch.from_numpy(target),
                                        torch.from_numpy(uncertainty),
                                        thresholds)
    for key in ("precision", "recall", "dice"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-6, err_msg=key)
    counts = (3.0, 2.0, 0.0, 0.0, 0.0, 0.0)  # fp fn tpu tnu fpu fnu, 0 num
    assert float(unc.error_dice(0, 0, 0, 0, 0, 0)) == 1.0
    assert float(unc.error_recall(0, 0, 0, 0)) == 1.0
    assert float(unc.error_precision(0, 0, 0, 0)) == 1.0
    assert float(unc.error_dice(*counts)) == float(jax_unc.error_dice(*counts)) == 0.0
