"""The port's direct eval as a whole against ``rcu_tpu.eval.direct``: the
same H5 store (with raw-t2 NIfTIs for the foreground mask), split, yaml
config and flax checkpoint written by the JAX checkpoint service.

``mc=0`` must write the same CSVs: integer and boolean cells exactly,
floats at rtol 1e-4. The MC masks cannot equal flax's, so ``mc=3`` is held
to the same schema and file set, and to byte-identical reruns.
"""
import csv
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from rcu_tpu.data import h5, nifti
from rcu_tpu.data.nifti import ImageProperties
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu_torch.cli import eval_direct as port_cli
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_unet import flax_unet

SHAPE = (3, 16, 20)  # 3 slices at batch 2: a ragged last batch
PARAMS = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
              dropout=0.2)
EDGES = np.arange(1, 10) / 10.0  # the bin edges fg can fall near (0.5 too)
MARGIN = 1e-4


def make_store(tmp_path):
    rng = np.random.RandomState(3)
    path = str(tmp_path / "ds.h5")
    with h5.DatasetWriter(path) as w:
        for i in range(4):
            name = f"s{i:02d}"
            gt = np.zeros(SHAPE, np.uint8)
            gt[:, 4:12, 5:13] = 1
            images = rng.rand(*SHAPE, 4).astype(np.float32) * 0.5
            images[..., 0] += gt
            t2 = rng.rand(*SHAPE).astype(np.float32)
            t2[t2 < 0.3] = 0.0  # zero background support
            t2_path = str(tmp_path / f"{name}_t2.nii.gz")
            nifti.write(t2, t2_path)
            w.add_subject(name, {"images": images, "labels": gt},
                          props=ImageProperties(size=SHAPE[::-1]),
                          files={"images": {"t2": t2_path}})
    return path


def _margin_weights(store):
    """Random flax weights whose class conv is scaled so that no test
    voxel's deterministic fg lies within MARGIN of 0.5 or a bin edge:
    there a 1-ulp difference between the frameworks would flip a count."""
    reader = h5.SubjectDataset(store)
    volumes = np.concatenate([reader.read_volume(s, "images")
                              for s in ("s02", "s03")])
    reader.close()
    for seed in range(5):
        fm, params, stats = flax_unet(PARAMS, SHAPE[1:], seed=seed)
        for scale in (3.0, 5.0, 8.0, 12.0):
            scaled = dict(params)
            scaled["Conv_2"] = {k: scale * v for k, v in params["Conv_2"].items()}
            logits = fm.apply({"params": scaled, "batch_stats": stats},
                              volumes).logits
            fg = np.asarray(jax.nn.softmax(logits, -1))[..., 1]
            gap = np.abs(fg[..., None] - EDGES).min()
            if gap > MARGIN and 0.05 < (fg > 0.5).mean() < 0.95:
                return scaled, stats, gap
    raise AssertionError("no weights with the fg margin")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("torch_direct")
    store = make_store(tmp_path)
    split_file = str(tmp_path / "split.json")
    save_split(split_file, ["s00"], ["s01"], ["s02", "s03"])
    model_dir = str(tmp_path / "model_x")
    mf = jax_ckpt.ModelFiles.from_model_dir(model_dir)
    jax_ckpt.backup_model_parameters(mf, jax_cfg.ParametricNode("unet", PARAMS),
                                     None)
    params, stats, gap = _margin_weights(store)
    assert gap > MARGIN
    jax_ckpt.save_checkpoint(mf, {"params": params, "batch_stats": stats,
                                  "epoch": 1, "best_score": 0.5},
                             epoch=1, best=True)
    config_file = str(tmp_path / "test.yaml")
    with open(config_file, "w") as f:
        yaml.safe_dump({"config": {
            "test_name": "direct_port", "model_dir": model_dir,
            "split": split_file, "seed": 20, "test_at": "best",
            "others": {"mc": 3},
            "test_data": {"batch_size": 2, "dataset": store,
                          "indexing": {"slice": {}}, "shuffle": False}},
            "meta": {"type": "test-config", "version": 0}}, f)
    return tmp_path, config_file


def read_dir(out_dir):
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name)) as fp:
            out[name] = list(csv.reader(fp))
    return out


def _cell_equal(a, b):
    if a == b:
        return True
    try:
        int(a), int(b)
        return False  # integers match exactly or not at all
    except ValueError:
        pass
    if {a, b} <= {"True", "False"}:
        return False
    fa, fb = float(a), float(b)
    return (np.isnan(fa) and np.isnan(fb)) or \
        abs(fa - fb) <= 1e-4 * abs(fb) + 1e-12


def run_jax(env, out_dir, mc):
    _, config_file = env
    return jax_evaluate_direct(jax_cfg.load(config_file, "test-config"),
                               out_dir, run_id="direct_port", mc=mc)


def run_port(env, out_dir, mc):
    _, config_file = env
    return port_direct.evaluate_direct(port_cfg.load(config_file), out_dir,
                                       run_id="direct_port", mc=mc,
                                       device="cpu")


def test_deterministic_csvs_match_jax(env, tmp_path):
    jax_eces = run_jax(env, str(tmp_path / "jax"), mc=0)
    port_eces = run_port(env, str(tmp_path / "port"), mc=0)
    assert jax_eces.keys() == port_eces.keys() == {"s02", "s03"}
    want, got = read_dir(tmp_path / "jax"), read_dir(tmp_path / "port")
    assert got.keys() == want.keys()
    assert len(want) == 14  # calibration, ece, minmax + 11 thresholds
    for name, rows in want.items():
        assert len(got[name]) == len(rows), name
        assert got[name][0] == rows[0], name  # header
        for want_row, got_row in zip(rows[1:], got[name][1:]):
            for col, a, b in zip(rows[0], got_row, want_row):
                assert _cell_equal(a, b), (name, col, a, b)


def test_mc_schema_and_reruns(env, tmp_path):
    run_jax(env, str(tmp_path / "jax"), mc=3)
    plain = evalstats.fused_eval_stats.plain_calls
    run_port(env, str(tmp_path / "a"), mc=3)
    assert evalstats.fused_eval_stats.plain_calls == plain + 2  # one per subject
    run_port(env, str(tmp_path / "b"), mc=3)
    want, got = read_dir(tmp_path / "jax"), read_dir(tmp_path / "a")
    assert got.keys() == want.keys()
    for name, rows in want.items():
        assert got[name][0] == rows[0], name
        keys = 1 if "minmax" in name else 2  # (test_id, subject) / entry
        assert [r[:keys] for r in got[name]] == [r[:keys] for r in rows], name
    for name in got:
        with open(tmp_path / "a" / name, "rb") as fa, \
                open(tmp_path / "b" / name, "rb") as fb:
            assert fa.read() == fb.read(), name
    mc0 = tmp_path / "mc0"
    run_port(env, str(mc0), mc=0)
    assert read_dir(mc0) != got  # the samples did move the result


def test_cli_writes_the_csv_families(env, tmp_path):
    _, config_file = env
    out_dir = str(tmp_path / "cli")
    port_cli.main(config_file, run_id="cli", out_dir=out_dir, mc=2,
                  device="cpu")
    names = os.listdir(out_dir)
    assert "eval_calibration_cli.csv" in names
    assert "eval_summary_minmax_cli.csv" in names
    assert sum(n.startswith("eval_uncertainty_cli_th") for n in names) == 11


def test_cuda_is_the_default_device(env, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    _, config_file = env
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_direct.evaluate_direct(port_cfg.load(config_file),
                                    str(tmp_path / "x"), mc=0)


def test_empty_mask_writes_rows_then_raises(env, tmp_path):
    """An all-zero raw t2 leaves no voxel to bin: NaN ECE rows, then a
    ValueError once every CSV is written (the JAX driver's contract)."""
    from rcu_tpu_torch.models import get_model

    class OneSubject:
        subjects = ["z"]

        def __init__(self):
            self.t2 = str(tmp_path / "z_t2.nii.gz")
            nifti.write(np.zeros(SHAPE, np.float32), self.t2)

        def read_volume(self, subject, category):
            if category == "images":
                return np.ones(SHAPE + (4,), np.float32)
            return np.zeros(SHAPE, np.uint8)

        def shape(self, subject, category):
            return self.read_volume(subject, category).shape

        def files(self, subject):
            return {"images": {"t2": self.t2}}

    out_dir = str(tmp_path / "empty")
    model = get_model("unet", PARAMS)
    with pytest.raises(ValueError, match="non-finite ECE"):
        port_direct.evaluate_subjects(model, OneSubject(), out_dir, mc=0,
                                      batch_size=2, device="cpu")
    rows = read_dir(out_dir)["eval_ece_baseline.csv"]
    assert rows[1][1] == "z" and rows[1][2] == "nan"
