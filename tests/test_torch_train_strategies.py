"""The four train entry functions of ``rcu_tpu_torch.strategies`` on the
CPU, on a BraTS-like H5 store and an ISIC image folder: each writes the
JAX package's run-dir layout and validation CSV; the validation metrics
equal the JAX package's on the same subject; a port-trained checkpoint
reads in both packages' deterministic direct evals with equal CSV rows."""
import csv
import os

import numpy as np
import pytest
import yaml

from rcu_tpu import strategies as jax_strategies
from rcu_tpu.data import h5 as jax_h5
from rcu_tpu.data.nifti import ImageProperties
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.engine import train as jax_train
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu_torch import strategies
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.engine import train
from rcu_tpu_torch.eval import direct as port_direct
from tests.test_torch_direct import _cell_equal, make_store, read_dir
from tests.test_torch_direct_2d import RESCALE, make_tree, raw_images
from tests.test_torch_train_loop import ID

SHAPE = (6, 16, 20)
UNET = {"depth": 2, "dropout": 0.1, "in_channels": 4, "nb_classes": 2,
        "start_filters": 8}


def write_config(tmp_path, name, store, split, model, others=None,
                 indexing=True, transform=None, epochs=1):
    data = {"batch_size": 4, "dataset": store, "num_workers": 0}
    if indexing:
        data["indexing"] = {"slice": {}}
    if transform:
        data["transform"] = transform
    path = str(tmp_path / f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"config": {
            "train_name": name, "train_dir": str(tmp_path / "out"),
            "split": split, "epochs": epochs, "model": model,
            "optimizer": {"sgd": {"lr": 0.5}}, "seed": 20,
            "valid_every_nth": 1, "log_every_nth": 1, "others": others or {},
            "train_data": {**data, "shuffle": True},
            "valid_data": {**data, "batch_size": 5, "shuffle": False}},
            "meta": {"type": "train-config", "version": 0}}, f)
    return port_cfg.load(path, "train-config")


def run_layout(loop):
    out = []
    for root, _, files in os.walk(loop.run_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), loop.run_dir)
            out.append("tb/events" if "tfevents" in rel else ID.sub("ID", rel))
    return sorted(out)


def epoch_layout(epochs, best):
    ckpts = [f"model_ID/checkpoints/checkpoint_ep{e:03d}.ckpt"
             for e in range(max(0, epochs - 3), epochs)]
    ckpts.append(f"model_ID/checkpoints/checkpoint_ep{best:03d}-best.ckpt")
    return sorted(["config.yaml", "log.txt", "model_ID/model.json",
                   "tb/events", "validation_metrics.csv"] + ckpts)


def best_epoch(loop):
    """The epoch whose mean validation dice (the score) first peaks."""
    with open(os.path.join(loop.run_dir, "validation_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    epochs = sorted({int(r["epoch"]) for r in rows})
    means = [np.mean([float(r["dice"]) for r in rows
                      if int(r["epoch"]) == e]) for e in epochs]
    return epochs[int(np.argmax(means))]


def csv_header(loop):
    with open(os.path.join(loop.run_dir, "validation_metrics.csv")) as f:
        return next(csv.reader(f))


def with_baseline_labels(store):
    """A copy of ``store`` whose labels carry [gt, baseline]: the gt
    shifted by two columns."""
    src = jax_h5.SubjectDataset(store)
    path = store.replace(".h5", "_wpred.h5")
    with jax_h5.DatasetWriter(path) as w:
        for s in src.subjects:
            gt = src.read_volume(s, "labels")
            w.add_subject(s, {"images": src.read_volume(s, "images"),
                              "labels": np.stack([gt, np.roll(gt, 2, 2)], -1)},
                          props=ImageProperties(size=SHAPE[::-1]),
                          files=src.files(s))
    src.close()
    return path


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("train_strategies")
    store = make_store(tmp_path, SHAPE)
    split = str(tmp_path / "split.json")
    save_split(split, ["s00", "s01"], ["s02"], ["s02", "s03"])
    default = strategies.train_default(
        write_config(tmp_path, "default", store, split, {"unet": UNET},
                     epochs=2), device="cpu")
    return tmp_path, store, split, default


def test_default_run_reads_in_both_direct_evals(env):
    """The port-trained checkpoint through the JAX package's and the
    port's deterministic direct evals: the same CSV rows."""
    tmp_path, store, split, default = env
    assert run_layout(default) == epoch_layout(2, best_epoch(default))
    assert csv_header(default) == ["epoch", "subject", "ce", "dice"]
    config = str(tmp_path / "test.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"config": {
            "test_name": "trained", "model_dir": default.model_files.model_dir,
            "split": split, "seed": 20, "test_at": "best", "others": {},
            "test_data": {"batch_size": 2, "dataset": store,
                          "indexing": {"slice": {}}, "shuffle": False}},
            "meta": {"type": "test-config", "version": 0}}, f)
    jax_evaluate_direct(jax_cfg.load(config, "test-config"),
                        str(tmp_path / "jax_eval"), run_id="trained", mc=0)
    port_direct.evaluate_direct(port_cfg.load(config),
                                str(tmp_path / "port_eval"), run_id="trained",
                                mc=0, device="cpu")
    want, got = read_dir(tmp_path / "jax_eval"), read_dir(tmp_path / "port_eval")
    assert got.keys() == want.keys() and len(want) == 14
    for name, rows in want.items():
        assert got[name][0] == rows[0] and len(got[name]) == len(rows) > 1
        for want_row, got_row in zip(rows[1:], got[name][1:]):
            for col, a, b in zip(rows[0], got_row, want_row):
                assert _cell_equal(a, b), (name, col, a, b)


def test_aleatoric_and_auxiliary_runs(env):
    tmp_path, store, split, default = env
    aleatoric = strategies.train_aleatoric(write_config(
        tmp_path, "aleatoric", store, split,
        {"unet": {**UNET, "sigma_out": True}}, {"is_log_sigma": False}),
        device="cpu")
    feat = strategies.train_auxiliary_feat(write_config(
        tmp_path, "aux_feat", store, split,
        {"postnet": {"in_channels": 8, "nb_classes": 2}},
        {"model_dir": default.model_files.model_dir, "test_at": "best"}),
        device="cpu")
    segm = strategies.train_auxiliary_segm(write_config(
        tmp_path, "aux_segm", with_baseline_labels(store), split,
        {"unet": {**UNET, "in_channels": 5}}), device="cpu")
    for loop, header in ((aleatoric, ["epoch", "subject", "dice"]),
                         (feat, ["epoch", "subject", "ce", "dice"]),
                         (segm, ["epoch", "subject", "ce", "dice"])):
        assert run_layout(loop) == epoch_layout(1, 0)
        assert csv_header(loop) == header
    with pytest.raises(ValueError, match="is_log_sigma"):
        strategies.train_aleatoric(write_config(
            tmp_path, "no_sigma", store, split,
            {"unet": {**UNET, "sigma_out": True}}), device="cpu")
    with pytest.raises(ValueError, match="model_dir"):
        strategies.train_auxiliary_feat(write_config(
            tmp_path, "no_segm", store, split,
            {"postnet": {"in_channels": 8, "nb_classes": 2}},
            {"model_dir": None, "test_at": "best"}), device="cpu")


def test_isic_default_run(tmp_path):
    path, _ = make_tree(tmp_path, raw_images(), task="ISIC-2017_Training")
    loop = strategies.train_default(write_config(
        tmp_path, "isic", path, "", {"unet": {**UNET, "in_channels": 3}},
        indexing=False, transform=RESCALE),
        eval_subject_fn=strategies.isic_eval_subject_fn, device="cpu")
    assert run_layout(loop) == epoch_layout(1, 0)
    with open(os.path.join(loop.run_dir, "validation_metrics.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["epoch", "subject", "dice", "nll"] and len(rows) == 7


def subject_data(seed, labels_shape):
    rng = np.random.RandomState(seed)
    probs = rng.rand(3, 8, 9, 2).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    labels = (rng.rand(*labels_shape) < 0.3).astype(np.uint8)
    return ({"probabilities": probs,
             "net_predictions": (rng.rand(3, 8, 9) < 0.4).astype(np.int64)},
            {"labels": labels})


@pytest.mark.parametrize("name,labels_shape", [
    ("default_eval_subject_fn", (3, 8, 9)),
    ("default_eval_subject_fn", (3, 8, 9, 2)),
    ("isic_eval_subject_fn", (3, 8, 9)),
    ("dice_eval_subject_fn", (3, 8, 9, 1)),
    ("isic_smooth_dice_eval_subject_fn", (3, 8, 9)),
    ("_aux_feat_eval_subject_fn", (3, 8, 9)),
    ("_aux_segm_eval_subject_fn", (3, 8, 9, 2)),
])
def test_validation_metrics_are_jax_s(name, labels_shape):
    data, info = subject_data(len(name), labels_shape)
    owner = (train, jax_train) if name == "default_eval_subject_fn" \
        else (strategies, jax_strategies)
    got, got_score = getattr(owner[0], name)(data, info)
    want, want_score = getattr(owner[1], name)(data, info)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
    np.testing.assert_allclose(got_score, want_score, rtol=1e-6)
