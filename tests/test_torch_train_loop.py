"""The port's TrainLoop against the JAX package's on one H5 store: two
epochs from the same initial weights (dropout 0) give the same run-dir
layout and validation metrics; a run resumed by its id continues as an
uninterrupted one; the train CLIs resolve the JAX CLIs' config ids.

The two-epoch comparison trains with sgd (lr 0.5, which learns the blob
within the two epochs). With adam, float32 rounding noise in gradients
that are zero or near zero in exact arithmetic (the conv biases before a
BatchNorm among them) becomes steps of up to lr in either package, and
two float32 runs part by ~1e-2 within two epochs; adam's trajectory is
held in float64 and on identical gradients (tests/test_torch_train_step.py),
and the resume test here runs adam."""
import csv
import importlib
import os
import re

import jax
import numpy as np
import pytest
import torch
import yaml

from rcu_tpu.data import h5 as jax_h5
from rcu_tpu.data.nifti import ImageProperties
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.engine.state import init_variables
from rcu_tpu.engine.train import TrainLoop as JaxTrainLoop
from rcu_tpu.models import get_model as jax_get_model
from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.engine.train import TrainLoop
from rcu_tpu_torch.models.convert import state_dict_from_flax

HW = (16, 16)
UNET = {"depth": 2, "dropout": 0.0, "in_channels": 2, "nb_classes": 2,
        "start_filters": 8}
ID = re.compile(r"\d{6}-\d{6}")
# the run dir of a 2-epoch run with validation every epoch, best at epoch 1
LAYOUT = ["ID_toy/config.yaml", "ID_toy/log.txt",
          "ID_toy/model_ID/checkpoints/checkpoint_ep000.ckpt",
          "ID_toy/model_ID/checkpoints/checkpoint_ep001-best.ckpt",
          "ID_toy/model_ID/checkpoints/checkpoint_ep001.ckpt",
          "ID_toy/model_ID/model.json", "ID_toy/tb/events",
          "ID_toy/validation_metrics.csv"]


def make_store(path, nb_subjects=4, nb_slices=6, channels=2, seed=9,
               with_baseline=False):
    """A blob in channel 0 over noise; the first slice of each subject
    black. ``with_baseline``: labels [gt, a shifted blob]."""
    rng = np.random.RandomState(seed)
    with jax_h5.DatasetWriter(path) as w:
        for i in range(nb_subjects):
            labels = np.zeros((nb_slices, *HW), np.uint8)
            labels[1:, 4:11, 5:12] = 1
            images = rng.rand(nb_slices, *HW, channels).astype(np.float32) * 0.1
            images[..., 0] += labels
            images[0] = 0.0
            if with_baseline:
                baseline = np.roll(labels, 2, axis=2)
                labels = np.stack([labels, baseline], -1)
            w.add_subject(f"s{i:02d}", {"images": images, "labels": labels},
                          props=ImageProperties(size=(HW[1], HW[0],
                                                      nb_slices)))
    return path


def write_train_config(tmp_path, store, split, name="toy", epochs=2,
                       model=None, others=None, train_name=None,
                       batch_size=4, optimizer=None):
    data = {"batch_size": batch_size, "dataset": store,
            "indexing": {"slice": {}}, "num_workers": 0}
    d = {"config": {
        "train_name": train_name or name, "train_dir": str(tmp_path / "out"),
        "split": split, "epochs": epochs, "model": model or {"unet": UNET},
        "optimizer": optimizer or {"sgd": {"lr": 0.5}}, "seed": 20,
        "valid_every_nth": 1, "log_every_nth": 2, "others": others or {},
        "train_data": {**data, "selection_strategy": {"none-black": {}},
                       "shuffle": True},
        "valid_data": {**data, "batch_size": 5, "shuffle": False}},
        "meta": {"type": "train-config", "version": 0}}
    path = str(tmp_path / f"{name}_{epochs}_{train_name or ''}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path


def layout(train_dir):
    out = []
    for root, _, files in os.walk(train_dir):
        for name in files:
            rel = os.path.relpath(os.path.join(root, name), train_dir)
            rel = "ID_toy/tb/events" if "tfevents" in rel else rel
            out.append(ID.sub("ID", rel))
    return sorted(out)


def read_csv(path):
    with open(path) as f:
        return list(csv.reader(f))


def assert_rows_close(got, want, rtol):
    assert got[0] == want[0]
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(np.float64(g[2:]), np.float64(w[2:]),
                                   rtol=rtol)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("train_loop")
    store = make_store(str(tmp_path / "ds.h5"))
    split = str(tmp_path / "split.json")
    save_split(split, ["s00", "s01"], ["s02", "s03"], [])
    return tmp_path, store, split


class CarriedLoop(TrainLoop):
    """The port's loop started from JAX's initial weights."""

    def init_state(self):
        super().init_state()
        params, stats = init_variables(jax_get_model("unet", UNET),
                                       (1, *HW, 2),
                                       jax.random.PRNGKey(self.config.seed))
        self.state.model.load_state_dict(state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, params),
            jax.tree_util.tree_map(np.asarray, stats)))


def test_two_epochs_match_jax(env):
    tmp_path, store, split = env
    os.makedirs(tmp_path / "jax")
    path = write_train_config(tmp_path / "jax", store, split)
    jax_loop = JaxTrainLoop(jax_cfg.load(path, "train-config")).run()
    os.makedirs(tmp_path / "port")
    port_path = write_train_config(tmp_path / "port", store, split)
    port_loop = CarriedLoop(port_cfg.load(port_path, "train-config"),
                            device="cpu").run()
    assert layout(tmp_path / "jax" / "out") == \
        layout(tmp_path / "port" / "out") == LAYOUT
    want = read_csv(os.path.join(jax_loop.run_dir, "validation_metrics.csv"))
    got = read_csv(os.path.join(port_loop.run_dir, "validation_metrics.csv"))
    assert want[0] == ["epoch", "subject", "ce", "dice"] and len(want) == 5
    assert float(want[-1][-1]) > 0.5  # learnt: epoch 1 is the best
    assert_rows_close(got, want, 1e-3)
    np.testing.assert_allclose(port_loop.best_score, jax_loop.best_score,
                               rtol=1e-3)
    with open(os.path.join(port_loop.run_dir, "config.yaml")) as f:
        saved = yaml.safe_load(f)
    assert saved["meta"] == {"type": "train-config", "version": 0}
    assert port_cfg.load(os.path.join(port_loop.run_dir, "config.yaml"),
                         "train-config").to_dict() == \
        port_cfg.load(port_path).to_dict()


def test_resume_by_id_continues_the_run(env):
    tmp_path, store, split = env
    base = tmp_path / "resume"
    os.makedirs(base)
    adam = {"adam": {"lr": 0.01}}
    straight = TrainLoop(port_cfg.load(write_train_config(
        base, store, split, name="straight", optimizer=adam)),
        device="cpu").run()
    first = TrainLoop(port_cfg.load(write_train_config(
        base, store, split, name="part", epochs=1, optimizer=adam)),
        device="cpu").run()
    resumed = TrainLoop(port_cfg.load(write_train_config(
        base, store, split, name="part", epochs=2, optimizer=adam,
        train_name=os.path.basename(first.run_dir))), device="cpu")
    assert resumed.resume and resumed.run_dir == first.run_dir
    resumed.run()
    assert resumed.resume_epoch == 0
    want = read_csv(os.path.join(straight.run_dir, "validation_metrics.csv"))
    got = read_csv(os.path.join(first.run_dir, "validation_metrics.csv"))
    assert got == want  # same seeds per (epoch, step): the same numbers
    assert sorted(os.listdir(resumed.model_files.weight_checkpoint_dir)) == \
        sorted(os.listdir(straight.model_files.weight_checkpoint_dir))


@pytest.mark.parametrize("dataset", ["brats", "isic"])
@pytest.mark.parametrize("strategy", ["default", "aleatoric",
                                      "auxiliary_feat", "auxiliary_segm"])
def test_cli_config_ids_are_the_jax_clis(dataset, strategy, monkeypatch):
    name = f"{dataset}_train_{strategy}"
    port = importlib.import_module(f"rcu_tpu_torch.cli.{name}")
    jax_module = importlib.import_module(f"bin.{name}")
    assert port.DEFAULT_CONFIGS == jax_module.DEFAULT_CONFIGS
    for cid, rel in port.DEFAULT_CONFIGS.items():
        assert os.path.exists(os.path.join(dirs.CONFIG_DIR, rel)), rel
    seen = {}

    def fake(config, **kwargs):
        seen.update(config=config, **kwargs)
        return "ran"

    from rcu_tpu_torch import strategies
    monkeypatch.setattr(strategies, f"train_{strategy}", fake)
    cid = next(iter(port.DEFAULT_CONFIGS))
    assert port.main(None, cid, device="cpu") == "ran"
    assert seen["device"] == "cpu"
    assert isinstance(seen["config"], port_cfg.TrainConfiguration)
    if dataset == "isic" and strategy in ("default", "aleatoric"):
        assert seen["eval_subject_fn"].__name__ in (
            "isic_eval_subject_fn", "isic_smooth_dice_eval_subject_fn")
    # -devices N trains on a mesh of N devices of -device's kind, and
    # refuses one the machine cannot give
    assert port.main(None, cid, device="cpu", devices=2) == "ran"
    assert seen["mesh"].devices == (torch.device("cpu"),) * 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="2-device mesh but only 0 cuda"):
        port.main(None, cid, devices=2)
    with pytest.raises(ValueError, match="unknown config id"):
        port.main(None, "nope")
