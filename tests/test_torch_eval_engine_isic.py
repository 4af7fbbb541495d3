"""The ISIC half of ``tests/test_torch_eval_engine.py``: the JAX package's
staged test runs of the six confidence protocols over an ISIC-2017 folder
(through the config's rescale; auxiliary_segm on the JAX baseline run's
predictions) write one NIfTI tree of 2-D artifacts, and the port's
offline engine must write the same CSVs as ``bin/eval_uncertainty.py``
from it, unmasked (``ece/``), integer and boolean cells exact and floats
at rtol 1e-4."""
import os

import pytest

from bin import eval_uncertainty as jax_eval_cli
from rcu_tpu import directories as jax_dirs
from rcu_tpu_torch import directories as port_dirs
from rcu_tpu_torch.cli import eval_uncertainty as port_eval_cli
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_direct_2d import (HW, NAMES, RESCALE, UNET3, make_tree,
                                        raw_images)
from tests.test_torch_eval_engine import (ACTIONS, HEAD, RUNS,
                                          assert_same_tree, jax_runs,
                                          point_dirs)
from tests.test_torch_test_loop import seeded_model, write_config


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_eval_engine_isic")
    path, _ = make_tree(tmp, raw_images())
    pred_root = str(tmp / "pred")

    def model(name, record, seed, model_type="unet"):
        return seeded_model(tmp / name, model_type, record, seed, HW,
                            head_scale=HEAD)

    def config(run_id, model_dir, others=None):
        return write_config(tmp / f"{run_id}.yaml", run_id, path, "",
                            model_dir, others, transform=RESCALE,
                            indexing=False, batch_size=4)

    members = [model(f"m{k}", UNET3, 80 + k) for k in range(2)]
    configs = {
        "baseline": config("baseline", members[0]),
        "baseline_mc": config("baseline_mc", members[0], {"mc": 2}),
        "ensemble": config("ensemble", members[0],
                           {"model_dir": members[1:], "test_at": "best"}),
        "aleatoric": config("aleatoric",
                            model("sigma", {**UNET3, "sigma_out": True}, 82),
                            {"is_log_sigma": True}),
        "auxiliary_feat": config(
            "auxiliary_feat",
            model("post", {"nb_classes": 2,
                           "in_channels": UNET3["start_filters"]}, 83,
                  "postnet"),
            {"model_dir": model("segm", UNET3, 84), "test_at": "best"}),
    }
    names = jax_runs(tmp, configs, pred_root, "ISIC")
    names.update(jax_runs(tmp, {"auxiliary_segm": config(
        "auxiliary_segm", model("err", {**UNET3, "in_channels": 4}, 85),
        {"prediction_dir": os.path.join(pred_root, names["baseline"])})},
        pred_root, "ISIC"))
    return path, pred_root, names


def test_isic_csvs_match_jax(tree, tmp_path, monkeypatch):
    path, pred_root, names = tree
    ids = list(RUNS)
    for module, out in ((jax_dirs, "jax"), (port_dirs, "port")):
        point_dirs(monkeypatch, module, "ISIC", pred_root, names,
                   str(tmp_path / out), ISIC_PREPROCESSED_TEST_DATA_DIR=path)
    for acts in (ACTIONS[:1], ACTIONS[1:]):
        jax_eval_cli.main("isic", ids, acts)
    port_eval_cli.main("isic", ids, ACTIONS[:1], device="cpu")
    plain = evalstats.fused_eval_stats.plain_calls
    port_eval_cli.main("isic", ids, ACTIONS[1:], device="cpu")
    assert evalstats.fused_eval_stats.plain_calls == \
        plain + 3 * len(NAMES) * len(ids)
    csvs = assert_same_tree(tmp_path / "jax", tmp_path / "port", 14 * len(ids))
    assert not os.path.exists(tmp_path / "port" / "ece_foreground")
    assert "ece/eval_ece_auxiliary_segm_rescale.csv" in csvs
    assert len(csvs["ece/eval_ece_baseline.csv"]) == 1 + len(NAMES)
    bins = csvs["calibration/eval_calibration_baseline_mc.csv"]
    assert sum(int(c) > 0 for c in bins[1][2:12]) >= 3
