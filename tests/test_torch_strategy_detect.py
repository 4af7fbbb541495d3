"""The port's strategy detection, config errors and degenerate inputs
against ``rcu_tpu.eval.direct``, and the CLI's ``-strategy`` flag.

Detection follows ``rcu_tpu.eval.direct``'s order on the same configs; a missing
entry raises the same ``ValueError``; a constant sigma range raises before
the second aleatoric pass; a constant auxiliary confidence writes NaN rows
and then raises, with the same CSVs as ``rcu_tpu.eval.direct``.
"""
import os

import numpy as np
import pytest

from rcu_tpu.data import h5 as jax_h5
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval import direct as jax_direct
from rcu_tpu_torch.cli import eval_direct as port_cli
from rcu_tpu_torch.data.h5 import SubjectDataset
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_direct import SHAPE, make_store, read_dir
from tests.test_torch_unet import flax_net
from tests.test_torch_strategies import (UNET, assert_same_csvs,
                                         make_wpred_store, write_config,
                                         write_model)

POSTNET = dict(nb_classes=2, in_channels=UNET["start_filters"])


def constant_head(params, key, value):
    """The 1x1 conv ``key`` gives ``value`` for every class at every voxel."""
    head = params[key]
    return {**params, key: {"kernel": np.zeros_like(head["kernel"]),
                            "bias": np.full_like(head["bias"], value)}}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """{name: config file}: one per strategy family, and the degenerate
    and incomplete variants."""
    tmp = tmp_path_factory.mktemp("torch_detect")
    store = make_store(tmp)
    wpred = make_wpred_store(tmp, store)
    split_file = str(tmp / "split.json")
    save_split(split_file, ["s00"], ["s01"], ["s02", "s03"])

    def model(name, model_type, params, seed, edit=None):
        _, p, stats = flax_net(model_type, params, SHAPE[1:], seed=seed)
        return write_model(tmp / name, model_type, params,
                           edit(p) if edit else p, stats)

    def config(name, model_dir, others, dataset=store):
        return write_config(tmp / f"{name}.yaml", name, model_dir, split_file,
                            dataset, others)

    sigma = {**UNET, "sigma_out": True}
    plain = model("plain", "unet", UNET, 1)
    member = model("member", "unet", UNET, 2)
    post = model("post", "postnet", POSTNET, 3)
    flat_post = model("flat_post", "postnet", POSTNET, 3,
                      lambda p: constant_head(p, "Conv_0", 0.2))
    return {
        "mc": config("mc", plain, {"mc": 2}),
        "aleatoric": config("aleatoric", model("sigma", "unet", sigma, 4),
                            {"is_log_sigma": False}),
        "ensemble": config("ensemble", plain,
                           {"model_dir": [member], "test_at": "best"}),
        "auxiliary_feat": config("auxiliary_feat", post,
                                 {"model_dir": plain, "test_at": "best"}),
        "auxiliary_segm": config(
            "auxiliary_segm", model("error", "unet", {**UNET, "in_channels": 5},
                                    5), {}, wpred),
        "flat_sigma": config(
            "flat_sigma", model("flat_sigma", "unet", sigma, 6,
                                lambda p: constant_head(p, "Conv_3", 0.3)),
            {"is_log_sigma": False}),
        "flat_confidence": config("flat_confidence", flat_post,
                                  {"model_dir": plain, "test_at": "best"}),
        "no_log_sigma": config("no_log_sigma",
                               model("sigma2", "unet", sigma, 7), {}),
        "ensemble_no_test_at": config("ensemble_no_test_at", plain,
                                      {"model_dir": [member]}),
        "aux_feat_no_test_at": config("aux_feat_no_test_at", post,
                                      {"model_dir": plain}),
    }


def both_configs(config_file):
    return jax_cfg.load(config_file, "test-config"), port_cfg.load(config_file)


@pytest.mark.parametrize("name", ["mc", "aleatoric", "ensemble",
                                  "auxiliary_feat", "auxiliary_segm"])
def test_detects_the_strategy_as_jax_does(env, name):
    jax_config, port_config = both_configs(env[name])
    jax_ds = jax_h5.SubjectDataset(jax_config.test_data.dataset)
    port_ds = SubjectDataset(port_config.test_data.dataset)
    try:
        assert jax_direct._detect_strategy(jax_config, jax_ds, None) == name
        assert port_direct._detect_strategy(port_config, port_ds, None) == name
        # an explicit strategy wins over what the config says
        for explicit in ("ensemble", "deterministic"):
            assert port_direct._detect_strategy(port_config, port_ds,
                                                explicit) == explicit
        for detect, config, ds in ((jax_direct._detect_strategy, jax_config,
                                    jax_ds),
                                   (port_direct._detect_strategy, port_config,
                                    port_ds)):
            with pytest.raises(ValueError, match="unknown strategy"):
                detect(config, ds, "bayes")
    finally:
        jax_ds.close()
        port_ds.close()


def test_every_strategy_has_a_family_record():
    """Each strategy of the direct eval (the JAX package's six) has one
    record in the pipeline's family table under its own name, and
    ``deterministic`` is ``mc`` without its samples."""
    assert port_direct.STRATEGIES == tuple(jax_direct.STRATEGIES)
    assert set(pipeline.FAMILIES) == set(port_direct.STRATEGIES)
    for name in port_direct.STRATEGIES:
        assert pipeline.FAMILIES[name].name == name
    assert pipeline.FAMILIES["deterministic"]._replace(
        name="mc", samples=True) == pipeline.FAMILIES["mc"]


@pytest.mark.parametrize("name,match", [
    ("no_log_sigma", "is_log_sigma"),
    ("ensemble_no_test_at", "test_at"),
    ("aux_feat_no_test_at", "test_at")])
def test_missing_entries_raise_as_in_jax(env, tmp_path, name, match):
    jax_config, port_config = both_configs(env[name])
    with pytest.raises(ValueError, match=match):
        jax_direct.evaluate_direct(jax_config, str(tmp_path / "jax"))
    with pytest.raises(ValueError, match=match):
        port_direct.evaluate_direct(port_config, str(tmp_path / "port"),
                                    device="cpu")


def csv_files(out_dir):
    return [n for n in os.listdir(out_dir) if n.endswith(".csv")] \
        if os.path.isdir(out_dir) else []


def test_constant_sigma_range_raises_before_pass_b(env, tmp_path):
    jax_config, port_config = both_configs(env["flat_sigma"])
    with pytest.raises(ValueError, match="degenerate sigma range"):
        jax_direct.evaluate_direct(jax_config, str(tmp_path / "jax"))
    plain = evalstats.fused_eval_stats.plain_calls
    with pytest.raises(ValueError, match="degenerate sigma range"):
        port_direct.evaluate_direct(port_config, str(tmp_path / "port"),
                                    device="cpu")
    assert evalstats.fused_eval_stats.plain_calls == plain  # no pass B
    assert csv_files(tmp_path / "jax") == csv_files(tmp_path / "port") == []


def test_constant_confidence_writes_nan_rows_then_raises(env, tmp_path):
    """The subject rescale divides 0/0: NaN rows for every subject, every
    CSV written, then the ValueError, as in ``rcu_tpu.eval.direct``."""
    jax_config, port_config = both_configs(env["flat_confidence"])
    with pytest.raises(ValueError, match="non-finite ECE"):
        jax_direct.evaluate_direct(jax_config, str(tmp_path / "jax"),
                                   run_id="flat")
    plain = evalstats.fused_eval_stats.plain_calls
    with pytest.raises(ValueError, match="non-finite ECE"):
        port_direct.evaluate_direct(port_config, str(tmp_path / "port"),
                                    run_id="flat", device="cpu")
    assert evalstats.fused_eval_stats.plain_calls == plain + 2
    csvs = assert_same_csvs(tmp_path / "jax", tmp_path / "port")
    rows = csvs["eval_ece_flat_rescale.csv"]
    assert [r[2] for r in rows[1:]] == ["nan", "nan"]
    minmax = csvs["eval_summary_minmax_flat.csv"][1]
    assert minmax[0] == "confidence" and minmax[1] == minmax[2]


@pytest.mark.parametrize("strategy", ["ensemble", "deterministic"])
def test_cli_strategy_flag(env, tmp_path, strategy):
    """``-strategy`` names the protocol; the ensemble config otherwise
    runs as an ensemble."""
    out_dir = str(tmp_path / "cli")
    plain = evalstats.fused_eval_stats.plain_calls
    port_cli.main(env["ensemble"], run_id="cli", out_dir=out_dir,
                  device="cpu", strategy=strategy)
    assert evalstats.fused_eval_stats.plain_calls == plain + 2
    got = read_dir(out_dir)
    assert "eval_calibration_cli.csv" in got
    assert sum(n.startswith("eval_uncertainty_cli_th") for n in got) == 11
    if strategy == "deterministic":
        # the primary model alone: its eval differs from the ensemble's
        other = str(tmp_path / "ens")
        port_cli.main(env["ensemble"], run_id="cli", out_dir=other,
                      device="cpu")
        assert read_dir(other) != got


def test_cli_offers_the_six_protocols(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["eval_direct", "-h"])
    with pytest.raises(SystemExit):
        port_cli.cli()
    usage = capsys.readouterr().out
    for strategy in port_direct.STRATEGIES:
        assert strategy in usage
        assert f"``{strategy}``" in port_cli.__doc__
