"""The TransUNet cell's files against the contract, and a tiny TransUNet cell
run whole on the CPU through the harness, added as files beside the tiny
U-Net cells (``tiny.py``): ``correct`` on the sound program, not correct
when the timed path keeps half of the MC samples; the program's counters
of a profiled call equal the protocol's counts; the FLOPs counted from
shapes equal torch's FLOP counter on the program's model; the reference
loads neither JAX nor the program."""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, transunet_flops

from tiny import EVAL_LIMITS, REPO, TH, make_root

CELL = "tiny_brats_transunet_mc"
MODEL = {"in_channels": 4, "nb_classes": 2, "img_size": 32, "hidden": 64,
         "mlp_dim": 128, "heads": 4, "layers": 2, "resnet_units": [1, 1, 1],
         "width": 32, "decoder_channels": [32, 16, 8, 4], "head_channels": 64,
         "n_skip": 3, "dropout": 0.1, "attention_dropout": 0.0}
CONFIG = {"model": {"transunet": MODEL},
          "data": {"kind": "brats_volumes", "shape": [8, 32, 32],
                   "channels": 4, "eval_pool": 2, "masked": True}}
TRAFFIC = {"driver": "direct_eval_transunet", "strategy": "mc", "mc": 3,
           "dtype": "float32", "fast_decoder": False, "batch_size": 4,
           "thresholds": TH, "check_items": 2, "warmup_items": 1,
           "items_per_s": 10}
NEW_METRICS = ("transunet_mfu.eval", "encoder_share.eval")


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def transunet_root(tmp_path):
    """The tiny root plus a tiny TransUNet cell, added as files as the
    repository's cell is."""
    root = make_root(tmp_path)
    _write(os.path.join(root, "benchmark/configs/tiny_transunet.json"),
           CONFIG)
    _write(os.path.join(root, "benchmark/traffic/tiny_transunet_mc.json"),
           TRAFFIC)
    _write(os.path.join(root, f"benchmark/limits/{CELL}.json"), EVAL_LIMITS)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_transunet", "source": "test",
                            "file": "benchmark/configs/tiny_transunet.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tiny_transunet",
                              "traffic": "tiny_transunet_mc", "chips": 1,
                              "why": "test"})
    for entry in spec["end_to_end"] + spec["per_layer"]:
        if entry["name"] in ("eval_voxels_per_s",) + NEW_METRICS:
            entry["workloads"].append(CELL)
    _write(path, spec)
    return root


def _run(root, trace=0, seed=2 ** 31 + 29):
    return harness.run_cell(root, CELL, seed, 0.3, trace,
                            torch.device("cpu"),
                            time.clock_gettime(time.CLOCK_BOOTTIME))


def test_bench_transunet_entries_and_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    (config,) = [c for c in spec["configs"] if c["name"] == "brats_transunet"]
    assert config["reduced"] == []
    with open(os.path.join(REPO, config["file"])) as f:
        model = json.load(f)["model"]["transunet"]
    assert {k: v for k, v in model.items()
            if k not in ("in_channels", "nb_classes", "img_size")} == {
        "hidden": 768, "mlp_dim": 3072, "heads": 12, "layers": 12,
        "resnet_units": [3, 4, 9], "width": 64,
        "decoder_channels": [256, 128, 64, 16], "head_channels": 512,
        "n_skip": 3, "dropout": 0.1, "attention_dropout": 0.0}
    (cell,) = [c for c in spec["workloads"]
               if c["name"] == "brats_transunet_mc20_f32"]
    assert (cell["config"], cell["chips"]) == ("brats_transunet", 1)
    metrics = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW_METRICS:
        assert metrics[name]["workloads"] == ["brats_transunet_mc20_f32"]
        assert metrics[name]["moves"] == "eval_voxels_per_s"


def test_bench_tiny_transunet_cell_is_correct(transunet_root, cpu):
    result = _run(transunet_root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 3
    assert set(result["metrics"]) == {"eval_voxels_per_s", "setup_s"}
    # traced: the card's readers find no device activity on the CPU
    traced = _run(transunet_root, trace=1)
    assert traced["correct"] and not set(traced["metrics"]) & set(NEW_METRICS)


def test_bench_tiny_transunet_half_of_the_samples_is_not_correct(
        transunet_root, cpu, monkeypatch):
    from rcu_tpu_torch.eval import pipeline
    summary = pipeline.multi_prediction_summary
    monkeypatch.setattr(pipeline, "multi_prediction_summary",
                        lambda mp: summary(mp[:len(mp) // 2]))
    result = _run(transunet_root)
    assert not result["correct"], result["checks"]
    assert any(not math.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in result["checks"].values())


def test_bench_transunet_counters_hold_the_protocol(tmp_path, cpu):
    """A profiled evaluate_subjects call counts 8 slices a subject through
    the trunk, 3 samples a slice through the encoder and decoder, and
    every element of the 5 active dropout sites (the embeddings', and each
    of 2 layers' two MLP sites; attention dropout is 0)."""
    from rcu_tpu_torch.eval.direct import evaluate_subjects
    from rcu_tpu_torch.models import get_model
    from rcu_tpu_torch.utils import profiling
    from benchmark import inputs
    volumes = inputs.brats_volumes(2, (8, 32, 32), 4, 5, cpu)
    pool = inputs.VolumePool(volumes, ["a", "b", "c"])
    net = get_model("transunet", MODEL)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        evaluate_subjects(net, pool, str(tmp_path), strategy="mc", mc=3,
                          batch_size=3, seed=7, masked=False, device=cpu)
    counts = profiling.counters()
    slices, tokens = 3 * 8, 2 * 2
    assert counts["transunet.trunk_images"] == slices
    assert counts["transunet.samples"] == 3 * slices
    assert counts["transunet.dropout_elements"] == 3 * slices * tokens * (
        64 + 2 * (128 + 64))
    names = [s.name for s in profiling.spans()]
    # 3 subjects of 3 batches (3 + 3 + 2 slices)
    assert names.count("transunet.trunk") == 9
    assert names.count("transunet.encoder") == 9
    assert names.count("transunet.decoder") == 9
    assert profiling.device_seconds() == {}


@pytest.mark.parametrize("size,model", [
    (32, MODEL),
    (240, {**MODEL, "img_size": 240, "hidden": 768, "mlp_dim": 3072,
           "heads": 12, "layers": 12, "resnet_units": [3, 4, 9],
           "width": 64, "decoder_channels": [256, 128, 64, 16],
           "head_channels": 512})], ids=["tiny", "published"])
def test_bench_transunet_flops_equal_torch_flop_counter(size, model):
    """The shapes' count against torch's FlopCounterMode on the program's
    model on meta tensors (no arithmetic runs): the trunk an image, the
    encoder and decoder a sample."""
    from rcu_tpu_torch.models import get_model
    with torch.device("meta"):
        net = get_model("transunet", model)
    x = torch.empty(1, 4, size, size, device="meta")
    with FlopCounterMode(display=False) as counter:
        embeddings, skips = net.encode_shared(x)
    assert counter.get_total_flops() == transunet_flops.trunk_flops(
        model, size, size)
    with FlopCounterMode(display=False) as counter:
        net.decode_rest(embeddings, skips)
    assert counter.get_total_flops() == transunet_flops.sample_flops(
        model, size, size)


def test_bench_transunet_reference_imports_no_program():
    code = ("import sys; import benchmark.reference.transunet; "
            "import benchmark.transunet_flops; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rcu_tpu', 'rcu_tpu_torch'}; "
            "sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          timeout=120)
    assert done.returncode == 0
