"""The Swin UNETR cell's files against the contract, and a tiny Swin UNETR
cell run whole on the CPU through the harness, added as files beside the
tiny U-Net cells (``tiny.py``): ``correct`` on the sound program, not
correct when the timed path keeps half of the MC samples; the program's
counters of a profiled call equal the protocol's counts; the FLOPs counted
from shapes equal a count by hand at a small size (window padding
included) and torch's FLOP counter on the program's model; the three
readers read None where the counters or events are missing; a program
without Swin UNETR fails at set-up; the reference loads neither JAX nor
the program."""
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

from benchmark import harness, swinunetr_flops

from tiny import EVAL_LIMITS, REPO, TH, make_root

CELL = "tiny_brats_swinunetr_mc"
MODEL = {"in_channels": 4, "nb_classes": 2, "img_size": 64,
         "feature_size": 12, "depths": [2, 2, 2, 2], "heads": [3, 6, 12, 24],
         "window": 7, "patch": 2, "mlp_ratio": 4.0, "drop_rate": 0.1,
         "attn_drop_rate": 0.0, "dropout_path_rate": 0.0, "use_v2": False}
CONFIG = {"model": {"swin_unetr": MODEL},
          "data": {"kind": "brats_volumes", "shape": [8, 64, 64],
                   "channels": 4, "eval_pool": 2, "masked": True}}
TRAFFIC = {"driver": "direct_eval_swinunetr", "strategy": "mc", "mc": 3,
           "dtype": "float32", "fast_decoder": False, "batch_size": 4,
           "thresholds": TH, "check_items": 2, "warmup_items": 1,
           "items_per_s": 10}
NEW_METRICS = ("swinunetr_mfu.eval", "swin_share.eval",
               "window_attention_share.eval")


def _write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


@pytest.fixture
def swin_root(tmp_path):
    """The tiny root plus a tiny Swin UNETR cell, added as files as the
    repository's cell is."""
    root = make_root(tmp_path)
    _write(os.path.join(root, "benchmark/configs/tiny_swinunetr.json"),
           CONFIG)
    _write(os.path.join(root, "benchmark/traffic/tiny_swinunetr_mc.json"),
           TRAFFIC)
    _write(os.path.join(root, f"benchmark/limits/{CELL}.json"), EVAL_LIMITS)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny_swinunetr", "source": "test",
                            "file": "benchmark/configs/tiny_swinunetr.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": CELL, "config": "tiny_swinunetr",
                              "traffic": "tiny_swinunetr_mc", "chips": 1,
                              "why": "test"})
    for entry in spec["end_to_end"] + spec["per_layer"]:
        if entry["name"] in ("eval_voxels_per_s",) + NEW_METRICS:
            entry["workloads"].append(CELL)
    _write(path, spec)
    return root


def _run(root, trace=0, seed=2 ** 31 + 37):
    return harness.run_cell(root, CELL, seed, 0.3, trace,
                            torch.device("cpu"),
                            time.clock_gettime(time.CLOCK_BOOTTIME))


def test_bench_swinunetr_entries_and_files():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    (config,) = [c for c in spec["configs"] if c["name"] == "brats_swinunetr"]
    assert config["reduced"] == ["spatial_dims"]
    with open(os.path.join(REPO, config["file"])) as f:
        data = json.load(f)
    model = data["model"]["swin_unetr"]
    assert data["spatial_dims"] == 2 and data["published"]["spatial_dims"] == 3
    assert {k: v for k, v in model.items()
            if k not in ("in_channels", "nb_classes", "img_size",
                         "drop_rate")} == {
        "feature_size": 48, "depths": [2, 2, 2, 2], "heads": [3, 6, 12, 24],
        "window": 7, "patch": 2, "mlp_ratio": 4.0, "attn_drop_rate": 0.0,
        "dropout_path_rate": 0.0, "use_v2": False}
    (cell,) = [c for c in spec["workloads"]
               if c["name"] == "brats_swinunetr_mc20_f32"]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "brats_swinunetr", "swinunetr_mc20_f32_subjects", 1)
    metrics = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW_METRICS:
        assert metrics[name]["workloads"] == ["brats_swinunetr_mc20_f32"]
        assert metrics[name]["moves"] == "eval_voxels_per_s"
        assert metrics[name]["layer"] == "forwards"


def test_bench_tiny_swinunetr_cell_is_correct(swin_root, cpu):
    result = _run(swin_root)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 3
    assert set(result["metrics"]) == {"eval_voxels_per_s", "setup_s"}
    # traced: the card's readers find no device activity on the CPU
    traced = _run(swin_root, trace=1)
    assert traced["correct"] and not set(traced["metrics"]) & set(NEW_METRICS)


def test_bench_tiny_swinunetr_half_of_the_samples_is_not_correct(
        swin_root, cpu, monkeypatch):
    from rcu_tpu_torch.eval import pipeline
    summary = pipeline.multi_prediction_summary
    monkeypatch.setattr(pipeline, "multi_prediction_summary",
                        lambda mp: summary(mp[:len(mp) // 2]))
    result = _run(swin_root)
    assert not result["correct"], result["checks"]
    assert any(not math.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in result["checks"].values())


def test_bench_swinunetr_fails_at_once_without_the_model(swin_root, cpu,
                                                        monkeypatch):
    """A program whose registry has no ``swin_unetr`` (the parent of the
    change that added it) fails at set-up, before any data is made."""
    from rcu_tpu_torch.models import registry
    monkeypatch.delitem(registry._BUILD, "swin_unetr")
    t0 = time.perf_counter()
    with pytest.raises(NotImplementedError, match="swin_unetr"):
        _run(swin_root)
    assert time.perf_counter() - t0 < 30


def test_bench_swinunetr_counters_hold_the_protocol(tmp_path, cpu):
    """A profiled evaluate_subjects call counts 6 slices a subject through
    the shared prefix, 3 samples a slice through the rest, the windows
    each block attends, and every element of the active dropout sites."""
    from rcu_tpu_torch.eval.direct import evaluate_subjects
    from rcu_tpu_torch.models import get_model
    from rcu_tpu_torch.utils import profiling
    from benchmark import inputs
    volumes = inputs.brats_volumes(2, (6, 64, 64), 4, 5, cpu)
    pool = inputs.VolumePool(volumes, ["a", "b"])
    net = get_model("swin_unetr", MODEL)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        evaluate_subjects(net, pool, str(tmp_path), strategy="mc", mc=3,
                          batch_size=4, seed=7, masked=False, device=cpu)
    counts = profiling.counters()
    slices = 2 * 6
    samples = 3 * slices
    assert counts["swinunetr.images"] == slices
    assert counts["swinunetr.samples"] == samples
    # at 64: grids 32 (pads to 35, 25 windows), 16 (21, 9), 8 (14, 4) and
    # 4 (one window)
    assert counts["swinunetr.windows"] == samples * 2 * (25 + 9 + 4 + 1)
    # pos_drop on 12 x 32 x 32; a block's proj_drop on its padded windows
    # and its MLP's two sites on 5 x its tokens
    padded = {0: 35 * 35, 1: 21 * 21, 2: 14 * 14, 3: 4 * 4}
    per_sample = 12 * 32 * 32 + sum(
        2 * (12 << s) * (padded[s] + 5 * (32 >> s) ** 2) for s in range(4))
    assert counts["swinunetr.dropout_elements"] == samples * per_sample
    assert "transunet.dropout_elements" not in counts
    names = [s.name for s in profiling.spans()]
    # 2 subjects of 2 batches (4 + 2 slices)
    assert names.count("swinunetr.shared") == 4
    assert names.count("swinunetr.swin") == 4
    assert names.count("swinunetr.decoder") == 4
    assert names.count("swinunetr.window_attention") == 4 * 8
    assert profiling.device_seconds() == {}


def test_bench_swinunetr_flops_against_a_count_by_hand():
    """At 64 x 64 (no image padding), feature 12, window 7: stage grids 32,
    16, 8 and 4; the first three pad to 35, 21 and 14 (windows of 7), the
    last is one window of its own size."""
    fs = 12

    def conv(cin, cout, k, side):
        return 2 * cin * cout * k * k * side * side

    shared = conv(4, fs, 3, 64) + conv(fs, fs, 3, 64) + conv(4, fs, 1, 64) \
        + 2 * 4 * fs * 4 * 32 * 32
    assert swinunetr_flops.shared_flops(MODEL, 64, 64) == shared
    swin = 0
    for dim, grid, padded, window in ((12, 32, 35, 7), (24, 16, 21, 7),
                                      (48, 8, 14, 7), (96, 4, 4, 4)):
        qkv_proj = 2 * padded ** 2 * 4 * dim * dim
        attention = 4 * padded ** 2 * window ** 2 * dim
        mlp = 2 * grid ** 2 * 8 * dim * dim
        merging = 2 * (grid // 2) ** 2 * 8 * dim * dim
        swin += 2 * (qkv_proj + attention + mlp) + merging
    assert swinunetr_flops.swin_flops(MODEL, 64, 64) == swin
    decoder = conv(fs, fs, 3, 32) * 2 + conv(2 * fs, 2 * fs, 3, 16) * 2 \
        + conv(4 * fs, 4 * fs, 3, 8) * 2 + conv(16 * fs, 16 * fs, 3, 2) * 2
    for cin, cout, side in ((16 * fs, 8 * fs, 4), (8 * fs, 4 * fs, 8),
                            (4 * fs, 2 * fs, 16), (2 * fs, fs, 32),
                            (fs, fs, 64)):
        decoder += conv(cin, cout, 1, side) + conv(2 * cout, cout, 3, side) \
            + conv(cout, cout, 3, side) + conv(2 * cout, cout, 1, side)
    decoder += conv(fs, 2, 1, 64)
    assert swinunetr_flops.sample_flops(MODEL, 64, 64) == swin + decoder


@pytest.mark.parametrize("size,model", [
    (60, {**MODEL, "img_size": 60}),
    (240, {**MODEL, "img_size": 240, "feature_size": 48})],
    ids=["tiny_padded", "published"])
def test_bench_swinunetr_flops_equal_torch_flop_counter(size, model):
    """The shapes' count against torch's FlopCounterMode on the program's
    model on meta tensors (no arithmetic runs): the shared prefix an
    image, the rest a sample."""
    from rcu_tpu_torch.models import get_model
    with torch.device("meta"):
        net = get_model("swin_unetr", model)
    x = torch.empty(1, 4, size, size, device="meta")
    with FlopCounterMode(display=False) as counter:
        embedding, skips = net.encode_shared(x)
    assert counter.get_total_flops() == swinunetr_flops.shared_flops(
        model, size, size)
    with FlopCounterMode(display=False) as counter:
        net.decode_rest(embedding, skips)
    assert counter.get_total_flops() == swinunetr_flops.sample_flops(
        model, size, size)


def _reader(name):
    return harness.load_module(
        os.path.join(REPO, "benchmark", "metrics", name + ".py"),
        "test_metric_" + name.replace(".", "_"))


def test_bench_swinunetr_readers_read_none_without_their_records(
        monkeypatch):
    """No trace, no device time, no counters or no events: None, not an
    error (a program without the model's spans and counters)."""
    from rcu_tpu_torch.utils import profiling
    work = {"swinunetr_shared_flops": 1, "swinunetr_sample_flops": 2,
            "peak_flops": 67e12}
    traced = {"cell": "c", "driver": "direct_eval_swinunetr",
              "window_s": 2.0, "work": work,
              "trace": {"busy_s": 1.0, "kernel_s": {}}}
    profiling.clear()
    for name in NEW_METRICS:
        reader = _reader(name)
        assert reader.read({**traced, "trace": None}) is None
        assert reader.read({**traced, "trace": {"busy_s": 0.0}}) is None
        assert reader.read(traced) is None  # nothing counted or timed
    mfu = _reader("swinunetr_mfu.eval")
    assert mfu.read({**traced, "work": {"peak_flops": 67e12}}) is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "swinunetr.images": 10, "swinunetr.samples": 200})
    assert mfu.read(traced) == pytest.approx(
        100.0 * (10 + 400) / 1.0 / 67e12)
    monkeypatch.setattr(profiling, "device_seconds", lambda: {
        "swinunetr.swin": 0.25, "swinunetr.window_attention": 0.125})
    assert _reader("swin_share.eval").read(traced) == pytest.approx(25.0)
    assert _reader("window_attention_share.eval").read(traced) == \
        pytest.approx(12.5)
    monkeypatch.delattr(profiling, "device_seconds")
    assert _reader("swin_share.eval").read(traced) is None


def test_bench_swinunetr_reference_imports_no_program():
    code = ("import sys; import benchmark.reference.swin_unetr; "
            "import benchmark.swinunetr_flops; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rcu_tpu', 'rcu_tpu_torch'}; "
            "sys.exit(1 if bad else 0)")
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          timeout=120)
    assert done.returncode == 0
