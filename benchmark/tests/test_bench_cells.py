"""The benchmark's definition against its contract, and whole runs of
tiny cells on the CPU (the harness's look for a card skipped): every cell
and metric found by its name, a cell, its configuration, traffic and a
test-only metric added as files, and ``correct`` false under each fault
the timed path can have."""
from __future__ import annotations

import json
import math
import os
import re
import time

import pytest
import torch

from benchmark import harness

from tiny import CELLS, REPO, TRAFFIC

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def _spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_bench_spec_keys_names_and_files():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    for part, keys in KEYS.items():
        names = [e["name"] for e in spec[part]]
        assert len(names) == len(set(names))
        for entry in spec[part]:
            assert set(entry) - {"workloads"} == keys, entry["name"]
            assert NAME.match(entry["name"])
            if "unit" in entry:
                assert UNIT.match(entry["unit"])
                assert entry["better"] in ("lower", "higher")
    for config in spec["configs"]:
        assert os.path.isfile(os.path.join(REPO, config["file"]))
        assert config["file"].startswith("benchmark/")
    for cell in spec["workloads"]:
        assert cell["chips"] == 1
        assert os.path.isfile(os.path.join(
            REPO, "benchmark/traffic", cell["traffic"] + ".json"))
        assert os.path.isfile(os.path.join(
            REPO, "benchmark/limits", cell["name"] + ".json"))
    for entry in spec["end_to_end"]:
        assert entry["source"] in ("host_clock", "device_trace")
        assert 0.01 <= entry["bound"] <= 0.25
    for entry in spec["per_layer"]:
        assert os.path.isfile(os.path.join(
            REPO, "benchmark/metrics", entry["name"] + ".py"))
        if entry["unit"] == "%" and entry["name"].endswith("_roofline"):
            assert entry["source"] == "device_trace"


def test_bench_every_cell_reports_what_the_contract_asks():
    spec = _spec()
    e2e = {e["name"]: e for e in spec["end_to_end"]}
    for cell in spec["workloads"]:
        name = cell["name"]
        reported = [e for e in e2e if harness.reports(e2e[e], name)]
        assert "setup_s" in reported and len(reported) >= 2
        layers = [m for m in spec["per_layer"]
                  if harness.reports(m, name)]
        assert layers
        for metric in layers:
            assert harness.reports(e2e[metric["moves"]], name)


def _run(root, cell, seconds=0.3, trace=0, seed=2 ** 31 + 11):
    return harness.run_cell(root, cell, seed, seconds, trace,
                            torch.device("cpu"),
                            time.clock_gettime(time.CLOCK_BOOTTIME))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_bench_tiny_cell_is_correct(tiny_root, cpu, cell):
    result = _run(tiny_root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    driver = TRAFFIC[CELLS[cell][1]]["driver"]
    rate = "train_slices_per_s" if driver == "train" else "eval_voxels_per_s"
    assert set(result["metrics"]) == {rate, "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert result["device"]["platform"] == "cpu"


def test_bench_traced_run_reads_a_metric_added_as_a_file(tiny_root, cpu):
    result = _run(tiny_root, "tiny_brats_mc", trace=1)
    assert result["correct"]
    # the card's readers find no device activity on the CPU and say
    # nothing; the test-only reader is found by its name
    assert result["metrics"] == {"window_share": {"value": 100.0,
                                                  "unit": "%"}}
    assert result["device"]["busy_s"] == 0.0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def _half_of_the_samples(monkeypatch):
    from rcu_tpu_torch.eval import pipeline
    summary = pipeline.multi_prediction_summary
    monkeypatch.setattr(pipeline, "multi_prediction_summary",
                        lambda mp: summary(mp[:len(mp) // 2]))


def _half_of_the_batch(monkeypatch):
    from rcu_tpu_torch.eval import pipeline
    predict = pipeline.predict

    def half(model, images):
        probs = predict(model, images[:(len(images) + 1) // 2])
        return torch.cat([probs, probs])[:len(images)]
    monkeypatch.setattr(pipeline, "predict", half)


def _entropy_altered(monkeypatch):
    from rcu_tpu_torch.eval import pipeline
    normalize = pipeline._normalize_entropy
    monkeypatch.setattr(pipeline, "_normalize_entropy",
                        lambda ent: normalize(ent) * 0.9)


def _state_unchanged(monkeypatch):
    from rcu_tpu_torch.engine.state import TrainState

    def step(self):
        for p in self.params.values():
            p.grad = None
    monkeypatch.setattr(TrainState, "step", step)


def _state_unchanged_after_epoch_0(monkeypatch):
    from rcu_tpu_torch.engine.state import TrainState
    step = TrainState.step

    def stale(self):
        if self.epoch == 0:
            return step(self)
        for p in self.params.values():
            p.grad = None
    monkeypatch.setattr(TrainState, "step", stale)


def _epoch_0_order_every_epoch(monkeypatch):
    from rcu_tpu_torch.data.loader import SliceBatchLoader
    monkeypatch.setattr(SliceBatchLoader, "set_epoch",
                        lambda self, epoch: None)


def _half_of_the_train_batch(monkeypatch):
    from rcu_tpu_torch.engine.steps import TrainStep
    call = TrainStep.__call__

    def half(self, state, batch, generator, noise=None):
        n = len(batch["valid"]) // 2
        return call(self, state, {k: v[:n] for k, v in batch.items()},
                    generator, noise)
    monkeypatch.setattr(TrainStep, "__call__", half)


FAULTS = [("tiny_brats_mc", _half_of_the_samples),
          ("tiny_brats_mc", _entropy_altered),
          ("tiny_isic_mc", _half_of_the_samples),
          ("tiny_isic_mc", _entropy_altered),
          ("tiny_brats_det", _half_of_the_batch),
          ("tiny_brats_det", _entropy_altered),
          ("tiny_brats_train", _state_unchanged),
          ("tiny_brats_train", _state_unchanged_after_epoch_0),
          ("tiny_brats_train", _epoch_0_order_every_epoch),
          ("tiny_brats_train", _half_of_the_train_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_bench_fault_is_not_correct(tiny_root, cpu, monkeypatch, cell,
                                    fault):
    fault(monkeypatch)
    result = _run(tiny_root, cell)
    assert not result["correct"], result["checks"]
    assert any(not math.isfinite(c["value"]) or c["value"] > c["limit"]
               for c in result["checks"].values())
