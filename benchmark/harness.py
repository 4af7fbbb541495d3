"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell;
the cell names its configuration (a file under ``benchmark/configs``)
and its traffic (``benchmark/traffic/<traffic>.json``), whose ``driver``
names the code that runs it (``benchmark/drivers/<driver>.py``); its
correctness limits are ``benchmark/limits/<cell>.json``; each per-layer
metric is read by ``benchmark/metrics/<metric>.py``. A later cell,
traffic mix or metric is new files and new entries.

A driver's ``drive(run)`` builds the program's object from the seeded
inputs, warms up the cell's shapes, calls the timed path inside
``run.window()``, and after the window compares what the timed path
produced with the plain reference. It returns a :class:`Outcome`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time

from benchmark import compare, trace

# top-level module names that no run may load: the JAX stack and the JAX
# package (compared whole: the program's name begins with the latter's)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "rcu_tpu"})


def forbidden_modules(modules=None) -> list:
    names = {name.split(".")[0] for name in (modules or sys.modules)}
    return sorted(names & FORBIDDEN)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _named(entries, name, what):
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"BENCHMARK.json names no {what} '{name}'")


def reports(entry: dict, cell: str) -> bool:
    return cell in entry.get("workloads", [cell])


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: its end-to-end values (besides
    ``setup_s`` and ``peak_device_gb``, which the harness takes), the
    work attempted and failed in the window, the numbers compared with
    the reference, and the work counted from shapes for the readers."""
    values: dict
    attempted: int
    failed: int
    numbers: dict
    work: dict


class Run:
    """A cell's run as its driver sees it."""

    def __init__(self, root, spec, workload, seed, seconds, trace_on,
                 device, started_at):
        self.root, self.spec = root, spec
        self.cell = _named(spec["workloads"], workload, "workload")
        entry = _named(spec["configs"], self.cell["config"], "config")
        self.config = load_json(os.path.join(root, entry["file"]))
        self.traffic = load_json(os.path.join(
            root, "benchmark", "traffic", self.cell["traffic"] + ".json"))
        self.limits = load_json(os.path.join(
            root, "benchmark", "limits", workload + ".json"))
        self.seed, self.seconds = int(seed), float(seconds)
        self.trace, self.device = bool(trace_on), device
        self.started_at = started_at  # seconds on CLOCK_BOOTTIME
        self.scratch = tempfile.mkdtemp(prefix="rcu_bench_")
        self.setup_s = self.window_s = None
        self.window_peak = self.setup_peak = 0
        self.summary = None
        self.phases = []  # (set-up step, seconds since the process started)
        self._t0 = None

    def mark(self, step: str):
        """Note that the set-up step ``step`` has ended (printed beside the
        result on standard error, to show where set-up goes)."""
        self.phases.append((step, time.clock_gettime(time.CLOCK_BOOTTIME)
                            - self.started_at))

    def elapsed(self) -> float:
        """Seconds since the window opened."""
        return time.perf_counter() - self._t0

    def sync(self):
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def window(self):
        """The measured window: the device synchronised on both sides, the
        peak memory counted from its start, and with ``--trace 1`` the
        profiler over it."""
        import torch
        self.sync()
        on_card = self.device.type == "cuda"
        if on_card:
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        with contextlib.ExitStack() as stack:
            prof = stack.enter_context(trace.profiled(self.device)) \
                if self.trace else None
            self.setup_s = time.clock_gettime(time.CLOCK_BOOTTIME) \
                - self.started_at
            self._t0 = time.perf_counter()
            yield self
            self.sync()
            self.window_s = time.perf_counter() - self._t0
        if on_card:
            self.window_peak = torch.cuda.max_memory_allocated(self.device)
        if prof is not None:
            self.summary = trace.summarize(prof)

    def close(self):
        shutil.rmtree(self.scratch, ignore_errors=True)


def _metric_value(run, outcome, name):
    if name == "setup_s":
        return run.setup_s
    if name == "peak_device_gb":
        return run.window_peak / 1e9 if run.device.type == "cuda" else None
    return outcome.values.get(name)


def run_cell(root, workload, seed, seconds, trace_on, device,
             started_at) -> dict:
    """One run; -> the result line's object and, under ``setup_phases``,
    the set-up's steps (``run.py`` prints them apart, and ``checks``
    last)."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    run = Run(root, spec, workload, seed, seconds, trace_on, device,
              started_at)
    if device.type == "cuda":
        import torch
        torch.empty(0, device=device)  # the CUDA context
    run.mark("imports and CUDA context")
    try:
        driver = load_module(os.path.join(
            root, "benchmark", "drivers", run.traffic["driver"] + ".py"),
            "benchmark_driver_" + run.traffic["driver"])
        outcome = driver.drive(run)
    finally:
        run.close()
    correct, checks = compare.judge(outcome.numbers, run.limits)
    correct = correct and outcome.failed == 0
    metrics = {}
    if not run.trace:
        for entry in spec["end_to_end"]:
            if reports(entry, workload):
                value = _metric_value(run, outcome, entry["name"])
                if value is not None:
                    metrics[entry["name"]] = {"value": value,
                                              "unit": entry["unit"]}
    else:
        record = {"cell": workload, "driver": run.traffic["driver"],
                  "window_s": run.window_s, "trace": run.summary,
                  "work": outcome.work}
        for entry in spec["per_layer"]:
            if not reports(entry, workload):
                continue
            reader = load_module(os.path.join(
                root, "benchmark", "metrics", entry["name"] + ".py"),
                "benchmark_metric_" + entry["name"].replace(".", "_"))
            value = reader.read(record)
            if value is not None:
                metrics[entry["name"]] = {"value": value,
                                          "unit": entry["unit"]}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics,
              "device": _device(run)}
    if run.trace and run.summary is not None:
        result["breakdown"] = {"device_ops": run.summary["device_ops"],
                               "idle_gaps": run.summary["idle_gaps"]}
    result["setup_phases"] = run.phases
    result["checks"] = checks
    return result


def _device(run) -> dict:
    if run.device.type == "cuda":
        import torch
        device = {"platform": "gpu",
                  "kind": torch.cuda.get_device_name(run.device),
                  "count": 1,
                  "memory_peak_bytes": max(run.setup_peak, run.window_peak)}
    else:
        device = {"platform": "cpu", "kind": "cpu", "count": 1,
                  "memory_peak_bytes": 0}
    if run.trace:
        busy = run.summary["busy_s"] if run.summary else 0.0
        device.update(busy_s=busy, window_s=run.window_s)
    return device


def check_lines(checks: dict) -> list:
    """The compared numbers beside their limits, one a line."""
    return [f"{name} {c['value']!r} limit {c['limit']!r}"
            + ("" if math.isfinite(c["value"]) and c["value"] <= c["limit"]
               else " FAILED")
            for name, c in checks.items()]
