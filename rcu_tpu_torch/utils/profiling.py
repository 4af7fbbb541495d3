"""Profiling support (``rcu_tpu.utils.profiling`` counterpart): device traces
with ``torch.profiler`` (Chrome trace files, which TensorBoard's profiler
plugin and ``chrome://tracing`` read), a train-loop hook that traces a few
steps, a host section timer, and the practical rates of the card's memory
and of the links between a mesh's devices, against which a roofline share
means something: the spec sheet's peak cannot tell "at the roof" from
"30 % below it".
"""
from __future__ import annotations

import contextlib
import logging
import time

import torch


def _activities():
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


def _start(log_dir: str):
    from torch.profiler import profile, tensorboard_trace_handler
    prof = profile(activities=_activities(),
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the host, and the card where there
    is one); the Chrome trace is written under ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json`` when the block ends."""
    prof = _start(log_dir)
    try:
        yield prof
    finally:
        prof.stop()


class ProfilerHook:
    """TrainLoop hook: traces steps ``[start_step, stop_step)`` of the first
    epoch (counted from 1, as the JAX package counts them) into
    ``log_dir``. An epoch shorter than ``stop_step`` ends the trace at its
    end, and the run's termination ends one still open: a trace left
    running would profile the whole run."""

    def __init__(self, log_dir: str, start_step: int = 2, stop_step: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = stop_step
        self._prof = None

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)

    def on_training_batch_end(self, loop, epoch, batch_index, nb_batches,
                              metrics):
        if epoch != 0:
            return
        if batch_index + 1 == self.start_step and self._prof is None:
            self._prof = _start(self.log_dir)
            logging.info("profiler trace started (%s)", self.log_dir)
        elif batch_index + 1 >= self.stop_step and self._prof is not None:
            self._stop()

    def on_training_end(self, loop, epoch, metrics_mean):
        if self._prof is not None:
            self._stop()

    def on_termination(self, loop):
        if self._prof is not None:
            self._stop()

    def _stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        self._prof = None
        logging.info("profiler trace stopped")


def _timed(fn, device, rounds: int) -> float:
    """The best of ``rounds`` seconds of ``fn()`` after one warm-up call:
    CUDA events on a card, the host clock around the work on the CPU."""
    fn()
    best = None
    for _ in range(rounds):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best


def measure_practical_hbm(n_elems: int = 128 * 1024 * 1024, steps: int = 200,
                          rounds: int = 3, device="cuda") -> float:
    """The practical memory bandwidth (bytes/s) of ``device``: ``steps``
    multiply-adds ``x + 1e-7 * x`` in place over an f32 buffer of
    ``n_elems`` (512 MiB by default, ten times the H100's 50 MB L2), each
    one vectorized kernel that reads and writes the whole buffer, timed
    as one stretch with CUDA events, the best of ``rounds``: ``2 * buffer
    bytes * steps / time``. On the CPU it times the host's memory (the
    tests' size check)."""
    device = torch.device(device)
    x = torch.full((n_elems,), 1.0, dtype=torch.float32, device=device)

    def stream():
        for _ in range(steps):
            x.add_(x, alpha=1e-7)

    seconds = _timed(stream, device, rounds)
    if not torch.isfinite(x[:1]).all():
        raise RuntimeError("the stream's buffer is not finite")
    return 2.0 * x.numel() * 4 * steps / seconds


def measure_practical_ici(mesh, n_elems: int = 16 * 1024 * 1024,
                          steps: int = 100, rounds: int = 3) -> float:
    """The practical per-link rate (bytes/s, one direction) of the mesh's
    data axis: a ring in which every step each data device copies its f32
    shard of ``n_elems`` to the next one (``shard bytes * steps / time``,
    the best of ``rounds``; host clock around work that ends in a
    synchronize of every device). Between two cards that is the peer
    copy (NVLink where the cards have it). On a virtual mesh (a device
    repeated) every copy stays on one card: it measures an on-card copy,
    which reads and writes the card's memory, not a link between cards,
    as the JAX package's measurer on its CPU mesh measures host memcpy.
    An axis of one device raises."""
    devices = list(mesh.data_devices)
    n = len(devices)
    if n < 2:
        raise ValueError(f"mesh axis 'data' has {n} device(s); "
                         "a ring needs >= 2")
    send = [torch.full((n_elems,), 1.0, dtype=torch.float32, device=d)
            for d in devices]
    recv = [torch.empty_like(s) for s in send]

    def sync():
        for d in dict.fromkeys(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def ring():
        nonlocal send, recv
        for _ in range(steps):
            for i in range(n):
                recv[(i + 1) % n].copy_(send[i], non_blocking=True)
            send, recv = recv, send
        sync()

    ring()
    best = None
    for _ in range(rounds):
        sync()
        t0 = time.perf_counter()
        ring()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return float(n_elems) * 4 * steps / best


class Timer:
    """Cheap wall-clock section timer for host-side phases."""

    def __init__(self):
        self.sections = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name] = self.sections.get(name, 0.0) + \
                time.perf_counter() - t0

    def report(self) -> str:
        return " ".join(f"{k}={v:.3f}s"
                        for k, v in sorted(self.sections.items()))
