"""Profiling support (``rcu_tpu.utils.profiling`` counterpart): device traces
with ``torch.profiler`` (Chrome trace files, which TensorBoard's profiler
plugin and ``chrome://tracing`` read), a train-loop hook that traces a few
steps, the program's spans and counters, and the practical rates of the
card's memory and of the links between a mesh's devices, against which a
roofline share means something: the spec sheet's peak cannot tell "at the
roof" from "30 % below it".

Spans and counters record only while a torch profiler runs (the flag that
``torch.autograd.profiler`` sets for its own fast paths): under
:func:`trace`, :class:`ProfilerHook` or any ``torch.profiler.profile``.
With none running a span costs one flag test. While one runs, a span is a
host op in the profiler's trace (on the thread that started the profiler;
torch records no host op of another thread) and an entry of an in-memory
record kept for every thread, on the profiler's event clock (unix ns), so
that a reader thread's spans line up with the device's activity in the
same trace. The host op is torch's fast record function, an op like
``aten::add``, not ``record_function``'s user annotation: on a card the
profiler draws each user annotation a second time on the device's
timeline (``gpu_user_annotation``, from its first kernel's start to its
last one's end), which a reading of the device's activity from the trace
would count as busy time.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import socket
import threading
import time
import typing

import torch
from torch.autograd import profiler as _autograd_profiler

_HostOp = torch._C._profiler._RecordFunctionFast  # an op, not an annotation

MAX_SPANS = 100_000  # past it a span is dropped and ``spans.dropped`` counts


class Span(typing.NamedTuple):
    """A recorded span: ``start_ns`` and ``end_ns`` on the profiler's event
    clock (unix ns, as ``kineto_results.events()`` gives its events),
    ``thread`` the native id of the thread that ran it, ``parent`` the name
    of the span it ran inside on that thread (None at the top), ``item``
    the eval item or train step it belongs to (its parent's where not
    given)."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: typing.Optional[str]
    item: typing.Optional[int]


class _Record:
    """The process's spans and counters (the profiler that gates them is
    process-wide too) and the names of the threads that recorded them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list = []
        self.counters: dict = {}
        self.threads: dict = {}  # native id -> thread name
        self.local = threading.local()  # each thread's stack of open spans

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
            self.threads[threading.get_native_id()] = \
                threading.current_thread().name
        return stack

    def add(self, entry: Span):
        with self.lock:
            if len(self.spans) < MAX_SPANS:
                self.spans.append(entry)
            else:
                self.counters["spans.dropped"] = \
                    self.counters.get("spans.dropped", 0) + 1


_RECORD = _Record()


class _Off:
    """What :func:`span` returns with no profiler running: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, item: int = None):
    """``with span(name, item=None):`` records the block while a torch
    profiler runs (see the module doc); ``item`` is the index that the
    spans of one eval item or train step share across threads, inherited
    from the enclosing span where not given. With no profiler running it
    costs one flag test and returns a shared object that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, item)


class _Span:
    """An open span: a host op of the profiler and, at its end, an entry of
    the record."""
    __slots__ = ("name", "item", "_function", "_parent", "_start")

    def __init__(self, name: str, item):
        self.name, self.item = name, item

    def __enter__(self):
        stack = _RECORD.stack()
        parent = stack[-1] if stack else None
        self._parent = None if parent is None else parent.name
        if self.item is None and parent is not None:
            self.item = parent.item
        self._function = _HostOp(self.name)
        self._function.__enter__()
        self._start = time.time_ns()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _RECORD.stack().pop()
        self._function.__exit__(*exc)
        _RECORD.add(Span(self.name, self._start, end,
                         threading.get_native_id(), self._parent, self.item))
        return False


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name`` while a torch profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    with _RECORD.lock:
        _RECORD.counters[name] = _RECORD.counters.get(name, 0) + n


def spans() -> list:
    """The recorded :class:`Span` s, each in the order it ended."""
    with _RECORD.lock:
        return list(_RECORD.spans)


def counters() -> dict:
    """The counters, with ``spans.dropped`` where the record was full."""
    with _RECORD.lock:
        return dict(_RECORD.counters)


def clear():
    """Forget every span and counter (:func:`trace` and
    :class:`ProfilerHook` clear as their profiler starts)."""
    with _RECORD.lock:
        _RECORD.spans.clear()
        _RECORD.counters.clear()


def _activities():
    from torch.profiler import ProfilerActivity
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


def _start(log_dir: str):
    from torch.profiler import profile
    clear()
    prof = profile(activities=_activities(),
                   on_trace_ready=_trace_writer(log_dir,
                                                threading.get_native_id()))
    prof.start()
    return prof


def _trace_writer(log_dir: str, profiling_thread: int):
    """The profiler's ``on_trace_ready``: its Chrome trace under ``log_dir``
    as ``tensorboard_trace_handler`` names it, with the spans of every
    thread but ``profiling_thread`` (whose spans the profiler recorded
    itself) added as complete events on their threads."""
    def ready(prof):
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}"
                                     f".{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        others = [s for s in spans() if s.thread != profiling_thread]
        if others:
            _add_spans(path, others)
    return ready


def _add_spans(path: str, entries: list):
    with open(path) as f:
        chrome = json.load(f)
    base = chrome.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = chrome.setdefault("traceEvents", [])
    for tid in sorted({s.thread for s in entries}):
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": _RECORD.threads.get(
                           tid, f"thread {tid}")}})
    for s in entries:
        events.append({"ph": "X", "cat": "user_annotation", "name": s.name,
                       "pid": pid, "tid": s.thread,
                       "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"item": s.item, "parent": s.parent}})
    with open(path, "w") as f:
        json.dump(chrome, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the host, and the card where there
    is one); the Chrome trace is written under ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json`` when the block ends, with the
    spans of the program's other threads (the eval reader, the train
    feed) on their own threads. The spans and counters recorded before
    are cleared as the block starts; the block's stay readable after it
    (:func:`spans`, :func:`counters`)."""
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
