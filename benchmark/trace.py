"""The traced window: torch.profiler over the window (host ops and device
activity), reduced from its raw events to what the per-layer readers and
the breakdown read.

- ``busy_s``: the union of the device's activity intervals (kernels,
  copies, sets), as seconds in which some operation ran on the device;
- ``kernel_s``: each kernel's summed device time (copies and sets apart);
- ``conv_s``: the device time of the kernels whose launching op ran
  inside ``aten::convolution`` or ``aten::conv_transpose2d`` on its
  thread;
- ``device_ops``: the 10 device operations with the most time;
- ``idle_gaps``: the 10 host ops (the innermost one running at a gap's
  middle) under which the longest device idle gaps fell, with their
  summed gap seconds.

The raw events are read directly (``kineto_results.events()``): building
the profiler's own event tree takes minutes for a window of a million
events.
"""
from __future__ import annotations

import bisect
import contextlib

import numpy as np

CONV_OPS = ("aten::convolution", "aten::conv_transpose2d")
NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")
GAPS_LOOKED_AT = 200


@contextlib.contextmanager
def profiled(device):
    """torch.profiler over the block, host ops and, on a card, the device."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def _union(intervals):
    """Sorted disjoint (start, end) of the union of ``intervals``."""
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def _inside(starts, union, t) -> bool:
    """Whether ``t`` lies in the union whose starts are ``starts``."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= union[i][1]


def summarize(prof) -> dict:
    return summarize_events(prof.profiler.kineto_results.events())


def summarize_events(events) -> dict:
    """The summary of raw profiler events (``name()``, ``device_type()``,
    ``start_ns()``, ``end_ns()``, ``correlation_id()``,
    ``linked_correlation_id()``, ``start_thread_id()``)."""
    from torch.autograd import DeviceType
    device, host, launched_at, conv = [], [], {}, {}
    for e in events:
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.linked_correlation_id()))
        elif kind == DeviceType.CPU:
            start, end, name = e.start_ns(), e.end_ns(), e.name()
            host.append((start, end, name))
            if e.linked_correlation_id() == 0:  # an op, not a runtime call
                thread = e.start_thread_id()
                launched_at[e.correlation_id()] = (thread, start)
                if name in CONV_OPS:
                    conv.setdefault(thread, []).append((start, end))
    conv = {t: _union(spans) for t, spans in conv.items()}
    conv = {t: ([s for s, _ in u], u) for t, u in conv.items()}
    busy, gaps, reach = 0, [], None
    for start, end in _union((s, e) for s, e, _, _ in device):
        if reach is not None:
            gaps.append((start - reach, (start + reach) / 2))
        busy += end - start
        reach = end
    kernel_s, by_op, conv_ns = {}, {}, 0
    for start, end, name, linked in device:
        seconds = (end - start) / 1e9
        by_op[name] = by_op.get(name, 0.0) + seconds
        if name.startswith(NOT_KERNELS):
            continue
        kernel_s[name] = kernel_s.get(name, 0.0) + seconds
        op = launched_at.get(linked)
        if op is not None and op[0] in conv and _inside(*conv[op[0]],
                                                        op[1]):
            conv_ns += end - start
    return {"busy_s": busy / 1e9, "kernel_s": kernel_s,
            "conv_s": conv_ns / 1e9,
            "device_ops": sorted(([n, s] for n, s in by_op.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": _idle_gaps(gaps, host)}


def _idle_gaps(gaps, host) -> list:
    if not gaps or not host:
        return []
    gaps = sorted(gaps, reverse=True)[:GAPS_LOOKED_AT]
    starts = np.asarray([s for s, _, _ in host], np.int64)
    ends = np.asarray([e for _, e, _ in host], np.int64)
    by_name = {}
    for length, middle in gaps:
        hits = np.nonzero((starts <= middle) & (ends >= middle))[0]
        name = host[hits[np.argmax(starts[hits])]][2] if len(hits) \
            else "host, outside any op"
        by_name[name] = by_name.get(name, 0.0) + length / 1e9
    return sorted(([n, s] for n, s in by_name.items()),
                  key=lambda x: -x[1])[:10]
