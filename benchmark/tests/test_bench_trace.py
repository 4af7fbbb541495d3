"""The trace reduction on raw events made up by hand: the union of the
device's intervals, the gaps and the host op under each, and the kernels
attributed to a convolution by their launching op's place on its thread."""
from __future__ import annotations

import pytest
from torch.autograd import DeviceType

from benchmark import trace


class Event:
    def __init__(self, name, kind, start, end, corr=0, linked=0, thread=1):
        self._v = (name, kind, start, end, corr, linked, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


CPU, CUDA = DeviceType.CPU, DeviceType.CUDA


def test_bench_trace_summary_of_made_up_events():
    events = [
        Event("aten::conv_transpose2d", CPU, 0, 100, corr=1),
        Event("aten::convolution", CPU, 10, 90, corr=2),
        Event("aten::cudnn_convolution", CPU, 20, 80, corr=3),
        Event("cudaLaunchKernel", CPU, 30, 35, corr=50, linked=3),
        Event("aten::relu", CPU, 120, 140, corr=4),
        Event("aten::relu", CPU, 120, 140, corr=5, thread=2),
        Event("conv_kernel", CUDA, 1000, 3000, corr=50, linked=3),
        Event("conv_kernel", CUDA, 2500, 4000, corr=51, linked=3),
        Event("relu_kernel", CUDA, 6000, 7000, corr=52, linked=4),
        Event("Memcpy HtoD (Pinned -> Device)", CUDA, 9000, 9500,
              corr=53, linked=5),
    ]
    summary = trace.summarize_events(events)
    # the union: [1000, 4000], [6000, 7000], [9000, 9500]
    assert summary["busy_s"] == pytest.approx(4500e-9)
    assert summary["kernel_s"] == {"conv_kernel": pytest.approx(3500e-9),
                                   "relu_kernel": pytest.approx(1000e-9)}
    assert summary["conv_s"] == pytest.approx(3500e-9)
    assert summary["device_ops"][0] == ["conv_kernel", pytest.approx(3.5e-6)]
    # both gaps (2000 and 2000 ns) fall outside every host op
    assert summary["idle_gaps"] == [["host, outside any op",
                                     pytest.approx(4e-6)]]


def test_bench_trace_names_the_host_op_under_a_gap():
    events = [Event("aten::copy_", CPU, 0, 10_000, corr=1),
              Event("aten::empty", CPU, 4000, 6000, corr=2),
              Event("k", CUDA, 0, 1000, linked=1),
              Event("k", CUDA, 9000, 9500, linked=1)]
    summary = trace.summarize_events(events)
    # the gap's middle (5000) lies in both ops: the innermost names it
    assert summary["idle_gaps"] == [["aten::empty", pytest.approx(8e-6)]]
    assert summary["conv_s"] == 0
