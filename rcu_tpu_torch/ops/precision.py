"""Process-wide backend switches held while any thread needs them, and the
state of the measured choice of cuDNN's conv engines that
``models.unet.conv2d`` reads (the entry points enter it through
``eval.device.measured_conv_engines``)."""
from __future__ import annotations

import contextlib
import threading

import torch


class _HeldSwitches:
    """Process-wide switches set while any block of any thread is inside
    :meth:`held`: the first block to enter saves the caller's values and
    sets the switches' own; they stay set while blocks of several threads
    overlap (a mesh's devices, a service's concurrent requests), and the
    last one to leave restores what the first one found, also on error."""

    def __init__(self, switches):
        self.switches = switches  # () -> [(holder, attribute, value)]
        self.lock = threading.Lock()
        self.users = 0
        self.saved = None

    @contextlib.contextmanager
    def held(self):
        with self.lock:
            if self.users == 0:
                switches = self.switches()
                self.saved = [(holder, name, getattr(holder, name))
                              for holder, name, _ in switches]
                for holder, name, value in switches:
                    setattr(holder, name, value)
            self.users += 1
        try:
            yield
        finally:
            with self.lock:
                self.users -= 1
                if self.users == 0:
                    for holder, name, value in self.saved:
                        setattr(holder, name, value)


# cuDNN's candidate engines timed at a conv key's first call inside
# measured_conv_engines: the fewest that reach implicit GEMM where the
# heuristic ranks FFT first at 192 x 256; torch's default of 10 costs ~20 s
# of search a batch shape on an H100 against ~1.5 s (PERF.md section 6)
CONV_SEARCH_LIMIT = 2


def conv_search_switches():
    """(holder, attribute, value) of the cuDNN switches inside
    ``eval.device.measured_conv_engines``: time the candidate engines at
    each conv key's first call and keep the fastest (``benchmark``), at
    most :data:`CONV_SEARCH_LIMIT` of them, among the deterministic
    engines only, so that reruns in one process stay bitwise."""
    cudnn = torch.backends.cudnn
    return [(cudnn, "benchmark", True),
            (cudnn, "benchmark_limit", CONV_SEARCH_LIMIT),
            (cudnn, "deterministic", True)]


class _ConvSearch(_HeldSwitches):
    """The switches of :func:`conv_search_switches` and, for each thread,
    the conv keys it has run inside them: cuDNN keeps its measured choice
    per key and per thread (torch's cache of execution plans is
    thread-local), so a thread's first call of a key searches again."""

    def __init__(self):
        super().__init__(conv_search_switches)
        self.local = threading.local()

    def is_new(self, x, weight, stride, padding, transposed) -> bool | None:
        """None outside the block; inside it whether this thread has not
        run this conv's key (the op, the input's and the kernel's shapes
        and strides, stride, padding, dtype, device) before: a search by
        cuDNN."""
        if not self.users:
            return None
        seen = getattr(self.local, "seen", None)
        if seen is None:
            seen = self.local.seen = set()
        key = (transposed, tuple(x.shape), x.stride(), tuple(weight.shape),
               weight.stride(), stride, padding, x.dtype, x.device)
        new = key not in seen
        seen.add(key)
        return new


CONV_SEARCH = _ConvSearch()
