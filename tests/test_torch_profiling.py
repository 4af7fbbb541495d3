"""``rcu_tpu_torch.utils.profiling`` on the CPU: ``trace`` and
``ProfilerHook`` write a Chrome trace (the hook only for its steps, and
also when the epoch ends before ``stop_step``), and the two measurers
return a finite positive rate at a small size (the numbers mean something
only on the card) and refuse a 1-device ring. The spans and counters are
``tests/test_torch_tracing.py``'s."""
import glob
import json
import math
import os

import pytest
import torch

from rcu_tpu_torch.parallel import make_mesh
from rcu_tpu_torch.utils import profiling


def traces(log_dir):
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")))


def some_work():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    return (a @ a).sum()


def op_names(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {e.get("name") for e in events}


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        some_work()
    path, = traces(str(tmp_path))
    assert "aten::mm" in op_names(path)


@pytest.mark.parametrize("nb_batches,stopped_at", [(8, "batch"), (3, "end")])
def test_profiler_hook_traces_its_steps(tmp_path, nb_batches, stopped_at):
    """Steps 2-4 of the first epoch (start 2, stop 5); an epoch of 3 steps
    ends the trace at ``on_training_end``. Later epochs trace nothing, and
    the other hook calls are no-ops."""
    hook = profiling.ProfilerHook(str(tmp_path), start_step=2, stop_step=5)
    hook.on_startup(None)
    for epoch in range(2):
        for i in range(nb_batches):
            some_work()
            hook.on_training_batch_end(None, epoch, i, nb_batches, {})
            active = hook._prof is not None
            assert active == (epoch == 0 and 1 <= i < min(4, nb_batches)), \
                (epoch, i)
        hook.on_training_end(None, epoch, {})
        assert hook._prof is None
        assert len(traces(str(tmp_path))) == 1
    hook.on_termination(None)
    assert len(traces(str(tmp_path))) == 1


def test_profiler_hook_ends_at_termination(tmp_path):
    hook = profiling.ProfilerHook(str(tmp_path), start_step=1, stop_step=5)
    hook.on_training_batch_end(None, 0, 0, 10, {})
    assert hook._prof is not None and not traces(str(tmp_path))
    hook.on_termination(None)
    assert hook._prof is None and len(traces(str(tmp_path))) == 1


def test_measurers_give_a_rate_on_the_cpu():
    hbm = profiling.measure_practical_hbm(n_elems=1 << 16, steps=4, rounds=2,
                                          device="cpu")
    ici = profiling.measure_practical_ici(
        make_mesh(n_devices=2, device="cpu"), n_elems=1 << 16, steps=4,
        rounds=2)
    assert math.isfinite(hbm) and hbm > 0
    assert math.isfinite(ici) and ici > 0
    with pytest.raises(ValueError, match="ring needs"):
        profiling.measure_practical_ici(make_mesh(n_devices=1, device="cpu"))
