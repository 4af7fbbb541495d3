"""The program's spans and counters (``rcu_tpu_torch.utils.profiling``) on
the CPU: they record only while a torch profiler runs; they nest and
carry their item across threads, on the profiler's clock; the record's
bound drops and counts; the direct eval and the train loop record one
read, wait and step span an item or step; ``trace`` writes another
thread's spans into its Chrome trace; and the benchmark's three readers
of them, on synthetic records and where they must say nothing."""
import importlib.util
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rcu_tpu_torch.data.loader import SliceBatchLoader
from rcu_tpu_torch.data.indexing import SliceIndexing
from rcu_tpu_torch.engine import config as cfg_lib
from rcu_tpu_torch.engine import databuild
from rcu_tpu_torch.engine.train import TrainLoop
from rcu_tpu_torch.eval.direct import evaluate_subjects
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = {"nb_classes": 2, "in_channels": 2, "depth": 2, "start_filters": 4,
        "dropout": 0.2}
SHAPE = (5, 16, 16)  # slices, H, W


@pytest.fixture(autouse=True)
def fresh_record():
    profiling.clear()
    yield
    profiling.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def named(name):
    return [s for s in profiling.spans() if s.name == name]


class Volumes:
    """``n`` subjects of SHAPE with two channels, a blob in channel 0."""

    def __init__(self, n=2, seed=0):
        rng = np.random.RandomState(seed)
        self.subjects = [f"s{i}" for i in range(n)]
        self.data = {}
        for s in self.subjects:
            labels = np.zeros(SHAPE, np.uint8)
            labels[:, 4:11, 5:12] = 1
            images = rng.randn(*SHAPE, 2).astype(np.float32) * 0.5
            images[..., 0] += labels
            self.data[s] = {"images": images, "labels": labels}

    def read_volume(self, subject, category):
        return self.data[subject][category]

    def read_slice(self, subject, index, category):
        return self.data[subject][category][index]

    def shape(self, subject, category="images"):
        return self.data[subject][category].shape

    def files(self, subject):
        return {}


def test_nothing_is_recorded_without_a_profiler():
    with profiling.span("direct.read", 0):
        with profiling.span("direct.decode"):
            profiling.count("eval.voxels", 10)
    assert profiling.spans() == [] and profiling.counters() == {}


def test_spans_nest_and_share_their_item_across_threads():
    def reader():
        with profiling.span("direct.read", 3):
            with profiling.span("direct.decode"):
                profiling.count("eval.voxels", 7)

    with cpu_profile():
        with profiling.span("direct.dispatch", 3):
            with profiling.span("direct.copy_in"):
                torch.ones(4).add_(1)
            thread = threading.Thread(target=reader)
            thread.start()
            thread.join(timeout=30)
        profiling.count("eval.voxels", 5)
    assert not thread.is_alive()
    by_name = {s.name: s for s in profiling.spans()}
    assert set(by_name) == {"direct.dispatch", "direct.copy_in",
                            "direct.read", "direct.decode"}
    assert by_name["direct.copy_in"].parent == "direct.dispatch"
    assert by_name["direct.decode"].parent == "direct.read"
    assert by_name["direct.dispatch"].parent is None
    assert {s.item for s in by_name.values()} == {3}
    assert by_name["direct.read"].thread == by_name["direct.decode"].thread \
        != by_name["direct.dispatch"].thread
    for s in by_name.values():
        assert s.start_ns <= s.end_ns
    outer, inner = by_name["direct.dispatch"], by_name["direct.read"]
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert profiling.counters() == {"eval.voxels": 12}
    with cpu_profile():  # only trace() and ProfilerHook clear the record
        pass
    assert len(profiling.spans()) == 4


def test_a_span_lies_on_the_profilers_clock():
    """On the profiling thread a span is also a profiler event: its start
    lies within 50 us of the event's (the best of 5, past a warm-up)."""
    with cpu_profile() as prof:
        for k in range(6):
            with profiling.span(f"clock.{k}"):
                torch.ones(8).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("clock.")}
    gaps = [abs(s.start_ns - events[s.name].start_ns())
            for s in profiling.spans() if s.name != "clock.0"]
    assert len(gaps) == 5 and min(gaps) < 50_000, gaps
    assert all(abs(s.end_ns - events[s.name].end_ns()) < 1_000_000_000
               for s in profiling.spans())


def test_the_bound_drops_spans_and_counts_the_drops(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with cpu_profile():
        for k in range(5):
            with profiling.span("loader.read", k):
                pass
    assert [s.item for s in profiling.spans()] == [0, 1, 2]
    assert profiling.counters() == {"spans.dropped": 2}
    profiling.clear()
    assert profiling.spans() == [] and profiling.counters() == {}


def test_a_profiler_stopped_inside_a_span_leaves_it_whole():
    prof = cpu_profile()
    prof.start()
    with profiling.span("train.hooks", 4):
        prof.stop()
    with profiling.span("train.hooks", 5):
        pass
    assert [(s.name, s.item) for s in profiling.spans()] == \
        [("train.hooks", 4)]


def test_direct_eval_records_a_read_and_a_wait_an_item(tmp_path):
    torch.manual_seed(1)
    model = get_model("unet", UNET).eval()
    dataset = Volumes()
    with cpu_profile():
        evaluate_subjects(model, dataset, str(tmp_path), strategy="mc", mc=2,
                          batch_size=4, seed=3, masked=False, device="cpu")
    for name in ("direct.read", "direct.wait_read", "direct.dispatch",
                 "direct.fetch"):
        assert sorted(s.item for s in named(name)) == [0, 1], name
    reads = {s.item: s for s in named("direct.read")}
    for child in ("direct.decode", "direct.mask", "direct.host_tensors"):
        spans = named(child)
        assert sorted(s.item for s in spans) == [0, 1], child
        for s in spans:
            assert s.thread == reads[s.item].thread
    for child, parent in (("direct.copy_in", "direct.dispatch"),
                          ("direct.fetch_wait", "direct.fetch")):
        assert [s.parent for s in named(child)] == [parent] * 2
    assert {s.parent for s in named("pipeline.mc_forward")} == \
        {"direct.dispatch"}
    assert len(named("pipeline.mc_forward")) == 2 * 2  # 2 batches a subject
    assert len(named("evalstats.launch")) == 2
    # a row a subject and the run's finish
    assert [s.item for s in named("direct.sink")] == [0, 1, None]
    counts = profiling.counters()
    assert counts == {"eval.items": 2, "eval.voxels": 2 * int(np.prod(SHAPE))}


def test_train_epoch_records_a_feed_wait_and_a_step_a_step(tmp_path):
    """A step, feed wait and copy a batch; the feed's last wait finds the
    loader's end."""
    dataset = Volumes(n=3)
    indices = [(s, z) for s in range(3) for z in range(SHAPE[0])]
    loader = SliceBatchLoader(dataset, indices, batch_size=4, shuffle=True,
                              seed=2, indexing=SliceIndexing())
    config = cfg_lib.TrainConfiguration.from_dict({
        "train_name": "trace", "train_dir": str(tmp_path), "seed": 2,
        "epochs": 1, "model": {"unet": UNET},
        "optimizer": {"adam": {"lr": 1e-4}},
        "train_data": {"batch_size": 4, "shuffle": True}})
    loop = TrainLoop(config, hooks=[], device="cpu")
    loop.train_data = databuild.Data(dataset, loader, len(loader))
    loop.init_state()
    with cpu_profile():
        loop._train_epoch(0)
    steps = list(range(len(loader)))
    assert len(steps) == 4
    for name in ("train.copy_in", "train.step", "train.hooks"):
        assert [s.item for s in named(name)] == steps, name
    assert [(s.parent, s.item) for s in named("train.optimizer")] == \
        [("train.step", k) for k in steps]
    # the reader reads every batch and once more finds the loader's end;
    # the loop waits for each, the end too
    for name in ("loader.read", "train.feed_wait"):
        assert [s.item for s in named(name)] == steps + [len(steps)], name
    assert len(named("train.epoch_end")) == 1
    assert profiling.counters() == {"train.steps": len(steps)}


def test_trace_writes_another_threads_spans_into_its_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "before")):
        with profiling.span("stale"):
            pass

    def feed():
        with profiling.span("loader.read", 0):
            time.sleep(0.002)

    with profiling.trace(str(tmp_path / "trace")):
        assert profiling.spans() == []  # cleared as the trace starts
        thread = threading.Thread(target=feed, name="feed")
        thread.start()
        thread.join(timeout=30)
        with profiling.span("train.feed_wait", 0):
            torch.ones(4).add_(1)
    assert not thread.is_alive()
    (name,) = os.listdir(tmp_path / "trace")
    assert name.endswith(".pt.trace.json")
    with open(tmp_path / "trace" / name) as f:
        chrome = json.load(f)
    events = chrome["traceEvents"]
    read, = named("loader.read")
    written = [e for e in events if e.get("name") == "loader.read"]
    assert len(written) == 1 and written[0]["tid"] == read.thread
    assert written[0]["args"] == {"item": 0, "parent": None}
    base = chrome.get("baseTimeNanoseconds", 0)
    assert written[0]["ts"] == pytest.approx((read.start_ns - base) / 1e3,
                                             abs=1.0)
    assert written[0]["dur"] >= 2000
    assert {"ph": "M", "name": "thread_name", "pid": os.getpid(),
            "tid": read.thread, "args": {"name": "feed"}} in events
    # the profiling thread's span is the profiler's own event, once, an op
    # and not a user annotation (which a card's trace also draws on the
    # device's timeline)
    wait, = [e for e in events if e.get("name") == "train.feed_wait"]
    assert wait["cat"] != "user_annotation"


def load_reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "reader_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def span(name, seconds, item=0):
    return profiling.Span(name, 10**9, 10**9 + int(seconds * 1e9), 1, None,
                          item)


EVAL = {"driver": "direct_eval", "window_s": 20.0}
TRAIN = {"driver": "train", "window_s": 20.0}
# reader, record, spans, counters -> the value
SYNTHETIC = [
    ("reader_voxels_per_s.eval", EVAL,
     [span("direct.read", 0.5, 0), span("direct.read", 1.5, 1),
      span("direct.decode", 9.0)], {"eval.voxels": 4_000_000}, 2e6),
    ("read_wait_share.eval", EVAL,
     [span("direct.wait_read", 0.1, 0), span("direct.wait_read", 0.02, 1),
      span("direct.read", 5.0)], {}, 0.6),
    ("feed_wait_share.train", TRAIN,
     [span("train.feed_wait", 0.05, k) for k in range(4)]
     + [span("train.step", 3.0)], {"train.steps": 4}, 1.0),
]


@pytest.mark.parametrize("reader,record,spans,counts,want", SYNTHETIC,
                         ids=[case[0] for case in SYNTHETIC])
def test_reader_on_a_synthetic_record(monkeypatch, reader, record, spans,
                                      counts, want):
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: counts)
    assert load_reader(reader)(record) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("case", ["nothing", "dropped", "driver", "absent"])
@pytest.mark.parametrize("reader,record,spans,counts,want", SYNTHETIC,
                         ids=[case[0] for case in SYNTHETIC])
def test_reader_says_nothing(monkeypatch, case, reader, record, spans,
                             counts, want):
    """None where the program recorded nothing, dropped spans, the cell is
    the other driver's, or the program keeps no record (a version without
    spans)."""
    if case == "nothing":
        spans, counts = [], {}
    elif case == "dropped":
        counts = {**counts, "spans.dropped": 1}
    elif case == "driver":
        record = TRAIN if record is EVAL else EVAL
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: counts)
    if case == "absent":
        monkeypatch.delattr(profiling, "spans")
    assert load_reader(reader)(record) is None
