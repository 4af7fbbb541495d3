"""cuDNN's conv engines chosen by measurement in the f32 eval forwards
(``eval.device.measured_conv_engines``).

On the CPU: the direct eval's forwards of an f32 model run with cuDNN's
search switches on, the caller's come back after a return, after a failing
forward and after overlapping users; the train loop, a grad-enabled forward
in train mode and bf16 and int8 models keep the caller's; the counters
``conv.measured`` and ``conv.new_shapes`` read exactly on a tiny U-Net and
a tiny TransUNet, with no new shape on the second call. On the card, at
the benchmark cells' MC batch shapes: an MC20 eval under the measured
choice against the heuristic's within the cells' ``correct`` limits
(``benchmark/limits``), the fused epilogue's counts, no search on a second
subject, and byte-identical CSVs on a rerun. The card tests carry the
``cuda`` marker and skip without one. This file imports neither JAX nor
the JAX package, so the card's machine runs it as it is::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_search.py -m cuda
"""
import os
import threading

import pytest
import torch
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode

from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval import device as eval_device
from rcu_tpu_torch.eval.direct import evaluate_subjects
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.utils import profiling

PARAMS = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
              dropout=0.2)
CALLER = (False, 7, False)  # the caller's benchmark, limit, deterministic
SEARCH = (True, eval_device.CONV_SEARCH_LIMIT, True)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def search_flags():
    cudnn = torch.backends.cudnn
    return (cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic)


@pytest.fixture
def caller_flags():
    """cuDNN's search switches set to :data:`CALLER` for the test and put
    back as they were after it."""
    cudnn = torch.backends.cudnn
    saved = search_flags()
    cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic = CALLER
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit, cudnn.deterministic = saved


@pytest.fixture
def fresh_keys(monkeypatch):
    """No conv key seen yet by any thread (other tests of the worker may
    have run the same shapes)."""
    monkeypatch.setattr(eval_device.CONV_SEARCH, "local", threading.local())


class Recorder(torch.nn.Module):
    """A U-Net in eval mode whose forward records cuDNN's search switches,
    and raises after recording when ``fail``."""

    def __init__(self, fail=False, **record):
        super().__init__()
        self.inner = get_model("unet", {**PARAMS, **record})
        self.dtype = self.inner.dtype
        self.quant_scales = self.inner.quant_scales
        self.fail = fail
        self.seen = []
        self.eval()

    def forward(self, x, generators=None):
        self.seen.append(search_flags())
        if self.fail:
            raise RuntimeError("forward failed")
        return self.inner(x) if generators is None else self.inner(x,
                                                                    generators)


def run_direct(model, out_dir, mc=2, **kw):
    from tests.test_torch_cuda import TinyVolumes
    return evaluate_subjects(model, TinyVolumes((2, 8, 8)), str(out_dir),
                             mc=mc, batch_size=2, masked=False, device="cpu",
                             **kw)


def cpu_mesh():
    from rcu_tpu_torch.parallel import make_mesh
    return make_mesh(n_devices=2, device="cpu")


@pytest.mark.parametrize("fail,mesh", [(False, False), (True, False),
                                       (False, True)],
                         ids=["one_device", "failing", "throughput_mesh"])
def test_direct_eval_measures_conv_engines_and_restores(caller_flags,
                                                        tmp_path, fail, mesh):
    """Inside ``evaluate_subjects`` an f32 model's forwards run with the
    search on, its limit set and deterministic engines only, on one
    device and on a throughput mesh (whose items the caller's thread
    dispatches); the caller's switches come back after the call, also
    when a forward raises."""
    model = Recorder(fail)
    kw = {"mesh": cpu_mesh(), "subject_parallel": True} if mesh else {}
    if fail:
        with pytest.raises(RuntimeError, match="forward failed"):
            run_direct(model, tmp_path, **kw)
    else:
        run_direct(model, tmp_path, **kw)
    assert model.seen and set(model.seen) == {SEARCH}
    assert search_flags() == CALLER


def test_search_stays_on_while_any_thread_is_inside(caller_flags):
    """Overlapping blocks of two threads: the switches stay set until the
    last one leaves, which restores the caller's."""
    model = get_model("unet", PARAMS)
    entered, release = threading.Event(), threading.Event()

    def other():
        with eval_device.measured_conv_engines(model):
            entered.set()
            release.wait(5)

    thread = threading.Thread(target=other)
    try:
        thread.start()
        assert entered.wait(5)
        with eval_device.measured_conv_engines(model):
            assert search_flags() == SEARCH
        assert search_flags() == SEARCH  # the other block is open
        release.set()
        thread.join(5)
        assert not thread.is_alive()
        assert search_flags() == CALLER
    finally:
        release.set()


def tiny_train_loop(tmp_path, hook):
    """A TrainLoop of one epoch over two seeded 8-slice subjects (the
    benchmark's in-memory data and the program's slice loader), no
    validation."""
    from benchmark import inputs
    from rcu_tpu_torch.data import indexing
    from rcu_tpu_torch.data.loader import SliceBatchLoader
    from rcu_tpu_torch.engine import config as cfg_lib, databuild
    from rcu_tpu_torch.engine.train import TrainLoop
    volumes = inputs.brats_volumes(2, (8, 16, 16), 4, 5, torch.device("cpu"))
    pool = inputs.VolumePool(volumes, ["a", "b"])
    config = cfg_lib.TrainConfiguration.from_dict({
        "train_name": "search", "train_dir": str(tmp_path), "seed": 5,
        "epochs": 1, "valid_every_nth": 2, "model": {"unet": PARAMS},
        "optimizer": {"adam": {"lr": 1e-4}},
        "train_data": {"batch_size": 4, "shuffle": True}})
    loop = TrainLoop(config, hooks=[hook], device="cpu")
    slicing = indexing.SliceIndexing()
    selected = indexing.select_indices(pool, slicing,
                                       indexing.NoneBlackSelection(),
                                       ("images",))
    loader = SliceBatchLoader(pool, selected, batch_size=4,
                              categories=("images", "labels"), seed=5,
                              indexing=slicing)

    def load_data():
        loop.train_data = databuild.Data(pool, loader, len(loader))
    loop.load_data = load_data
    return loop


class StepFlags:
    """A train-loop hook that records the switches at each step's end."""

    def __init__(self):
        self.seen = []

    def on_training_batch_end(self, *args):
        self.seen.append(search_flags())

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args, **kwargs: None
        raise AttributeError(name)


def keeps_heuristic(case, tmp_path):
    """Run ``case``'s path; -> the switches its forwards saw."""
    if case == "train_loop":
        hook = StepFlags()
        tiny_train_loop(tmp_path, hook).run()
        return hook.seen
    if case == "grad":
        # a training forward and backward asks for the scope itself
        model = Recorder().train()
        with eval_device.full_float32(), \
                eval_device.measured_conv_engines(model):
            model(torch.rand(2, 4, 8, 8)).logits.sum().backward()
        return model.seen
    if case == "latency_mesh":
        # its parts run in threads started for each call
        model = Recorder()
        run_direct(model, tmp_path, mesh=cpu_mesh())
        return model.seen
    model = Recorder(dtype="bfloat16")
    run_direct(model, tmp_path)
    return model.seen


@pytest.mark.parametrize("case", ["train_loop", "grad", "bf16",
                                  "latency_mesh"])
def test_paths_that_keep_the_heuristic(caller_flags, fresh_keys, tmp_path,
                                       case):
    """The train loop's block, a grad-enabled forward in train mode, a bf16
    model's direct eval and an f32 one on a latency mesh run under the
    caller's switches and count no measured conv."""
    profiling.clear()
    with torch.profiler.profile():
        seen = keeps_heuristic(case, tmp_path)
    assert seen and set(seen) == {CALLER}
    counts = profiling.counters()
    assert counts.get("conv.measured", 0) == 0
    assert counts.get("conv.new_shapes", 0) == 0
    assert search_flags() == CALLER


def quantized(model):
    model.quant_scales = {}
    return model


@pytest.mark.parametrize("models,want", [
    (lambda: get_model("unet", PARAMS), True),
    (lambda: [get_model("unet", PARAMS), get_model("unet", PARAMS)], True),
    (lambda: (get_model("unet", {**PARAMS, "provide_features": True}),
              get_model("postnet", {"nb_classes": 2, "in_channels": 4})),
     True),
    (lambda: get_model("unet", PARAMS).train(), False),
    (lambda: get_model("unet", {**PARAMS, "dtype": "bfloat16"}), False),
    (lambda: quantized(get_model("unet", PARAMS)), False),
    (lambda: (get_model("unet", {**PARAMS, "dtype": "bfloat16"}),
              get_model("postnet", {"nb_classes": 2, "in_channels": 4})),
     False),
    (lambda: [], False),
    (lambda: None, False),
], ids=["unet", "members", "pair", "train_mode", "bf16", "int8",
        "bf16_pair", "no_members", "none"])
def test_which_models_take_the_measured_choice(models, want):
    """The f32 eval forwards: every model float32, in eval mode, with no
    int8 site."""
    assert eval_device.float32_eval(models()) is want


class ConvCalls(TorchFunctionMode):
    """The convs torch runs, and their distinct (op, input shape, kernel
    shape, stride, padding)."""

    def __init__(self):
        super().__init__()
        self.calls, self.keys = 0, set()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (F.conv2d, F.conv_transpose2d):
            self.calls += 1
            stride = args[3] if len(args) > 3 else kwargs.get("stride", 1)
            padding = args[4] if len(args) > 4 else kwargs.get("padding", 0)
            self.keys.add((func, tuple(args[0].shape), tuple(args[1].shape),
                           str(stride), str(padding)))
        return func(*args, **kwargs)


def mc_counts(model, x, stream):
    """``mc_forward`` of 3 samples under the scope and a profiler -> (the
    counters, the convs torch ran)."""
    profiling.clear()
    calls = ConvCalls()
    with eval_device.full_float32(), \
            eval_device.measured_conv_engines(model), \
            torch.inference_mode(), torch.profiler.profile(), calls:
        steps.mc_forward(model, x.permute(0, 2, 3, 1),
                         steps.batch_generators(stream, 3, x.device))
    return profiling.counters(), calls


def tiny_transunet():
    from tests.test_torch_transunet import TINY
    return get_model("transunet", TINY)


@pytest.mark.parametrize("kind,make,shape,calls,keys", [
    # the depth-2 U-Net's 14 convs (11 ConvBnRelu, 2 up-convs, the class
    # conv) over 8 keys: 3 at 16 x 16 (4 -> 4, the input's 4 channels
    # being the first block's width, 8 -> 4, the 1x1 4 -> 2), 3 at 8 x 8,
    # 2 at 4 x 4
    ("unet", lambda: get_model("unet", PARAMS), (2, 4, 16, 16), 14, 8),
    ("transunet", tiny_transunet, (2, 4, 32, 32), None, None),
])
def test_counters_read_every_conv_and_each_new_key_once(fresh_keys, kind,
                                                        make, shape, calls,
                                                        keys):
    """``conv.measured`` counts every conv call under the scope (each conv
    module once a forward: the trunk once a batch, the rest once for the
    T samples riding it), ``conv.new_shapes`` each key the first time;
    the second call searches nothing."""
    model = make()
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    first, ran = mc_counts(model, x, (7, 0))
    convs = sum(isinstance(m, torch.nn.Conv2d) for m in model.modules())
    assert first["conv.measured"] == ran.calls == convs
    assert first["conv.new_shapes"] == len(ran.keys)
    if calls is not None:
        assert (ran.calls, len(ran.keys)) == (calls, keys)
    second, ran_again = mc_counts(model, x, (7, 1))
    assert second["conv.measured"] == ran_again.calls == convs
    assert second.get("conv.new_shapes", 0) == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (cuDNN's engines exist only there)")
    return torch.device("cuda")


@pytest.fixture
def bench_cell(card):
    """-> a function: the benchmark's eval cell ``name`` (its seeded
    weights, the program's model and items, its ``correct`` limits) on
    the card; its scratch directories go after the test."""
    from benchmark import harness
    from benchmark.drivers.direct_eval import EvalCell
    spec = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    runs = []

    def make(name):
        run = harness.Run(ROOT, spec, name, seed=2 ** 31 + 2117, seconds=1,
                          trace_on=False, device=card, started_at=0.0)
        runs.append(run)
        return EvalCell(run)
    yield make
    for run in runs:
        run.close()


def call(cell, n_items, tag, monkeypatch, measured=True):
    """The cell's ``evaluate_subjects`` over its first ``n_items`` items,
    with the measured choice or the heuristic's -> its rows."""
    with monkeypatch.context() as patch:
        if not measured:
            patch.setattr(eval_device, "float32_eval", lambda models: False)
        return cell.call(n_items, tag)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["isic_mc20_f32", "brats_mc20_f32"])
def test_cuda_measured_choice_within_the_cells_limits(bench_cell, monkeypatch,
                                                      name):
    """One item of the cell (an ISIC chunk: a 640-row MC batch; a BraTS
    subject: four of 640 rows and one of 540) with the heuristic's engines
    and with the measured ones: their rows lie within the cell's
    ``correct`` limits of each other."""
    from benchmark import compare
    cell = bench_cell(name)
    rows = {measured: cell.rows(call(cell, 1, f"measured_{measured}",
                                     monkeypatch, measured))
            for measured in (False, True)}
    gaps = compare.eval_gaps(rows[True], rows[False])
    limits = cell.run.limits
    assert gaps["ece_gap"] <= limits["ece_gap"], gaps
    assert gaps["count_gap"] <= limits["count_gap"], gaps


def same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


@pytest.mark.cuda
@pytest.mark.parametrize("name,batches", [("isic_mc20_f32", 1),
                                          ("brats_mc20_f32", 5)])
def test_cuda_second_item_searches_nothing_and_reruns_bitwise(
        bench_cell, monkeypatch, name, batches):
    """After a first item, two more under a profiler: no new conv key, 24
    convs and 19 fused epilogues a forward batch (``batches`` an item), no
    eager epilogue; the same two again give byte-identical CSVs."""
    cell = bench_cell(name)
    call(cell, 1, "first", monkeypatch)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        second = call(cell, 2, "second", monkeypatch)
    counts = profiling.counters()
    assert counts.get("conv.new_shapes", 0) == 0
    assert counts["conv.measured"] == 24 * batches * 2
    assert counts["unet.epilogue_fused"] == 19 * batches * 2
    assert counts.get("unet.epilogue_eager", 0) == 0
    same_files(second, call(cell, 2, "again", monkeypatch))


def test_each_thread_counts_its_own_search(fresh_keys):
    """cuDNN keeps its measured choice per thread: a key that one thread
    has run is new to another."""
    model = get_model("unet", PARAMS)
    x, w = torch.rand(1, 2, 6, 6), torch.rand(3, 2, 3, 3)
    profiling.clear()
    with eval_device.measured_conv_engines(model), torch.profiler.profile():
        from rcu_tpu_torch.models.unet import conv2d
        conv2d(x, w, padding=1)
        conv2d(x, w, padding=1)
        thread = threading.Thread(target=conv2d, args=(x, w),
                                  kwargs={"padding": 1})
        thread.start()
        thread.join(5)
        assert not thread.is_alive()
    counts = profiling.counters()
    assert (counts["conv.measured"], counts["conv.new_shapes"]) == (3, 2)
