"""The train-mode epilogue of ``ConvBnRelu``: the plain version of
``ops/cuda/trainepilogue`` against autograd of the module's eager chain
(forward, running statistics, the gradients of the conv output, the conv
bias and the BatchNorm's weights) in float64 and float32, the rule that
picks the kernels, the wrapper's refusals (CPU tensors among them), and on
the card the kernels against their plain version and float64 at the shapes
of the benchmark's train cell. The card tests carry the ``cuda`` marker and
skip without one. This file imports neither JAX nor the JAX package, so the
card's machine runs it as it is::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_train_epilogue.py -m cuda
"""
import copy
import ctypes
import math

import pytest
import torch

from rcu_tpu_torch.engine import remat
from rcu_tpu_torch.models import get_model, unet
from rcu_tpu_torch.models.unet import ConvBnRelu
from rcu_tpu_torch.ops.cuda import trainepilogue
from rcu_tpu_torch.ops.cuda.trainepilogue import (train_epilogue,
                                                  train_epilogue_reference)
from rcu_tpu_torch.parallel.mesh import run_parts

EPS = {torch.float64: 2.0 ** -52, torch.float32: 2.0 ** -23}


def random_site(cout, dropout, relu, dtype, seed=0, kernel=3, bias=True):
    """A train-mode ConvBnRelu whose conv bias and BatchNorm weights are
    away from their defaults (negative scales too)."""
    g = torch.Generator().manual_seed(seed)
    layer = ConvBnRelu(3, cout, dropout, kernel=kernel, activation=relu,
                       bias=bias).to(dtype).train()

    def draw(lo, hi):
        return (lo + (hi - lo) * torch.rand(cout, generator=g)).to(dtype)

    with torch.no_grad():
        if bias:
            layer.Conv_0.bias.copy_(draw(-1.0, 1.0))
        bn = layer.BatchNorm_0
        bn.weight.copy_(draw(-2.0, 2.0))
        bn.bias.copy_(draw(-1.0, 1.0))
        bn.running_mean.copy_(draw(-1.0, 1.0))
        bn.running_var.copy_(draw(0.5, 2.0))
    return layer


def site_bias(layer):
    return layer.zero_bias if layer.Conv_0.bias is None else layer.Conv_0.bias


def clamped_channel(c, bias, channel=0):
    """Set ``c``'s ``channel`` to a large value plus a spread far below its
    ulp, so that flax's fast variance (:func:`trainepilogue.batch_constants`
    on the sums the eager chain takes) cancels to rounding noise; the
    first of a few draws whose variance rounds below 0 (clamped to 0).
    The channel's z - mean is then a few ulps of the large value, not 0,
    so the dropped variance term would show in its gradient."""
    n = c.numel() // c.shape[1]
    big, spread = (1e3, 1e-4) if c.dtype == torch.float32 else (1e8, 3e-8)
    bn = torch.nn.BatchNorm2d(c.shape[1]).to(c.dtype)
    g = torch.Generator().manual_seed(4)
    for _ in range(200):
        noise = torch.randn(c[:, channel].shape, generator=g).to(c.dtype)
        with torch.no_grad():
            c[:, channel] = big + spread * noise
            z = c + bias.detach()[:, None, None]
            inner = trainepilogue.batch_constants(
                z.sum((0, 2, 3)), (z * z).sum((0, 2, 3)), n, bn)[1]
        if inner[channel] < 0:
            return
    raise AssertionError("no draw clamps the variance")


def eager_and_plain(shape, dropout, relu, dtype, clamp=False, kernel=3,
                    bias=True, seed=0):
    """The eager chain (``ConvBnRelu.epilogue`` in train mode on the conv
    output with its bias, ``c + bias``) and the plain version on the
    bias-free ``c``, each with its own copy of the site's BatchNorm:
    (outputs, gradients of c, bias, weight and shift of a random
    cotangent's product, running statistics, the dropout divisor)."""
    n, cout, h, w = shape
    layer = random_site(cout, dropout, relu, dtype, seed, kernel, bias)
    plain_bn = copy.deepcopy(layer.BatchNorm_0)
    g = torch.Generator().manual_seed(seed + 1)
    c = torch.randn(shape, generator=g).to(dtype)
    b = site_bias(layer)
    if clamp:
        clamped_channel(c, b)
    c.requires_grad_(True)
    cotangent = torch.randn(shape, generator=g).to(dtype)
    gens = [torch.Generator().manual_seed(seed + 2)]
    eager_y = layer.epilogue(c + b[:, None, None], gens)
    bn = layer.BatchNorm_0
    wrt = [c, bn.weight, bn.bias] + ([b] if bias else [])
    eager_g = torch.autograd.grad((eager_y * cotangent).sum(), wrt)
    divisor = None if dropout is None else layer.dropout.divisor(
        c, [torch.Generator().manual_seed(seed + 2)])
    y = train_epilogue_reference(c, b, divisor, plain_bn, relu)
    wrt = [c, plain_bn.weight, plain_bn.bias] + ([b] if bias else [])
    plain_g = torch.autograd.grad((y * cotangent).sum(), wrt)
    stats = [(bn.running_mean, plain_bn.running_mean),
             (bn.running_var, plain_bn.running_var)]
    return (eager_y, y), list(zip(eager_g, plain_g)), stats, divisor


SHAPES = [(3, 5, 15, 15), (4, 6, 7, 9), (5, 4, 1, 1), (2, 3, 12, 16)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("dropout", [None, 0.5], ids=["nodrop", "drop"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_version_matches_the_eager_chain(shape, dropout, relu, dtype):
    """Forward and running statistics bitwise (the same torch ops, the same
    sums), and each gradient within a few ulps of its scale: the plain
    version takes the analytic gradient, autograd adds the paths through
    the mean, the variance and the affine weights one by one. The conv
    bias's gradient is a sum of terms that cancel (to 0 without dropout:
    the BatchNorm removes any per-channel shift), so its scale is that of
    its M = N * H * W terms, each held to the conv output gradient's
    scale, not its value."""
    kernel = 1 if shape[2:] == (1, 1) else 3  # a PostNet's 1x1 site
    (eager_y, y), grads, stats, divisor = eager_and_plain(
        shape, dropout, relu, dtype, kernel=kernel)
    assert torch.equal(eager_y, y)
    for want, got in stats:
        assert torch.equal(want, got)
    if dropout:
        assert torch.isinf(divisor).any() and not torch.isinf(divisor).all()
    (dc, dc_ref), (dw, dw_ref), (ds, ds_ref), (db, db_ref) = grads
    eps = EPS[dtype]
    # the elements of each gradient carry a handful of roundings each, the
    # (C)-sized sums one a term: 64 eps of their scale leaves room for both
    for want, got in ((dc, dc_ref), (dw, dw_ref), (ds, ds_ref)):
        assert float((want - got).abs().max()) <= \
            64 * eps * float(want.abs().max()), (want, got)
    terms = dc.numel() // dc.shape[1] * float(dc.abs().max())
    assert float((db - db_ref).abs().max()) <= 64 * eps * terms


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_plain_version_drops_the_variance_term_where_it_clamps(dtype, relu):
    """A channel of one constant value: flax's fast variance rounds below 0
    and clamps to 0, and clamp_min passes no gradient there; the plain
    version drops the variance term in that channel alone."""
    (eager_y, y), grads, stats, _ = eager_and_plain(
        (4, 3, 6, 6), None, relu, dtype, clamp=True, seed=3)
    assert torch.equal(eager_y, y)
    for want, got in stats:
        assert torch.equal(want, got)
    eps = EPS[dtype]
    (dc, dc_ref), (dw, dw_ref), (ds, ds_ref) = grads[:3]
    # per channel: the clamped one's gradient is ~rsqrt(eps) times the
    # others'
    scale = dc.abs().amax((0, 2, 3))[:, None, None]
    assert bool(((dc - dc_ref).abs() <= 64 * eps * scale).all())
    for want, got in ((dw, dw_ref), (ds, ds_ref)):
        assert bool(((want - got).abs() <= 64 * eps * want.abs()).all())


def test_plain_version_without_a_conv_bias():
    """A site built without a bias (TransUNet's decoder) adds its zero
    buffer, and its backward returns no gradient for it."""
    layer = random_site(4, 0.3, True, torch.float32, bias=False)
    c = torch.randn(2, 4, 5, 5, requires_grad=True)
    y = train_epilogue_reference(c, layer.zero_bias, None, layer.BatchNorm_0)
    (dc,) = torch.autograd.grad(y.sum(), [c])
    assert dc.shape == c.shape and not layer.zero_bias.requires_grad


class CardTensor:
    """What the dispatch rule reads of a tensor, standing for a CUDA one
    (this machine may have no card)."""

    def __init__(self, dtype=torch.float32, channels_last=False,
                 device="cuda"):
        self.device, self.dtype = torch.device(device), dtype
        self.channels_last = channels_last

    def is_contiguous(self, memory_format=torch.contiguous_format):
        return (memory_format == torch.channels_last) == self.channels_last


@pytest.mark.parametrize("case,want", [
    ("f32 train", True),
    ("split pair", True),
    ("no dropout", True),
    ("cpu", False),
    ("bf16", False),
    ("eval", False),
    ("no_grad", False),
    ("remat conv", False),
    ("remat full", False),
    ("remat full region", False),
    ("mesh part", False),
    ("bn-free", False),
    ("folded", False),
    ("quantized", False),
    ("channels last", False),
    ("f64 parameters", False),
])
def test_only_f32_batchnorm_sites_training_on_a_card_fuse(case, want):
    layer = ConvBnRelu(3, 8, None if case == "no dropout" else 0.1,
                       bn=case != "bn-free", fold_bn=case == "folded")
    layer.train(case != "eval")
    if case == "f64 parameters":  # a float64 model's f32 sigma head
        layer.double()
    x = CardTensor(dtype=torch.bfloat16 if case == "bf16" else torch.float32,
                   channels_last=case == "channels last",
                   device="cpu" if case == "cpu" else "cuda")
    if case == "split pair":
        x = (x, CardTensor())
    if case == "quantized":
        layer.quant_scales = {}
    with torch.set_grad_enabled(case != "no_grad"):
        if case == "remat full region":
            # 'full' runs the model inside one region with no policy set:
            # the forward and the backward's rerun each ask the rule
            seen = []
            out = remat.checkpoint(lambda t: (
                seen.append(layer.fuses_train_epilogue(x)), t * t)[1],
                torch.ones(2, requires_grad=True))
            out.sum().backward()
            assert seen == [want, want]
        elif case.startswith("remat"):
            with remat.using(case.split()[1]):
                assert layer.fuses_train_epilogue(x) is want
        elif case == "mesh part":
            assert run_parts(lambda i: layer.fuses_train_epilogue(x),
                             [torch.device("cpu")], [(0, 2, 2)]) == [want]
        else:
            assert layer.fuses_train_epilogue(x) is want
        assert not (layer.fuses_epilogue(x) and
                    layer.fuses_train_epilogue(x))


def test_cpu_train_steps_never_reach_the_wrapper(monkeypatch):
    """Every CPU site keeps the eager chain: a U-Net's train step, with
    dropout and the sigma head, calls no ``train_epilogue``."""
    def refuse(*args, **kwargs):
        raise AssertionError("train_epilogue called on a CPU site")

    monkeypatch.setattr(unet, "train_epilogue", refuse)
    torch.manual_seed(0)
    model = get_model("unet", dict(nb_classes=2, in_channels=4, depth=2,
                                   start_filters=4, dropout=0.2,
                                   sigma_out=True)).train()
    out = model(torch.randn(4, 4, 16, 16), [torch.Generator().manual_seed(1)])
    out.logits.sum().backward()
    assert model.ConvBlock_0.ConvBnRelu_0.Conv_0.weight.grad is not None


def cpu_args(change=None):
    g = torch.Generator().manual_seed(2)
    bn = torch.nn.BatchNorm2d(6)
    args = dict(c=torch.randn(4, 6, 5, 5, generator=g),
                bias=torch.randn(6, generator=g),
                divisor=torch.full((4, 6), 0.95), bn=bn)
    for name, edit in (change or {}).items():
        args[name] = edit(args[name])
    return args


def _double_bn(bn):
    return copy.deepcopy(bn).double()


@pytest.mark.parametrize("change,error", [
    (dict(c=lambda c: c.double()), TypeError),
    (dict(c=lambda c: c[0]), ValueError),
    (dict(c=lambda c: c.transpose(2, 3)), ValueError),
    (dict(c=lambda c: c[:, :, :0]), ValueError),
    (dict(bias=lambda b: b[:-1]), ValueError),
    (dict(bias=lambda b: b.double()), TypeError),
    (dict(divisor=lambda d: d.t().contiguous()), ValueError),
    (dict(divisor=lambda d: d.to("meta")), ValueError),
    (dict(bn=_double_bn), TypeError),
])
def test_wrapper_refuses_what_the_kernels_do_not_take(change, error):
    args = cpu_args(change)
    with pytest.raises(error):
        trainepilogue._check_cuda_inputs(args["c"], args["bias"],
                                         args["divisor"], args["bn"])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_runs_on_cuda_only(device):
    """A CPU site keeps the module's eager chain: the wrapper takes no CPU
    tensor, and no other device's; the running statistics stay as they
    were."""
    bn = torch.nn.BatchNorm2d(3).to(device)
    with pytest.raises(ValueError, match="runs on cuda"):
        train_epilogue(torch.zeros(2, 3, 4, 4, device=device),
                       torch.zeros(3, device=device), None, bn)
    assert device == "meta" or float(bn.running_var.sum()) == 3.0


def test_launch_arguments_lay_out_as_the_kernels_read_them():
    """``_Args`` is the C struct ``TrainEpilogueArgs``: 18 pointers, three
    int64, a float and an int, 176 bytes on x86-64 and aarch64."""
    assert ctypes.sizeof(trainepilogue._Args) == 18 * 8 + 3 * 8 + 4 + 4
    assert trainepilogue._Args.rows.offset == 18 * 8


class RecordingLibrary:
    """Stands for the built library: records each launch's stage and
    arguments and reports success."""

    def __init__(self):
        self.launches = []

    def rcu_train_epilogue(self, stage, args, stream):
        a = args._obj
        fields = {name: getattr(a, name)
                  for name, _ in trainepilogue._Args._fields_
                  if name != "chan"}
        self.launches.append((stage, fields, list(a.chan), stream))
        return 0


# what the C entry requires of each stage (the others may be null)
REQUIRED = {0: ("c", "bias", "partials", "tickets"),
            1: ("c", "bias", "out", "mean", "mul", "shift"),
            2: ("c", "g", "bias", "mean", "mul", "shift", "rstd", "partials",
                "tickets"),
            3: ("c", "g", "out", "bias", "mean", "mul", "shift", "gamma",
                "rstd", "inner", "sg", "sgz", "partials", "tickets")}


def test_the_wrapper_hands_each_kernel_what_it_reads(monkeypatch):
    """The autograd Function through the kernels' wrapper, with the
    library recorded in place of the card: two launches forward and two
    backward, each stage's required arguments set, the channel results
    (2, 0, 3 and 1 of them) and the tickets after the plane partials, and
    32 bytes an element counted while a profiler runs."""
    import contextlib
    import types

    from torch.profiler import ProfilerActivity, profile

    from rcu_tpu_torch.utils import profiling
    library = RecordingLibrary()
    monkeypatch.setattr(trainepilogue, "_library", lambda: library)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=77))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    n, channels, h, w = 3, 5, 4, 6
    c = torch.randn(n, channels, h, w, requires_grad=True)
    bias = torch.randn(channels, requires_grad=True)
    bn = torch.nn.BatchNorm2d(channels)
    launches = train_epilogue.launches
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.clear()
        y = trainepilogue._Epilogue.apply(c, bias, torch.ones(n, channels),
                                          bn.weight, bn.bias, bn, False,
                                          trainepilogue._Kernels)
        y.sum().backward()
        counts = profiling.counters()
    assert train_epilogue.launches - launches == 4
    assert counts["unet.train_epilogue_bytes"] == 32 * c.numel()
    assert [stage for stage, *_ in library.launches] == [0, 1, 2, 3]
    for stage, fields, chan, stream in library.launches:
        assert stream == 77
        assert all(fields[name] for name in REQUIRED[stage]), (stage, fields)
        assert (fields["rows"], fields["channels"], fields["plane"]) == \
            (n, channels, h * w)
        assert fields["relu"] == 0 and fields["divisor"]
        assert fields["inv_count"] == pytest.approx(1 / (n * h * w))
        results = sum(p is not None for p in chan)
        assert results == (2, 0, 3, 1)[stage]
        if results:
            sums = 1 if stage == 3 else 2
            assert fields["tickets"] == fields["partials"] + 4 * n * channels \
                * sums


# -- on the card ---------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def card_site(device, shape, dropout=0.05, relu=True, seed=0):
    """Seeded (c, bias, divisor, bn) of a site of ``shape`` on the card,
    with dropped channels where ``dropout``."""
    n, channels = shape[:2]
    g = torch.Generator(device=device).manual_seed(seed)
    c = torch.randn(shape, generator=g, device=device)
    bias = torch.rand(channels, generator=g, device=device) * 2 - 1
    divisor = None
    if dropout:
        keep = torch.rand((n, channels), generator=g, device=device) \
            >= dropout
        keep[0, 0] = False
        divisor = torch.where(keep, 1.0 - dropout, float("inf"))
    bn = torch.nn.BatchNorm2d(channels).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(channels, generator=g, device=device) * 4
                        - 2)
        bn.bias.copy_(torch.rand(channels, generator=g, device=device) * 2
                      - 1)
    return c, bias, divisor, bn


def sum_bound(count, lanes, rows):
    """The most additions any term of a kernel's per-channel sum passes
    through: a lane's share of a plane in sequence, the group's tree, a
    lane's share of the N plane partials, the tree again. Each rounds by
    at most 2^-24 of the partial's terms' sizes."""
    tree = int(math.log2(lanes)) + (3 if lanes > 32 else 0)
    return math.ceil(count / lanes) + math.ceil(rows / lanes) + 2 * tree


def fused_step(c, bias, divisor, bn, cotangent, relu=True):
    """y, the running statistics and the gradients (c, bias, weight, shift)
    of the kernels' forward and backward."""
    c = c.detach().requires_grad_(True)
    bias = bias.detach().requires_grad_(True)
    y = train_epilogue(c, bias, divisor, bn, relu)
    grads = torch.autograd.grad((y * cotangent).sum(),
                                [c, bias, bn.weight, bn.bias])
    return y.detach(), bn.running_mean.clone(), bn.running_var.clone(), grads


def float64_on_choices(c, bias, divisor, bn, cotangent, y, relu):
    """The plain version in float64 from ``bn`` as a fresh BatchNorm's
    statistics (zero mean, unit variance) and the same affine weights:
    (its output, its BatchNorm, the gradients of c, bias, weight and shift)
    on the ReLU choices of the f32 output ``y``. A unit whose ReLU input
    lies within rounding of 0 may fall on the other side in float64, and
    its gradient moves by its whole value: a difference of the choice, not
    of the arithmetic. So the gradients come from the linear chain with
    the cotangent masked where ``y`` is not above 0, which is the ReLU's
    backward on ``y``'s choices."""
    channels = c.shape[1]
    bn64 = copy.deepcopy(bn).double()
    with torch.no_grad():
        bn64.running_mean.copy_(torch.zeros(channels))
        bn64.running_var.copy_(torch.ones(channels))
    args = (c.detach().double(), bias.detach().double(),
            None if divisor is None else divisor.double())
    y64 = train_epilogue_reference(*args, copy.deepcopy(bn64), relu)
    c64, bias64 = (t.requires_grad_(True) for t in args[:2])
    pre64 = train_epilogue_reference(c64, bias64, args[2], bn64, False)
    masked = cotangent.double() * (y > 0) if relu else cotangent.double()
    grads64 = torch.autograd.grad((pre64 * masked).sum(),
                                  [c64, bias64, bn64.weight, bn64.bias])
    return y64, bn64, grads64


# every ConvBnRelu output shape of the train cell's batch (32 slices): BraTS
# 240^2 down to 15^2
CELL_SHAPES = [(32, 32 << k, 240 >> k, 240 >> k) for k in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernels_at_the_cells_shapes(cuda_device, shape):
    """At each shape: the apply kernel bitwise the eager ops given the same
    constants; the batch sums within their summation bound of float64 sums
    of the same z; every gradient within 1e-4 of float64's scale; two runs
    bitwise alike; four launches a site."""
    c, bias, divisor, bn = card_site(cuda_device, shape)
    n, channels, h, w = shape
    # the apply kernel on the stats kernel's sums, against the eager ops
    s1, s2 = trainepilogue._Kernels.stats(c, bias, divisor)
    mean, inner, rstd, mul = trainepilogue.batch_constants(
        s1, s2, n * h * w, copy.deepcopy(bn))
    want = trainepilogue._Plain.apply(c, bias, divisor, mean, mul, bn.bias,
                                      True)
    got = trainepilogue._Kernels.apply(c, bias, divisor, mean, mul, bn.bias,
                                       True)
    assert same_bits(got, want)
    # the sums: f32 z (bitwise the kernels'), summed in float64
    z = trainepilogue._z(c, bias, divisor).double()
    bound = 1.01 * sum_bound(h * w, 32 if h * w < 2048 else 256, n) \
        * 2.0 ** -24
    for got_sum, terms in ((s1, z), (s2, z * z)):
        gap = (got_sum.double() - terms.sum((0, 2, 3))).abs()
        assert bool((gap <= bound * terms.abs().sum((0, 2, 3))).all())
    del z, want, got
    # forward and backward, twice, against float64
    g = torch.Generator(device=cuda_device).manual_seed(5)
    cotangent = torch.randn(shape, generator=g, device=cuda_device)
    bn_twice = copy.deepcopy(bn)
    launches = train_epilogue.launches
    first = fused_step(c, bias, divisor, bn, cotangent)
    assert train_epilogue.launches == launches + 4
    second = fused_step(c, bias, divisor, bn_twice, cotangent)
    torch.cuda.synchronize()
    for a, b in zip(first[:3] + tuple(first[3]),
                    second[:3] + tuple(second[3])):
        assert same_bits(a, b)
    y, running_mean, running_var, grads = first
    y64, bn64, grads64 = float64_on_choices(c, bias, divisor, bn, cotangent,
                                            y, True)
    # the f32 batch statistics carry the sums' error (<= ~1e-5 of their
    # terms here), which the mean's and variance's use magnifies by at most
    # E[z^2] / var (< 3 for these draws); 1e-4 of each tensor's scale holds
    # that with room, and a wrong mask or term misses by O(1)
    assert float((y.double() - y64).abs().max()) <= \
        1e-4 * float(y64.abs().max())
    for got_stat, want_stat in ((running_mean, bn64.running_mean),
                                (running_var, bn64.running_var)):
        assert float((got_stat.double() - want_stat).abs().max()) <= \
            1e-4 * float(want_stat.abs().max())
    dc, dbias, dweight, dshift = grads
    dc64, dbias64, dweight64, dshift64 = grads64
    for got_g, want_g in ((dc, dc64), (dweight, dweight64),
                          (dshift, dshift64)):
        assert float((got_g.double() - want_g).abs().max()) <= \
            1e-4 * float(want_g.abs().max())
    # the bias's gradient is a sum of terms that cancel: its scale is theirs
    terms = dc64.abs().sum((0, 2, 3))
    assert bool(((dbias.double() - dbias64).abs() <= 1e-4 * terms).all())


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("dropout", [None, 0.5], ids=["nodrop", "drop"])
@pytest.mark.parametrize("shape", [(4, 32, 15, 15), (3, 5, 7, 9),
                                   (8, 16, 1, 1), (6, 16, 12, 16),
                                   (2, 3, 64, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernels_match_the_plain_version_in_every_variant(
        cuda_device, shape, dropout, relu):
    """The kernels against float64 in every variant: dropout or none, ReLU
    or none, planes of 4k elements or not, warp and block planes, 1x1.
    The tolerances and their reasons are those of the cells' shapes."""
    c, bias, divisor, bn = card_site(cuda_device, shape, dropout, seed=7)
    cotangent = torch.randn(shape, device=cuda_device,
                            generator=torch.Generator(
                                device=cuda_device).manual_seed(8))
    y, running_mean, running_var, grads = fused_step(
        c, bias, divisor, bn, cotangent, relu)
    y64, bn64, grads64 = float64_on_choices(c, bias, divisor, bn, cotangent,
                                            y, relu)
    assert float((y.double() - y64).abs().max()) <= \
        1e-4 * float(y64.abs().max())
    for got, want in ((running_mean, bn64.running_mean),
                      (running_var, bn64.running_var)):
        assert float((got.double() - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    for got, want in zip(grads[:1] + grads[2:], grads64[:1] + grads64[2:]):
        assert float((got.double() - want).abs().max()) <= \
            1e-4 * float(want.abs().max())
    terms = grads64[0].abs().sum((0, 2, 3))
    assert bool(((grads[1].double() - grads64[1]).abs()
                 <= 1e-4 * terms).all())


@pytest.mark.cuda
def test_cuda_unet_train_step_fuses_every_site(cuda_device):
    """A depth-4 U-Net's train step on the card: 19 sites through the
    kernels (4 launches each), none through the eager chain, and the bytes
    counted are 32 an element of every site's output."""
    from torch.profiler import ProfilerActivity, profile

    from rcu_tpu_torch.utils import profiling
    torch.manual_seed(0)
    model = get_model("unet", dict(nb_classes=2, in_channels=4, depth=4,
                                   start_filters=8, dropout=0.05))
    model = model.to(cuda_device).train()
    x = torch.randn(2, 4, 32, 32, device=cuda_device)
    elements = []

    def spy(c, *args, **kwargs):
        elements.append(c.numel())
        return real(c, *args, **kwargs)

    real = unet.train_epilogue
    unet.train_epilogue = spy
    try:
        launches = train_epilogue.launches
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.clear()
            gens = [torch.Generator(device=cuda_device).manual_seed(1)]
            out = model(x, gens)
            out.logits.sum().backward()
            torch.cuda.synchronize()
            counts = profiling.counters()
    finally:
        unet.train_epilogue = real
    assert counts["unet.train_epilogue_fused"] == 19 == len(elements)
    assert counts.get("unet.epilogue_eager", 0) == 0
    assert train_epilogue.launches - launches == 4 * 19
    assert counts["unet.train_epilogue_bytes"] == 32 * sum(elements)
