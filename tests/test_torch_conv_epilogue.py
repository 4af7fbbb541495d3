"""The conv epilogue of ``ConvBnRelu`` in eval mode: the plain version of
``ops/cuda/convepilogue`` against the module's eager chain, the rule that
picks the kernel, the wrapper's refusals (CPU tensors among them), and on
the card the kernel bitwise against its plain version at the benchmark
cells' shapes and a whole MC eval with the kernel on and off. The card tests carry the
``cuda`` marker and skip without one. This file imports neither JAX nor the
JAX package, so the card's machine runs it as it is::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_conv_epilogue.py -m cuda
"""
import csv
import os

import numpy as np
import pytest
import torch

from rcu_tpu_torch.engine import remat
from rcu_tpu_torch.models import get_model, unet
from rcu_tpu_torch.models.unet import ConvBnRelu
from rcu_tpu_torch.ops.cuda import convepilogue
from rcu_tpu_torch.ops.cuda.convepilogue import (conv_epilogue,
                                                 conv_epilogue_reference)

F32_EPS = 2.0 ** -23


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_bn(channels, generator, device="cpu"):
    """An eval-mode BatchNorm with statistics and affine weights away from
    their defaults (negative scales too)."""
    bn = torch.nn.BatchNorm2d(channels, eps=1e-5).eval()

    def draw(lo, hi):
        return (lo + (hi - lo) * torch.rand(channels, generator=generator))

    with torch.no_grad():
        bn.running_mean.copy_(draw(-1.0, 1.0))
        bn.running_var.copy_(draw(0.05, 3.0))
        bn.weight.copy_(draw(-2.0, 2.0))
        bn.bias.copy_(draw(-1.0, 1.0))
    return bn.to(device)


def site(dropout, bn, relu, seed=0, cin=3, cout=8):
    """An eval-mode f32 ConvBnRelu with a nonzero bias and, with ``bn``,
    BatchNorm statistics away from their defaults."""
    g = torch.Generator().manual_seed(seed)
    layer = ConvBnRelu(cin, cout, dropout, bn=bn, activation=relu).eval()
    with torch.no_grad():
        layer.Conv_0.weight.copy_(torch.randn(layer.Conv_0.weight.shape,
                                              generator=g))
        layer.Conv_0.bias.copy_(torch.randn(cout, generator=g))
        if bn:
            fresh = random_bn(cout, g)
            for name in ("running_mean", "running_var", "weight", "bias"):
                getattr(layer.BatchNorm_0, name).copy_(getattr(fresh, name))
    return layer


def generators(seed, t):
    return [torch.Generator().manual_seed(seed + k) for k in range(t)]


def drops(t, b, c, p, seed, device="cpu"):
    """A (t * b, c) dropout divisor: keep probability ``1 - p`` in f32, inf
    for a dropped channel; at least one of each."""
    g = torch.Generator().manual_seed(seed)
    keep = torch.rand((t * b, c), generator=g) >= p
    keep[0, 0], keep[-1, -1] = False, True
    return torch.where(keep, 1.0 - p, float("inf")).to(device)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("dropout", [None, 0.5])
def test_plain_version_matches_the_eager_chain(dropout, bn, relu):
    """The module's eager chain (the conv with its bias, dropout's divide,
    F.batch_norm, relu_) and the plain version on the bias-free conv output
    part by a few f32 ulps of the terms they add (the conv's products, the
    bias, the BatchNorm's shift); dropped channels (inf divisors)
    included."""
    layer = site(dropout, bn, relu)
    x = torch.randn(3 * 2, 3, 9, 7, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        eager = layer(x, generators(5, 3) if dropout else None)
        y = layer.conv_out(x, bias=False)
        divisor = None if dropout is None \
            else layer.dropout.divisor(y, generators(5, 3))
        got = conv_epilogue_reference(y, layer.Conv_0.bias, divisor,
                                      getattr(layer, "BatchNorm_0", None),
                                      relu)
    assert not layer.fuses_epilogue(x)  # the CPU keeps the eager chain
    if dropout:
        assert torch.isinf(divisor).any() and not torch.isinf(divisor).all()
    # the size of the terms: the conv's products and the bias, divided,
    # normalized
    t = torch.nn.functional.conv2d(
        x.abs().double(), layer.Conv_0.weight.abs().double(), padding=1) \
        + layer.Conv_0.bias.abs().double()[:, None, None]
    if divisor is not None:
        t = t / divisor.double()[:, :, None, None]
    if bn:
        mean, scale, shift = (v.double() for v in
                              convepilogue.bn_constants(layer.BatchNorm_0))
        t = (t + mean.abs()[:, None, None]) * scale.abs()[:, None, None] \
            + shift.abs()[:, None, None]
    gap = (got.double() - eager.double()).abs()
    assert bool((gap <= 8 * F32_EPS * t).all()), float((gap / t).max())
    if relu:
        assert bool((got >= 0).all())


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
    ("f32 eval", True),
    ("split pair", True),
    ("training", False),
    ("remat", False),
    ("bf16", False),
    ("quantized", False),
    ("cpu", False),
    ("grad enabled", False),
    ("channels last", False),
])
def test_only_f32_eval_sites_on_a_card_fuse(case, want):
    layer = site(0.1, True, True)
    x = CardTensor(
        dtype=torch.bfloat16 if case == "bf16" else torch.float32,
        channels_last=case == "channels last",
        device="cpu" if case == "cpu" else "cuda")
    if case == "split pair":
        x = (x, CardTensor())
    if case in ("training", "remat"):
        layer.train()
    if case == "quantized":
        layer.quant_scales = {}
    with torch.set_grad_enabled(case == "grad enabled"):
        if case == "remat":
            with remat.using("conv"):
                assert layer.fuses_epilogue(x) is want
        else:
            assert layer.fuses_epilogue(x) is want


def test_cpu_forwards_never_reach_the_wrapper(monkeypatch):
    """Every CPU site keeps the eager chain: a U-Net's MC forward in eval
    mode, its train-mode step and a bf16 forward call no ``conv_epilogue``,
    and give what they gave before it existed (the parity tests hold
    those numbers against the JAX package)."""
    def refuse(*args, **kwargs):
        raise AssertionError("conv_epilogue called on a CPU site")

    monkeypatch.setattr(unet, "conv_epilogue", refuse)
    torch.manual_seed(0)
    record = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
                  dropout=0.2, sigma_out=True)
    model = get_model("unet", record)
    x = torch.randn(4, 4, 16, 16)
    with torch.inference_mode():
        model(x, generators(0, 2))
        get_model("unet", {**record, "dtype": "bfloat16"})(x)
    model.train()
    model(x, generators(0, 1)).logits.sum().backward()


@pytest.mark.parametrize("change,error", [
    (dict(y=lambda y: y.double()), TypeError),
    (dict(y=lambda y: y[0]), ValueError),
    (dict(y=lambda y: y.transpose(2, 3)), ValueError),
    (dict(y=lambda y: torch.empty(y.numel() + 1)[1:].view(y.shape)),
     ValueError),
    (dict(bias=lambda b: b[:-1]), ValueError),
    (dict(bias=lambda b: b.double()), TypeError),
    (dict(divisor=lambda d: d.t().contiguous()), ValueError),
    (dict(divisor=lambda d: d.to("meta")), ValueError),
    (dict(bn=lambda m: m.double()), TypeError),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(change, error):
    g = torch.Generator().manual_seed(2)
    args = dict(y=torch.randn(4, 6, 5, 5, generator=g),
                bias=torch.randn(6, generator=g),
                divisor=drops(2, 2, 6, 0.3, 1), bn=random_bn(6, g))
    for name, edit in change.items():
        args[name] = edit(args[name])
    constants = convepilogue.bn_constants(args["bn"])
    with pytest.raises(error):
        convepilogue._check_cuda_inputs(args["y"], args["bias"],
                                        args["divisor"], constants)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_runs_on_cuda_only(device):
    """A CPU site keeps the module's eager chain: the wrapper takes no CPU
    tensor, and no other device's."""
    y = torch.zeros(2, 3, 4, 4, device=device)
    with pytest.raises(ValueError, match="runs on cuda"):
        conv_epilogue(y, torch.zeros(3, device=device))
    assert device == "meta" or not bool(y.any())  # left as it was


# -- on the card ---------------------------------------------------------

def same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def kernel_against_plain(device, rows, c, h, w, dropout, bn, relu, seed=0):
    """The kernel in place on a copy of seeded (rows, c, h, w) conv outputs
    against the plain version, bitwise; NaN and +-inf in the input too."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randn((rows, c, h, w), generator=g, device=device)
    flat, k = y.view(-1), min(4, y.numel())
    flat[:k] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0],
                            device=device)[:k]
    bias = torch.randn(c, generator=g, device=device)
    divisor = drops(1, rows, c, 0.05 if rows > 8 else 0.3, seed, device) \
        if dropout else None
    norm = random_bn(c, torch.Generator().manual_seed(seed), device) \
        if bn else None
    want = conv_epilogue_reference(y, bias, divisor, norm, relu)
    launches = conv_epilogue.launches
    got = conv_epilogue(y.clone(), bias, divisor, norm, relu)
    torch.cuda.synchronize()
    assert conv_epilogue.launches == launches + 1
    assert same_bits(got, want), (rows, c, h, w, dropout, bn, relu)


# every ConvBnRelu output shape of the benchmark cells' MC batch (32 slices
# or images x T = 20): BraTS 240^2 down to 15^2, ISIC 192x256 down to 12x16
CELL_SHAPES = [(640, 32 << k, 240 >> k, 240 >> k) for k in range(5)] \
    + [(640, 32 << k, 192 >> k, 256 >> k) for k in range(5)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_kernel_is_bitwise_plain_at_the_cells_shapes(cuda_device, shape):
    kernel_against_plain(cuda_device, *shape, dropout=True, bn=True,
                         relu=True)


@pytest.mark.cuda
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("dropout", [True, False])
@pytest.mark.parametrize("shape", [(4, 32, 15, 15), (3, 5, 7, 9), (1, 1, 1, 2),
                                   (6, 16, 12, 16)])
def test_cuda_kernel_is_bitwise_plain_in_every_variant(cuda_device, shape,
                                                       dropout, bn, relu):
    kernel_against_plain(cuda_device, *shape, dropout, bn, relu, seed=7)


@pytest.mark.cuda
def test_cuda_kernel_cuts_a_launch_of_2_31_elements(cuda_device):
    """A tensor of 2^31 elements or more takes launches of whole rows; the
    wrapper's one call still counts one."""
    kernel_against_plain(cuda_device, 1200, 32, 240, 240, dropout=True,
                         bn=True, relu=True)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_a_misaligned_view(cuda_device):
    y = torch.empty(4 * 6 * 5 * 5 + 1, device=cuda_device)[1:].view(4, 6, 5, 5)
    with pytest.raises(ValueError, match="aligned"):
        conv_epilogue(y, torch.zeros(6, device=cuda_device))


class OneVolume:
    """One seeded BraTS-sized subject in memory, with the SubjectDataset
    read interface."""
    subjects = ["s"]

    def __init__(self, shape=(155, 240, 240)):
        rng = np.random.RandomState(4)
        self._images = rng.standard_normal(shape + (4,)).astype(np.float32)
        self._labels = (rng.rand(*shape) < 0.3).astype(np.uint8)

    def read_volume(self, subject, category):
        return self._images if category == "images" else self._labels

    def shape(self, subject, category="images"):
        return self.read_volume(subject, category).shape


def ece_row(out_dir):
    (name,) = [f for f in os.listdir(out_dir) if f.startswith("eval_ece_")]
    with open(os.path.join(out_dir, name), newline="") as f:
        (row,) = csv.DictReader(f)
    return row


@pytest.mark.cuda
def test_cuda_mc_eval_with_the_kernel_on_and_off(cuda_device, tmp_path,
                                                 monkeypatch):
    """A BraTS subject's MC20 eval at the published width, with every
    ConvBnRelu through the kernel and through the eager chain, within the
    benchmark's ``correct`` limits of brats_mc20_f32 (ECE 1.5e-6, every
    count 3e-6 of the voxels)."""
    import chip_smoke
    from rcu_tpu_torch.eval.direct import evaluate_subjects
    dataset = OneVolume()
    x = torch.from_numpy(dataset.read_volume("s", "images")[72:80]
                         .transpose(0, 3, 1, 2).copy()).to(cuda_device)
    model = chip_smoke.seeded_unet(3, x)
    rows = {}
    for on in (True, False):
        if not on:
            monkeypatch.setattr(ConvBnRelu, "fuses_epilogue",
                                lambda self, x: False)
        launches = conv_epilogue.launches
        out = str(tmp_path / str(on))
        evaluate_subjects(model, dataset, out, mc=20, batch_size=32,
                          masked=False, device=cuda_device, seed=11)
        # 19 sites a forward, one forward a batch of 32 slices
        assert conv_epilogue.launches - launches == (19 * 5 if on else 0)
        rows[on] = ece_row(out)
    n = int(rows[True]["n"])
    assert abs(float(rows[True]["ece"]) - float(rows[False]["ece"])) <= 1.5e-6
    for key in ("tp", "tn", "fp", "fn"):
        assert abs(int(rows[True][key]) - int(rows[False][key])) <= 3e-6 * n
