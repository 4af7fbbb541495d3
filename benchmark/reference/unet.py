"""The published 2-D U-Net (``alainjungo/reliability-challenges-uncertainty``,
``config/train_{brats,isic}_baseline.yaml``) in plain PyTorch, float32,
NCHW, from a dict of weights.

Each block is conv 3x3 -> channel dropout -> BatchNorm -> ReLU, twice; a
max-pool 2x2 between encoder levels; the decoder upsamples by nearest 2x,
runs a 3x3 conv (``Conv_k``), concatenates the encoder's skip (padded to
its size) and runs a block; the head is one conv-dropout-BN-ReLU and a 1x1
class conv. Dropout sits on every conv of every block and of the head
(no ``dropout_center``). The weights are named by the published layout:
``ConvBlock_{i}.ConvBnRelu_{j}.Conv_0.weight`` (i = 0..2 depth; depth is
the bottom, the decoder's blocks follow), ``.BatchNorm_0.{weight, bias,
running_mean, running_var}``, ``Conv_{k}`` the up-convs,
``ConvBnRelu_0`` the head and ``Conv_{depth}`` the class conv.

BatchNorm runs in one of three modes: ``eval`` (running statistics, eps
1e-5), ``train`` (the batch's mean and biased variance) and
``calibrate`` (sets the running statistics to the batch's, then as
``eval``): the benchmark's seeded weights are calibrated so that every
layer sees activations of the size a trained model's have.
"""
from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

EPS = 1e-5


def _block_names(depth: int) -> list:
    return [f"ConvBlock_{i}" for i in range(2 * depth + 1)]


class Dropout:
    """Channel dropout with ``masks`` (a ``streams.Masks`` or None): a
    kept channel divided by the keep probability ``divisor``."""

    def __init__(self, masks, divisor: float):
        self.masks, self.divisor = masks, divisor

    def __call__(self, y):
        if self.masks is None:
            return y
        keep = self.masks(y.shape[0], y.shape[1], y.device)
        return torch.where(keep[:, :, None, None], y / self.divisor,
                           torch.zeros((), dtype=y.dtype, device=y.device))


def _bn(w, name, y, mode):
    if mode == "eval":
        mean, var = w[name + ".running_mean"], w[name + ".running_var"]
    else:
        mean = y.mean((0, 2, 3))
        var = y.var((0, 2, 3), unbiased=False)
        if mode == "calibrate":
            w[name + ".running_mean"].copy_(mean.detach())
            w[name + ".running_var"].copy_(var.detach())
    scale = w[name + ".weight"] * torch.rsqrt(var + EPS)
    return (y - mean[:, None, None]) * scale[:, None, None] \
        + w[name + ".bias"][:, None, None]


def conv_bn_relu(w, name, x, dropout, mode):
    y = F.conv2d(x, w[name + ".Conv_0.weight"], w[name + ".Conv_0.bias"],
                 padding=1)
    return F.relu(_bn(w, name + ".BatchNorm_0", dropout(y), mode))


def _block(w, name, x, dropout, mode):
    for j in range(2):
        x = conv_bn_relu(w, f"{name}.ConvBnRelu_{j}", x, dropout, mode)
    return x


def _pad_to(x, hw):
    dh, dw = hw[0] - x.shape[2], hw[1] - x.shape[3]
    return F.pad(x, (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))


def features(w: dict, x, depth: int = 4, masks=None, keep: float = 0.95,
             mode: str = "eval"):
    """The head's features (N, start_filters, H, W): the decoder's output
    through ``ConvBnRelu_0``, which the 1x1 class conv reads."""
    dropout = Dropout(masks, keep)
    names = _block_names(depth)
    skips = []
    for i in range(depth):
        x = _block(w, names[i], x, dropout, mode)
        skips.append(x)
        x = F.max_pool2d(x, 2)
    x = _block(w, names[depth], x, dropout, mode)
    for k in range(depth):
        skip = skips.pop()
        up = F.interpolate(x, scale_factor=2, mode="nearest")
        up = F.conv2d(up, w[f"Conv_{k}.weight"], w[f"Conv_{k}.bias"],
                      padding=1)
        x = _block(w, names[depth + 1 + k],
                   torch.cat([_pad_to(up, skip.shape[2:]), skip], 1),
                   dropout, mode)
    return conv_bn_relu(w, "ConvBnRelu_0", x, dropout, mode)


def forward(w: dict, x, depth: int = 4, masks=None, keep: float = 0.95,
            mode: str = "eval"):
    """Logits (N, classes, H, W) of the images ``x`` (N, C, H, W), with
    one sample's dropout masks (None: no dropout)."""
    return F.conv2d(features(w, x, depth, masks, keep, mode),
                    w[f"Conv_{depth}.weight"], w[f"Conv_{depth}.bias"])


def leaf_shapes(model: dict) -> dict:
    """{name: shape} of the U-Net of ``model`` (the config's ``unet``
    node): every conv's weight and bias, every BatchNorm's four."""
    depth, ch = int(model["depth"]), int(model["start_filters"])
    shapes = {}

    def conv(name, cin, cout, k=3):
        shapes[name + ".weight"] = (cout, cin, k, k)
        shapes[name + ".bias"] = (cout,)

    def cbr(name, cin, cout):
        conv(name + ".Conv_0", cin, cout)
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.BatchNorm_0.{leaf}"] = (cout,)

    names = _block_names(depth)
    cin = int(model["in_channels"])
    for level in range(depth + 1):
        c = ch << level
        cbr(f"{names[level]}.ConvBnRelu_0", cin, c)
        cbr(f"{names[level]}.ConvBnRelu_1", c, c)
        cin = c
    for k in range(depth):
        c = ch << (depth - 1 - k)
        conv(f"Conv_{k}", 2 * c, c)
        cbr(f"{names[depth + 1 + k]}.ConvBnRelu_0", 2 * c, c)
        cbr(f"{names[depth + 1 + k]}.ConvBnRelu_1", c, c)
    cbr("ConvBnRelu_0", ch, ch)
    conv(f"Conv_{depth}", ch, int(model["nb_classes"]), 1)
    return shapes


def is_trained(name: str) -> bool:
    """Whether the optimizer updates the leaf (not a running statistic)."""
    return not name.endswith(("running_mean", "running_var"))


def seeded_weights(model: dict, generator: torch.Generator, device) -> dict:
    """flax's initialization of the published model from ``generator``:
    every conv kernel ``U(-sqrt(1/fan_in), sqrt(1/fan_in))`` out of one
    draw, biases 0, BatchNorm scale 1, shift 0, mean 0, variance 1."""
    shapes = leaf_shapes(model)
    kernels = [n for n, s in shapes.items() if len(s) == 4]
    sizes = [torch.Size(shapes[n]).numel() for n in kernels]
    flat = torch.rand(sum(sizes), generator=generator, device=device)
    w = {}
    for name, part in zip(kernels, torch.split(flat, sizes)):
        shape = shapes[name]
        bound = (1.0 / (shape[1] * shape[2] * shape[3])) ** 0.5
        w[name] = ((part * 2 - 1) * bound).view(shape)
    for name, shape in shapes.items():
        if name not in w:
            ones = name.endswith(("BatchNorm_0.weight", "running_var"))
            w[name] = (torch.ones if ones else torch.zeros)(
                shape, device=device)
    return w


@torch.no_grad()
def calibrate(w: dict, x, depth: int = 4, logit_std: float = 2.0,
              background=None, background_logit: float = -8.0):
    """Make seeded inference weights give spread maps, in place: every
    BatchNorm's running statistics become those of its input on the
    images ``x``; then the class head is fitted (least squares over the
    pixels of ``x``) so that its logit difference is the seeded head's,
    scaled and centred to median 0 and standard deviation ``logit_std``
    over the foreground pixels, and ``background_logit`` on the pixels of
    ``background`` (an (N, H, W) bool mask, or None), as a trained model
    is sure of the empty background; the two logits are minus and plus
    half the difference."""
    forward(w, x, depth, mode="calibrate")
    f = features(w, x, depth).permute(0, 2, 3, 1).reshape(-1, w[
        f"Conv_{depth}.weight"].shape[1]).double()
    head_w = w[f"Conv_{depth}.weight"]
    head_b = w[f"Conv_{depth}.bias"]
    diff = f @ (head_w[1] - head_w[0]).reshape(-1).double() \
        + float(head_b[1] - head_b[0])
    bg = torch.zeros_like(diff, dtype=torch.bool) if background is None \
        else background.reshape(-1).to(diff.device)
    fg = diff[~bg]
    target = (diff - fg.median()) * (logit_std / fg.std())
    target = torch.where(bg, torch.full_like(target, background_logit),
                         target)
    design = torch.cat([f, torch.ones_like(f[:, :1])], 1)
    theta = torch.linalg.lstsq(design.cpu(), target[:, None].cpu()).solution
    theta = theta[:, 0].to(head_w.device, head_w.dtype) / 2
    head_w.copy_(torch.stack([-theta[:-1], theta[:-1]]).view_as(head_w))
    head_b.copy_(torch.stack([-theta[-1], theta[-1]]))


@contextlib.contextmanager
def precision(tf32: bool = False):
    """float32 convolutions and matmuls in full float32 (``tf32=False``,
    the reference's precision) or rounded to TF32 within the block."""
    switches = [(torch.backends.cudnn, "allow_tf32", tf32),
                (torch.backends.cuda.matmul, "allow_tf32", tf32)]
    for holder in (getattr(torch.backends.cudnn, "conv", None),
                   torch.backends.cuda.matmul):
        if holder is not None and hasattr(holder, "fp32_precision"):
            switches.append((holder, "fp32_precision",
                             "tf32" if tf32 else "ieee"))
    saved = [(h, n, getattr(h, n)) for h, n, _ in switches]
    try:
        for holder, name, value in switches:
            setattr(holder, name, value)
        yield
    finally:
        for holder, name, value in saved:
            setattr(holder, name, value)
