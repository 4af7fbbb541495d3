"""The 2D U-Net and PostNet of ``rcu_tpu.models.unet`` as PyTorch modules
(plain f32).

Modules are NCHW inside, as PyTorch's convolutions want; the public
functions around them (``engine.steps``, ``eval.pipeline``) take NHWC like
the JAX package. Both return a :class:`UNetOutput`, as the flax modules do.
Submodule names mirror flax's (U-Net: ``ConvBlock_0..2d``, ``Conv_0..d-1``
up-convs, ``ConvBnRelu_0`` head, ``Conv_d`` class conv, and with the sigma
head ``ConvBnRelu_1`` and ``Conv_{d+1}``; PostNet: ``ConvBnRelu_0..n-1``
and the ``Conv_0`` head), so ``models.convert`` maps a flax tree onto
``state_dict`` by name.

Dropout is flax's channel dropout (``broadcast_dims=(1, 2)`` on NHWC): one
keep/drop draw per (image, channel), kept values divided by ``1 - p``. It
is active when the forward gets ``generators``, one ``torch.Generator`` per
MC sample: the input batch is ``T`` sample-major copies of the images, and
every dropout site draws sample ``t``'s ``(B, C)`` mask from
``generators[t]``. A sample's stream therefore does not depend on how many
other samples ride the same forward. BatchNorm always uses its running
statistics (eps 1e-5): under MC dropout as in flax, and because training
is not ported yet.
"""
from __future__ import annotations

import typing

import torch
from torch import nn
from torch.nn import functional as F


class UNetOutput(typing.NamedTuple):
    """NCHW logits; the sigma head's output and the decoder features where
    the model has them."""
    logits: torch.Tensor
    sigma: torch.Tensor | None = None
    features: torch.Tensor | None = None


class ChannelDropout(nn.Module):
    """flax ``nn.Dropout(p, broadcast_dims=(1, 2))`` with explicit generators."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p

    def forward(self, x, generators=None):
        if generators is None or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        n, c = x.shape[0] // len(generators), x.shape[1]
        masks = [torch.rand((n, c), generator=g, device=x.device) < keep
                 for g in generators]
        mask = torch.cat(masks).to(x.dtype)[:, :, None, None]
        # where(keep, x / keep_prob, 0) as flax computes it, in place
        return x.div_(keep).mul_(mask)


class ConvBnRelu(nn.Module):
    """conv (3x3, or 1x1 in the PostNet) -> [channel dropout] -> batch norm
    -> relu."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float | None = None,
                 kernel: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
        self.dropout = ChannelDropout(dropout) if dropout is not None else None
        self.BatchNorm_0 = nn.BatchNorm2d(out_ch, eps=1e-5)

    def forward(self, x, generators=None):
        x = self.Conv_0(x)
        if self.dropout is not None:
            x = self.dropout(x, generators)
        bn = self.BatchNorm_0
        x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                         bn.bias, False, 0.0, bn.eps)
        return F.relu_(x)


def _conv_dropout(dropout, dropout_mode, i, repetitions):
    """Which convs of a block carry dropout (``rcu_tpu`` unet.py:354-362)."""
    if dropout_mode == "all":
        return dropout
    if dropout_mode == "first" and i == 0:
        return dropout
    if dropout_mode == "last" and i == repetitions - 1:
        return dropout
    return None


def _block_dropout_mode(dropout_center, curr_depth, depth, is_down):
    """Dropout mode of a block at a given depth (``rcu_tpu`` unet.py:365-373)."""
    if dropout_center is None:
        return "all"
    if curr_depth == depth:
        return "no"
    if curr_depth + dropout_center >= depth:
        return "last" if is_down else "first"
    return "no"


class ConvBlock(nn.Module):
    """``repetitions`` stacked ConvBnRelu."""

    def __init__(self, in_ch: int, out_ch: int, dropout=None,
                 dropout_mode: str = "all", repetitions: int = 2):
        super().__init__()
        self.layers = []
        for i in range(repetitions):
            layer = ConvBnRelu(in_ch if i == 0 else out_ch, out_ch,
                               _conv_dropout(dropout, dropout_mode, i,
                                             repetitions))
            self.add_module(f"ConvBnRelu_{i}", layer)
            self.layers.append(layer)

    def forward(self, x, generators=None):
        for layer in self.layers:
            x = layer(x, generators)
        return x


def _pad_to(up, target_hw):
    """Pad spatially to the skip's shape: diff//2 before, the rest after."""
    h_diff = target_hw[0] - up.shape[2]
    w_diff = target_hw[1] - up.shape[3]
    if h_diff == 0 and w_diff == 0:
        return up
    return F.pad(up, (w_diff // 2, w_diff - w_diff // 2,
                      h_diff // 2, h_diff - h_diff // 2))


class _EvalOnly(nn.Module):
    """Training is not ported: the module stays in eval mode and
    ``train(True)`` raises."""

    def train(self, mode: bool = True):
        if mode:
            raise NotImplementedError("training is not ported to rcu_tpu_torch yet")
        return super().train(False)


class UNet(_EvalOnly):
    """Configurable 2D encoder-decoder; NCHW in, :class:`UNetOutput` out.

    ``sigma_out`` adds the aleatoric sigma head, ``provide_features``
    returns the decoder output that the heads read. The residual blocks,
    the fast decoder, int8, the BN fold and bf16 compute are later slices
    and rejected by ``models.registry.get_model``.
    """

    def __init__(self, nb_classes: int, in_channels: int, depth: int = 4,
                 start_filters: int = 16, dropout: float | None = 0.2,
                 dropout_center: int | None = None, sigma_out: bool = False,
                 provide_features: bool = False):
        super().__init__()
        self.depth = depth
        self.sigma_out = sigma_out
        self.provide_features = provide_features
        self.down_blocks, self.up_convs, self.up_blocks = [], [], []
        ch_in, ch = in_channels, start_filters
        for i in range(depth):
            mode = _block_dropout_mode(dropout_center, i, depth, True)
            block = ConvBlock(ch_in, ch, dropout, mode)
            self.add_module(f"ConvBlock_{i}", block)
            self.down_blocks.append(block)
            ch_in, ch = ch, ch * 2
        mode = _block_dropout_mode(dropout_center, depth, depth, True)
        self.add_module(f"ConvBlock_{depth}", ConvBlock(ch_in, ch, dropout, mode))
        for k in range(depth):
            up_conv = nn.Conv2d(ch, ch // 2, 3, padding=1)
            self.add_module(f"Conv_{k}", up_conv)
            self.up_convs.append(up_conv)
            mode = _block_dropout_mode(dropout_center, depth - 1 - k, depth,
                                       False)
            block = ConvBlock(ch, ch // 2, dropout, mode)
            self.add_module(f"ConvBlock_{depth + 1 + k}", block)
            self.up_blocks.append(block)
            ch //= 2
        self.ConvBnRelu_0 = ConvBnRelu(ch, ch, dropout)
        self.add_module(f"Conv_{depth}", nn.Conv2d(ch, nb_classes, 1))
        if sigma_out:
            self.ConvBnRelu_1 = ConvBnRelu(ch, ch, dropout)
            self.add_module(f"Conv_{depth + 1}", nn.Conv2d(ch, nb_classes, 1))
        _zero_biases(self)
        self.train(False)

    def forward(self, x, generators=None):
        """``generators``: one per MC sample riding the batch (sample-major),
        or None for the deterministic forward."""
        skips = []
        for block in self.down_blocks:
            x = block(x, generators)
            skips.append(x)
            x = F.max_pool2d(x, 2)
        x = getattr(self, f"ConvBlock_{self.depth}")(x, generators)
        for up_conv, block in zip(self.up_convs, self.up_blocks):
            skip = skips.pop()  # drop each skip as soon as it is consumed
            up = up_conv(F.interpolate(x, scale_factor=2, mode="nearest"))
            x = block(torch.cat([_pad_to(up, skip.shape[2:]), skip], dim=1),
                      generators)
            del up, skip
        # both heads read the decoder output x, and the sigma head does not
        # read the class head's; no op after this point writes into x in
        # place (each ConvBnRelu's in-place ops act on its conv's output),
        # so the features returned are the tensor the heads saw
        logits = getattr(self, f"Conv_{self.depth}")(
            self.ConvBnRelu_0(x, generators))
        sigma = None
        if self.sigma_out:
            sigma = getattr(self, f"Conv_{self.depth + 1}")(
                self.ConvBnRelu_1(x, generators))
        return UNetOutput(logits, sigma, x if self.provide_features else None)


class PostNet(_EvalOnly):
    """The auxiliary confidence net on a segmenter's features
    (``rcu_tpu.models.unet.PostNet``): ``nb_convs`` 1x1 ConvBnRelu at the
    input width, then the 1x1 class conv ``Conv_0``. flax infers the input
    width; here it is ``in_channels``."""

    def __init__(self, nb_classes: int, in_channels: int, nb_convs: int = 3,
                 dropout: float | None = None):
        super().__init__()
        self.layers = []
        for i in range(nb_convs):
            layer = ConvBnRelu(in_channels, in_channels, dropout, kernel=1)
            self.add_module(f"ConvBnRelu_{i}", layer)
            self.layers.append(layer)
        self.Conv_0 = nn.Conv2d(in_channels, nb_classes, 1)
        _zero_biases(self)
        self.train(False)

    def forward(self, x, generators=None):
        for layer in self.layers:
            x = layer(x, generators)
        return UNetOutput(self.Conv_0(x))


def _zero_biases(module):
    """flax's zero bias init (kernels: the same U(+-1/sqrt(fan_in)) as
    torch's)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.zeros_(m.bias)
