"""Swin UNETR (Hatamizadeh et al., "Swin UNETR: Swin Transformers for
Semantic Segmentation of Brain Tumors in MRI Images", BrainLes 2021,
arXiv:2201.01266; the published BraTS 2021 run is
``github.com/Project-MONAI/research-contributions``, ``SwinUNETR/BRATS21``,
its model MONAI's ``monai/networks/nets/swin_unetr.py`` ``SwinUNETR``) in
2-D (``spatial_dims=2``, as MONAI's class takes it), a model of the port's
MC-dropout path. MONAI's v1 blocks, ``normalize=True``, ``norm_name``
"instance", patch 2; float32 only.

- The image is zero-padded at the bottom and right to a multiple of 32
  (240 -> 256), and the logits cropped back to ``img_size``.
- Patch embedding: a conv of kernel and stride 2 with bias to
  ``feature_size`` channels, then ``pos_drop``. Each hidden state
  ``hs[i]`` is the stage output through ``proj_out``: a LayerNorm over the
  channels without affine (eps 1e-5).
- Four stages (``layers1``..``layers4``), stage s at ``feature_size * 2^s``
  channels: ``depths[s]`` blocks ``x += Attn(LN(x)); x += MLP(LN(x))``
  (LayerNorm eps 1e-5), then patch merging. Every second block shifts its
  windows by ``window // 2``. A block pads the normed grid with zeros, at
  the bottom and right, to a multiple of the window (padded tokens are not
  masked), rolls it by ``(-shift, -shift)`` where it shifts, attends in
  ``window x window`` windows, and undoes roll and pad. A grid no larger
  than the window is one window of the grid's size, unshifted (MONAI's
  ``get_window_size``; its bias then reads the first ``n x n`` entries of
  the window's index, as MONAI's does).
- Window attention: ``qkv`` with bias, ``softmax(q k^T / sqrt(d) + B +
  mask) v`` (``F.scaled_dot_product_attention`` with one additive float
  tensor, bias and mask, a block, broadcast over the batch: never
  expanded per image), ``proj`` with bias, ``proj_drop``. ``B`` gathers the
  learned table of ``(2 window - 1)^2`` rows by the relative position
  index ``(dh + window - 1) (2 window - 1) + dw + window - 1``; the mask
  is MONAI's ``compute_mask``: -100 between tokens of different regions of
  the shifted, padded grid.
- MLP: ``models.transunet.Mlp`` (linear to ``mlp_ratio`` x, exact GELU,
  dropout, linear, dropout), named ``fc1``/``fc2`` where MONAI's are
  ``linear1``/``linear2``.
- Patch merging (MONAI's ``PatchMerging`` in 2-D): the four 2 x 2 phases
  concatenated in ``itertools.product`` order ``x[:, j::2, i::2]``, then
  LayerNorm and a linear to twice the channels without bias.
- Conv path: convs without bias (MONAI's ``get_conv_layer``),
  ``InstanceNorm2d`` without affine (eps 1e-5), LeakyReLU 0.01.
  ``UnetResBlock``: conv3x3 -> IN -> lrelu -> conv3x3 -> IN, plus the input
  (a 1x1 conv -> IN where the channels change), lrelu. ``encoder1`` on the
  image, ``encoder2``/``3``/``4``/``10`` on ``hs[0]``/``[1]``/``[2]``/``[4]``;
  ``UnetrUpBlock`` (``decoder5``..``decoder1``): a 2x2 stride-2 transposed
  conv, the skip concatenated, a ``UnetResBlock`` of twice the channels;
  a 1x1 conv with bias to the classes (``out``).

Module names are MONAI's where the structure allows
(``swinViT.layers1.0.blocks.0.attn.relative_position_bias_table``,
``encoder1.layer.conv1.conv``, ``decoder5.transp_conv.conv``,
``out.conv.conv``); the relative position index is a buffer outside the
state_dict, derived from the window.

Dropout is element-wise (``models.transunet.ElementDropout``), active when
the forward gets ``generators``, one per MC sample riding the batch
sample-major; the sites in forward order are ``pos_drop`` on the (N, C, H,
W) embedding, then in each block ``proj_drop`` on the (N nW, window^2, C)
windows (padded tokens included) and the MLP's two on (N, H, W, C). The
padding, ``encoder1`` and the patch embedding carry none, so the MC
protocol (``engine.steps.mc_forward``) runs them once a batch
(:meth:`SwinUNETR.encode_shared`) and the rest once a sample
(:meth:`SwinUNETR.decode_rest`). InstanceNorm has no running statistics:
train and eval mode differ only where generators are given.

While a profiler runs the model records the spans ``swinunetr.shared``
(:meth:`SwinUNETR.encode_shared`), ``swinunetr.swin`` (the stages and
merging, with its device seconds, ``utils.profiling.device_seconds``),
``swinunetr.window_attention`` (each block's pad, roll, partition,
attention, reverse and crop, with its device seconds) and
``swinunetr.decoder``, and counts ``swinunetr.images`` (images through the
shared prefix), ``swinunetr.samples`` (images through the rest),
``swinunetr.windows`` (windows attended) and
``swinunetr.dropout_elements`` (elements masked).
"""
from __future__ import annotations

import itertools

import torch
from torch import nn
from torch.nn import functional as F

from rcu_tpu_torch.models.transunet import Conv2d, ElementDropout, Mlp
from rcu_tpu_torch.models.unet import UNetOutput, conv2d
from rcu_tpu_torch.utils import profiling

DROPOUT_COUNTER = "swinunetr.dropout_elements"
MASK_VALUE = -100.0  # MONAI's compute_mask
ALIGN = 32  # patch 2 and four mergings


def window_size(size: int, window: int, shift: int):
    """(window, shift) on a square grid of ``size``: a grid no larger than
    the window is one unshifted window (MONAI's ``get_window_size``)."""
    return (size, 0) if size <= window else (window, shift)


def window_partition(x, window: int):
    """(B, Hp, Wp, C) -> (B nW, window^2, C), image-major, windows in row
    order."""
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows, window: int, b: int, h: int, w: int):
    """:func:`window_partition`'s inverse -> (B, h, w, C)."""
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(window: int):
    """(window^2, window^2) int64: ``(dh + window - 1) (2 window - 1) + dw +
    window - 1`` of tokens i and j, d = i - j."""
    h, w = torch.meshgrid(torch.arange(window), torch.arange(window),
                          indexing="ij")
    h, w = h.flatten(), w.flatten()
    return (h[:, None] - h[None] + window - 1) * (2 * window - 1) \
        + w[:, None] - w[None] + window - 1


def shift_mask(size: int, window: int, shift: int, device):
    """(nW, window^2, window^2) float: ``MASK_VALUE`` between two tokens of
    a window of the shifted ``size`` x ``size`` grid that lie in different
    regions, else 0 (MONAI's ``compute_mask``: along each axis the rows
    below ``size - window``, those below ``size - shift`` and the rest are
    three regions)."""
    r = torch.arange(size, device=device)
    region = (r >= size - window).long() + (r >= size - shift).long()
    label = (region[:, None] * 3 + region[None])[None, ..., None]
    label = window_partition(label, window)[..., 0]
    return torch.where(label[:, None] != label[:, :, None], MASK_VALUE,
                       0.0).to(torch.float32)


def _window_rows(generators, nw: int):
    """A mesh part's generators (rows of images) as rows of its windows."""
    rows = getattr(generators, "rows", None)
    if rows is None:
        return generators
    from rcu_tpu_torch.engine.steps import ShardGenerators
    return ShardGenerators(list(generators), tuple(r * nw for r in rows))


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` run by ``models.unet.conv2d``."""

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      transposed=True)


class Convolution(nn.Module):
    """MONAI's ``Convolution`` as ``get_conv_layer`` builds it without norm
    or activation: its one child ``conv`` (no bias unless asked, 'same'
    padding; a transposed conv of stride = kernel)."""

    def __init__(self, cin: int, cout: int, kernel: int, bias: bool = False,
                 transposed: bool = False):
        super().__init__()
        self.conv = ConvTranspose2d(cin, cout, kernel, stride=kernel,
                                    bias=bias) if transposed else \
            Conv2d(cin, cout, kernel, padding=kernel // 2, bias=bias)

    def forward(self, x):
        return self.conv(x)


class UnetResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = Convolution(cin, cout, 3)
        self.conv2 = Convolution(cout, cout, 3)
        self.norm1 = nn.InstanceNorm2d(cout)
        self.norm2 = nn.InstanceNorm2d(cout)
        if cin != cout:
            self.conv3 = Convolution(cin, cout, 1)
            self.norm3 = nn.InstanceNorm2d(cout)

    def forward(self, x):
        out = F.leaky_relu_(self.norm1(self.conv1(x)), 0.01)
        out = self.norm2(self.conv2(out))
        residual = self.norm3(self.conv3(x)) if hasattr(self, "conv3") \
            else x
        return F.leaky_relu_(out.add_(residual), 0.01)


class UnetrBasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.layer = UnetResBlock(cin, cout)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.transp_conv = Convolution(cin, cout, 2, transposed=True)
        self.conv_block = UnetResBlock(2 * cout, cout)

    def forward(self, x, skip):
        return self.conv_block(torch.cat((self.transp_conv(x), skip), 1))


class UnetOutBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Convolution(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int):
        super().__init__()
        self.proj = Conv2d(in_channels, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, drop: float):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = ElementDropout(drop, DROPOUT_COUNTER)

    def bias(self, n: int, mask=None):
        """The additive float tensor of a block's attention: (1, heads, n,
        n), plus ``mask`` (nW, n, n) -> (nW, heads, n, n)."""
        index = self.relative_position_index[:n, :n].reshape(-1)
        # contiguous: SDPA's memory-efficient kernel takes no mask whose
        # last axis is strided (it falls back to its plain matmuls)
        bias = self.relative_position_bias_table[index].view(n, n, -1) \
            .permute(2, 0, 1).contiguous()[None]
        return bias if mask is None else bias + mask[:, None]

    def forward(self, windows, images: int, bias, generators=None):
        """``windows`` (images nW, n, C) -> the same shape. With a bias
        per window (``bias`` (nW, heads, n, n)) the heads of an image's
        windows ride one axis, (images, nW heads, n, d), so that the bias
        broadcasts over the images alone."""
        rows, n, c = windows.shape
        qkv = self.qkv(windows).view(rows, n, 3, self.heads, c // self.heads)
        nw = bias.shape[0]
        if nw == 1:
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
            out = out.transpose(1, 2).reshape(rows, n, c)
        else:
            q, k, v = qkv.view(images, nw, n, 3, self.heads, -1) \
                .permute(3, 0, 1, 4, 2, 5) \
                .reshape(3, images, nw * self.heads, n, -1).unbind(0)
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias.reshape(1, nw * self.heads, n, n))
            out = out.view(images, nw, self.heads, n, -1) \
                .permute(0, 1, 3, 2, 4).reshape(rows, n, c)
        return self.proj_drop(self.proj(out),
                              _window_rows(generators, rows // images))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int,
                 mlp_ratio: float, drop: float):
        super().__init__()
        self.window, self.shift = window, shift
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, heads, window, drop)
        self.norm2 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, DROPOUT_COUNTER)

    def forward(self, x, mask, generators=None):
        """``x`` (B, H, W, C) channels-last; ``mask`` the stage's shift mask
        (None where the stage's grid is one window)."""
        x = x + self._attention(self.norm1(x), mask, generators)
        return x + self.mlp(self.norm2(x), generators)

    def _attention(self, x, mask, generators):
        b, h, w, c = x.shape
        window, shift = window_size(h, self.window, self.shift)
        with profiling.span("swinunetr.window_attention", device=x.device):
            pad = (window - h % window) % window
            if pad:
                x = F.pad(x, (0, 0, 0, pad, 0, pad))
            if shift:
                x = torch.roll(x, (-shift, -shift), (1, 2))
            windows = window_partition(x, window)
            profiling.count("swinunetr.windows", windows.shape[0])
            bias = self.attn.bias(window * window, mask if shift else None)
            windows = self.attn(windows, b, bias, generators)
            x = window_reverse(windows, window, b, h + pad, w + pad)
            if shift:
                x = torch.roll(x, (shift, shift), (1, 2))
            return x[:, :h, :w].contiguous() if pad else x


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(4 * dim)

    def forward(self, x):
        """(B, H, W, C) -> (B, H/2, W/2, 2C)."""
        h, w = x.shape[1:3]
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, j::2, i::2] for i, j
                       in itertools.product(range(2), range(2))], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, window: int,
                 mlp_ratio: float, drop: float):
        super().__init__()
        self.window = window
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, window,
                                 0 if i % 2 == 0 else window // 2, mlp_ratio,
                                 drop) for i in range(depth))
        self.downsample = PatchMerging(dim)

    def forward(self, x, generators=None):
        """(B, H, W, C) channels-last -> (B, H/2, W/2, 2C)."""
        size = x.shape[1]
        window, shift = window_size(size, self.window, self.window // 2)
        mask = shift_mask(-(-size // window) * window, window, shift,
                          x.device) if shift else None
        for block in self.blocks:
            x = block(x, mask, generators)
        return self.downsample(x)


class SwinViT(nn.Module):
    def __init__(self, in_channels: int, dim: int, patch: int, depths, heads,
                 window: int, mlp_ratio: float, drop: float):
        super().__init__()
        self.patch_embed = PatchEmbed(in_channels, dim, patch)
        self.pos_drop = ElementDropout(drop, DROPOUT_COUNTER)
        for s, (depth, h) in enumerate(zip(depths, heads)):
            self.add_module(f"layers{s + 1}", nn.ModuleList([BasicLayer(
                dim << s, depth, h, window, mlp_ratio, drop)]))

    @staticmethod
    def proj_out(x):
        """A channels-last stage output -> its LayerNorm over the channels
        (no affine), NCHW."""
        return F.layer_norm(x, x.shape[-1:]).permute(0, 3, 1, 2) \
            .contiguous()

    def forward(self, embedding, generators=None):
        """The patch embedding (N, C, H, W) -> the five hidden states."""
        x = self.pos_drop(embedding, generators).permute(0, 2, 3, 1)
        states = [self.proj_out(x)]
        for s in range(4):
            x = getattr(self, f"layers{s + 1}")[0](x, generators)
            states.append(self.proj_out(x))
        return states


class SwinUNETR(nn.Module):
    """2-D Swin UNETR (see the module doc): NCHW images of ``img_size`` x
    ``img_size`` in, :class:`models.unet.UNetOutput` out. Float32 only."""

    # the padding, encoder1 and the patch embedding carry no dropout site:
    # the MC protocol runs them once a batch (engine.steps.mc_forward)
    mc_shared_blocks = 1

    def __init__(self, nb_classes: int = 2, in_channels: int = 4,
                 img_size: int = 240, feature_size: int = 48,
                 depths=(2, 2, 2, 2), heads=(3, 6, 12, 24), window: int = 7,
                 patch: int = 2, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 dropout_path_rate: float = 0.0, use_v2: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(
                f"swin_unetr runs in float32 only, not {dtype}")
        for name, value in (("attn_drop_rate", attn_drop_rate),
                            ("dropout_path_rate", dropout_path_rate)):
            if value:
                raise NotImplementedError(
                    f"swin_unetr {name}={value} is not ported: only 0 "
                    f"(MONAI's default)")
        if use_v2:
            raise NotImplementedError("swin_unetr's v2 blocks (use_v2) are "
                                      "not ported")
        if patch != 2 or len(depths) != 4 or len(heads) != 4 \
                or feature_size % 12 or img_size <= ALIGN \
                or any((feature_size << s) % h for s, h in enumerate(heads)):
            raise ValueError("swin_unetr needs patch 2, four depths and four "
                             "head counts, feature_size a multiple of 12 "
                             "and of each stage's heads, and img_size above "
                             "32 (encoder10's InstanceNorm runs at 1/32 of "
                             "the padded image and needs 2 x 2)")
        self.dtype, self.img_size = dtype, img_size
        fs = feature_size
        self.swinViT = SwinViT(in_channels, fs, patch, tuple(depths),
                               tuple(heads), window, mlp_ratio, drop_rate)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = UnetOutBlock(fs, nb_classes)
        self.reset_parameters_like_flax()
        self.train(False)

    def forward(self, x, generators=None):
        """``generators``: one per MC sample riding the batch (sample-major),
        or None for the deterministic forward."""
        return self.decode_rest(*self.encode_shared(x), generators)

    def encode_shared(self, x):
        """The dropout-free prefix, run once on the images before
        :meth:`decode_rest` fans out over the MC samples: the padding to a
        multiple of 32, ``encoder1`` and the patch embedding. -> (the
        embedding (N, feature_size, H/2, W/2), [encoder1's output])."""
        if tuple(x.shape[2:]) != (self.img_size, self.img_size):
            raise ValueError(f"swin_unetr of img_size {self.img_size} got "
                             f"images of {tuple(x.shape[2:])}")
        with profiling.span("swinunetr.shared"):
            profiling.count("swinunetr.images", x.shape[0])
            pad = -self.img_size % ALIGN
            if pad:
                x = F.pad(x, (0, pad, 0, pad))
            return self.swinViT.patch_embed(x), [self.encoder1(x)]

    def decode_rest(self, embedding, skips, generators=None):
        """``pos_drop``, the Swin stages, the conv encoders and decoders and
        the class head from :meth:`encode_shared`'s outputs (repeated per
        sample), the logits cropped to ``img_size``: every site draws as in
        the full forward, whose outputs these equal."""
        profiling.count("swinunetr.samples", embedding.shape[0])
        with profiling.span("swinunetr.swin", device=embedding.device):
            hs = self.swinViT(embedding, generators)
        with profiling.span("swinunetr.decoder"):
            enc1 = self.encoder2(hs[0])
            enc2 = self.encoder3(hs[1])
            enc3 = self.encoder4(hs[2])
            x = self.decoder5(self.encoder10(hs[4]), hs[3])
            del hs
            x = self.decoder4(x, enc3)
            x = self.decoder3(x, enc2)
            x = self.decoder2(x, enc1)
            x = self.decoder1(x, skips[0])
            logits = self.out(x)
        size = self.img_size
        return UNetOutput(logits[:, :, :size, :size].contiguous())

    def reset_parameters_like_flax(self, generator=None):
        """The train state's initialization (``engine.state``; the name is
        the U-Net's, whose original is flax), MONAI's: every linear and
        every relative position bias table trunc-normal with std 0.02 (cut
        at +-2), biases 0, LayerNorm scale 1 and shift 0, conv kernels
        torch's default ``U(-sqrt(1/fan_in), sqrt(1/fan_in))``. Drawn from
        ``generator`` module by module in registration order. Returns the
        model."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.trunc_normal_(m.weight, std=0.02,
                                          generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                    bound = (1.0 / (m.weight[0].numel())) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, nn.LayerNorm):
                    m.reset_parameters()
                elif isinstance(m, WindowAttention):
                    nn.init.trunc_normal_(m.relative_position_bias_table,
                                          std=0.02, generator=generator)
        return self
