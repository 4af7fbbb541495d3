"""TransUNet, R50-ViT-B/16 (Chen et al., "TransUNet: Transformers Make Strong
Encoders for Medical Image Segmentation", arXiv:2102.04306; the published
code is ``github.com/Beckschen/TransUNet``, ``networks/vit_seg_modeling.py``,
``networks/vit_seg_modeling_resnet_skip.py`` and ``get_r50_b16_config`` of
``networks/vit_seg_configs.py``), a model of the port's MC-dropout path.

- Trunk (ResNetV2, no dropout): weight-standardized convs
  (:class:`StdConv2d`); the root's 7x7 stride-2 conv, GroupNorm(32, eps
  1e-6) and ReLU, then a 3x3 stride-2 max-pool; three stages of post-norm
  bottlenecks (``resnet_units``), each conv1x1 -> GN -> ReLU -> conv3x3
  (stride 2 on the first unit of stages 2-3) -> GN -> ReLU -> conv1x1 -> GN,
  plus the residual (a 1x1 projection and ``GroupNorm(cout, cout)`` where
  the shape changes), then ReLU. A stage output off its size (img/4, img/8)
  by less than 3 is zero-padded at the bottom and right as the published
  ``ResNetV2.forward`` pads it. The root's output and stages 1-2's are the
  decoder's skips.
- Patch embedding: a conv of kernel and stride ``img_size // 16 // grid``
  (1 at the published grid of ``img_size // 16``) to ``hidden``, plus a
  learned position table.
- Encoder: dropout on the embeddings, ``layers`` pre-norm blocks ``x +=
  Attn(LN(x)); x += MLP(LN(x))`` (LayerNorm eps 1e-6; ``heads`` heads,
  q, k, v and out projections with bias, attention dropout
  ``attention_dropout``, which the published config also applies after
  the out projection; MLP ``hidden -> mlp_dim``, exact GELU, dropout,
  ``mlp_dim -> hidden``, dropout), a final LayerNorm.
- Decoder (``DecoderCup``): the tokens as a (hidden, g, g) map; conv3x3 to
  ``head_channels`` -> BN -> ReLU (``conv_more``); four blocks, each a
  bilinear 2x upsample (align_corners=True; channels-last where it fits,
  :func:`_upsampled`), the skip concatenated (the
  first ``n_skip``), two conv3x3 -> BN -> ReLU; a conv3x3 class head. The
  decoder's conv -> BN -> ReLU sites are the U-Net's ``ConvBnRelu`` without
  a conv bias and without dropout, so in f32 eval on a card their epilogue
  is the fused kernel (``ops.cuda.convepilogue``).

Module names are the published ones where the port's structure allows
(``transformer.embeddings.hybrid_model.root.conv``,
``transformer.encoder.layer.N.attn.query``, ``decoder.conv_more``,
``decoder.blocks.N.conv1``, ``segmentation_head.0``), so that an importer of
the published checkpoints is a rename table: a decoder site's ``Conv_0`` and
``BatchNorm_0`` are the published ``0`` and ``1``.

Dropout is element-wise (:class:`ElementDropout`), active when the forward
gets ``generators``, one per MC sample riding the batch sample-major: each
site draws sample ``t``'s mask of its whole batch from ``generators[t]``,
in the order of the sites in the forward pass, and computes
``where(keep, x / (1 - p), 0)``. A site of p = 0 draws nothing. The trunk
has no dropout site, so the MC protocol (``engine.steps.mc_forward``) runs
it once a batch (:meth:`TransUNet.encode_shared`) and only the encoder and
decoder once a sample (:meth:`TransUNet.decode_rest`), with the outputs of
the full forward. The decoder's BatchNorm uses its running statistics in
eval mode, under MC dropout too; in train mode the batch's, as the U-Net's
``ConvBnRelu`` computes them (flax's biased variance; the published
``nn.BatchNorm2d`` updates its running variance with the unbiased one).

While a profiler runs the model records the spans ``transunet.trunk`` (a
batch's trunk), ``transunet.encoder`` (with its device seconds,
``utils.profiling.device_seconds``) and ``transunet.decoder``, and counts
``transunet.trunk_images``, ``transunet.samples`` (images through the
encoder and decoder) and ``transunet.dropout_elements`` (elements masked).
"""
from __future__ import annotations

import collections

import torch
from torch import nn
from torch.nn import functional as F

from rcu_tpu_torch.engine import remat
from rcu_tpu_torch.models.unet import ConvBnRelu, UNetOutput, conv2d
from rcu_tpu_torch.utils import profiling


def standardized(weight, eps: float = 1e-5):
    """A conv kernel standardized over (cin, kh, kw) with its biased
    variance: ``StdConv2d``'s weight."""
    var, mean = torch.var_mean(weight, dim=(1, 2, 3), keepdim=True,
                               unbiased=False)
    return (weight - mean) / torch.sqrt(var + eps)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` run by ``models.unet.conv2d``, as every conv of the
    model is."""

    def forward(self, x):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding)


class StdConv2d(Conv2d):
    """The published weight-standardized conv (no bias in the trunk)."""

    def forward(self, x):
        return conv2d(x, standardized(self.weight), self.bias, self.stride,
                      self.padding)


DROPOUT_COUNTER = "transunet.dropout_elements"


class ElementDropout(nn.Module):
    """Element-wise dropout with explicit generators (see the module doc),
    counting the elements it masks under ``counter``, the owning model's
    name for it. Generators with ``rows=(start, stop, total)`` (a mesh
    device's part of a batch, ``engine.steps.ShardGenerators``) draw the
    whole batch's masks and keep those rows, as
    ``models.unet.ChannelDropout`` does."""

    def __init__(self, p: float, counter: str):
        super().__init__()
        self.p, self.counter = p, counter

    def forward(self, x, generators=None):
        if generators is None or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        # drawn once: a remat rerun replays the forward's masks
        keep = remat.replayed(lambda: self._keep(x, generators, keep_prob))
        profiling.count(self.counter, x.numel())
        return torch.where(keep, x / keep_prob, 0.0)

    @staticmethod
    def _keep(x, generators, keep_prob):
        n = x.shape[0] // len(generators)
        start, stop, total = getattr(generators, "rows", (0, n, n))
        if stop - start != n:
            raise ValueError(f"generators for rows {start}:{stop} of a "
                             f"batch, but the input has {n} rows a sample")
        return torch.cat([torch.rand((total,) + tuple(x.shape[1:]),
                                     generator=g, device=x.device)[start:stop]
                          < keep_prob for g in generators])


class PreActBottleneck(nn.Module):
    """The published bottleneck unit (post-norm despite its name)."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.gn1 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv1 = StdConv2d(cin, cmid, 1, bias=False)
        self.gn2 = nn.GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride=stride, padding=1,
                               bias=False)
        self.gn3 = nn.GroupNorm(32, cout, eps=1e-6)
        self.conv3 = StdConv2d(cmid, cout, 1, bias=False)
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride=stride,
                                        bias=False)
            self.gn_proj = nn.GroupNorm(cout, cout)

    def forward(self, x):
        residual = x
        if hasattr(self, "downsample"):
            residual = self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


def _stage(cin: int, cout: int, cmid: int, units: int, stride: int):
    return nn.Sequential(collections.OrderedDict(
        [("unit1", PreActBottleneck(cin, cout, cmid, stride))]
        + [(f"unit{i}", PreActBottleneck(cout, cout, cmid))
           for i in range(2, units + 1)]))


def _padded(x, size):
    """``x`` zero-padded at the bottom and right to ``size`` (h, w), as the
    published trunk pads a stage output off its size by 1 or 2."""
    pad_h, pad_w = size[0] - x.shape[2], size[1] - x.shape[3]
    if not (0 <= pad_h < 3 and 0 <= pad_w < 3):
        raise ValueError(f"a trunk stage of {tuple(x.shape[2:])} for a skip "
                         f"of {tuple(size)}")
    return F.pad(x, (0, pad_w, 0, pad_h)) if pad_h or pad_w else x


class ResNetV2(nn.Module):
    """The hybrid trunk: -> (its output, the skips finest last)."""

    def __init__(self, in_channels: int, units, width: int):
        super().__init__()
        self.root = nn.Sequential(collections.OrderedDict([
            ("conv", StdConv2d(in_channels, width, 7, stride=2, padding=3,
                               bias=False)),
            ("gn", nn.GroupNorm(32, width, eps=1e-6)),
            ("relu", nn.ReLU())]))
        self.body = nn.Sequential(collections.OrderedDict([
            ("block1", _stage(width, width * 4, width, units[0], 1)),
            ("block2", _stage(width * 4, width * 8, width * 2, units[1], 2)),
            ("block3", _stage(width * 8, width * 16, width * 4, units[2],
                              2))]))

    def forward(self, x):
        h, w = x.shape[2:]
        x = self.root(x)
        skips = [x]
        x = F.max_pool2d(x, 3, stride=2)
        for i, stage in enumerate(self.body[:-1]):
            x = stage(x)
            skips.append(_padded(x, (int(h / 4 / (i + 1)),
                                     int(w / 4 / (i + 1)))))
        return self.body[-1](x), skips[::-1]


class Embeddings(nn.Module):
    """The trunk, the patch embedding, the position table and the
    embeddings' dropout."""

    def __init__(self, in_channels: int, img_size: int, hidden: int, units,
                 width: int, dropout: float):
        super().__init__()
        grid = img_size // 16
        patch = img_size // 16 // grid
        self.hybrid_model = ResNetV2(in_channels, units, width)
        self.patch_embeddings = Conv2d(width * 16, hidden, patch,
                                       stride=patch)
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, grid * grid, hidden))
        self.dropout = ElementDropout(dropout, DROPOUT_COUNTER)

    def forward(self, x):
        """Images -> (the tokens plus positions, before the dropout; the
        skips)."""
        x, skips = self.hybrid_model(x)
        x = self.patch_embeddings(x).flatten(2).transpose(1, 2)
        return x + self.position_embeddings, skips


class Attention(nn.Module):
    def __init__(self, hidden: int, heads: int, dropout: float):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.out = nn.Linear(hidden, hidden)
        self.attn_dropout = ElementDropout(dropout, DROPOUT_COUNTER)
        self.proj_dropout = ElementDropout(dropout, DROPOUT_COUNTER)

    def _heads(self, x):
        b, n, d = x.shape
        return x.view(b, n, self.heads, d // self.heads).transpose(1, 2)

    def forward(self, x, generators=None):
        """softmax(q k^T / sqrt(d)) v: one fused kernel
        (``F.scaled_dot_product_attention``; on a card in float32 its
        memory-efficient backend, faster than the two batched matmuls at
        the cell's shape, PERF.md §6) where no dropout acts on the
        probabilities, else the matmuls with the probabilities' dropout
        between them."""
        q, k, v = (self._heads(f(x)) for f in (self.query, self.key,
                                               self.value))
        if generators is None or self.attn_dropout.p == 0.0:
            context = F.scaled_dot_product_attention(q, k, v)
        else:
            scores = q @ k.transpose(-1, -2) / (q.shape[-1] ** 0.5)
            context = self.attn_dropout(torch.softmax(scores, -1),
                                        generators) @ v
        return self.proj_dropout(self.out(context.transpose(1, 2).flatten(2)),
                                 generators)


class Mlp(nn.Module):
    """Linear, exact GELU, dropout, linear, dropout; the dropout counts under
    ``counter`` (:class:`ElementDropout`)."""

    def __init__(self, hidden: int, mlp_dim: int, dropout: float,
                 counter: str):
        super().__init__()
        self.fc1 = nn.Linear(hidden, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, hidden)
        self.dropout = ElementDropout(dropout, counter)

    def forward(self, x, generators=None):
        x = self.dropout(F.gelu(self.fc1(x)), generators)
        return self.dropout(self.fc2(x), generators)


class Block(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, heads: int, dropout: float,
                 attention_dropout: float):
        super().__init__()
        self.attention_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn_norm = nn.LayerNorm(hidden, eps=1e-6)
        self.ffn = Mlp(hidden, mlp_dim, dropout, DROPOUT_COUNTER)
        self.attn = Attention(hidden, heads, attention_dropout)

    def forward(self, x, generators=None):
        x = x + self.attn(self.attention_norm(x), generators)
        return x + self.ffn(self.ffn_norm(x), generators)


class Encoder(nn.Module):
    def __init__(self, hidden: int, mlp_dim: int, heads: int, layers: int,
                 dropout: float, attention_dropout: float):
        super().__init__()
        self.layer = nn.ModuleList(
            Block(hidden, mlp_dim, heads, dropout, attention_dropout)
            for _ in range(layers))
        self.encoder_norm = nn.LayerNorm(hidden, eps=1e-6)

    def forward(self, x, generators=None):
        for block in self.layer:
            x = block(x, generators)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, in_channels, img_size, hidden, mlp_dim, heads, layers,
                 units, width, dropout, attention_dropout):
        super().__init__()
        self.embeddings = Embeddings(in_channels, img_size, hidden, units,
                                     width, dropout)
        self.encoder = Encoder(hidden, mlp_dim, heads, layers, dropout,
                               attention_dropout)


def _upsampled(x):
    """Bilinear 2x (align_corners=True) of the NCHW ``x``, returned NCHW
    (which the next site's fused epilogue takes). Computed channels-last
    where the output fits that kernel (fewer than 2^31 - 1 elements):
    torch's NCHW kernel runs a thread an output pixel over every (image,
    channel) plane, which at the decoder's first blocks leaves the card
    nearly idle (640 x 512 planes of 15 x 15: 123 ms against 5.5 ms with
    the copies, on an H100, PERF.md §6)."""
    if 4 * x.numel() < 2 ** 31 - 1:
        x = x.contiguous(memory_format=torch.channels_last)
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True).contiguous()


class DecoderBlock(nn.Module):
    def __init__(self, cin: int, cout: int, skip: int):
        super().__init__()
        self.conv1 = ConvBnRelu(cin + skip, cout, bias=False)
        self.conv2 = ConvBnRelu(cout, cout, bias=False)

    def forward(self, x, skip=None):
        x = _upsampled(x)
        if skip is not None:
            x = torch.cat([x, skip], 1)
        return self.conv2(self.conv1(x))


class DecoderCup(nn.Module):
    def __init__(self, hidden: int, head_channels: int, decoder_channels,
                 skip_channels):
        super().__init__()
        self.conv_more = ConvBnRelu(hidden, head_channels, bias=False)
        ins = [head_channels] + list(decoder_channels[:-1])
        self.blocks = nn.ModuleList(
            DecoderBlock(cin, cout, skip) for cin, cout, skip
            in zip(ins, decoder_channels, skip_channels))

    def forward(self, tokens, skips):
        b, n, d = tokens.shape
        g = int(round(n ** 0.5))
        # NCHW: the tokens' transposed view is channels-last, which would
        # keep conv_more off the fused epilogue (ConvBnRelu.fuses_epilogue)
        x = self.conv_more(tokens.transpose(1, 2).reshape(b, d, g, g)
                           .contiguous())
        for i, block in enumerate(self.blocks):
            x = block(x, skips[i] if i < len(skips) else None)
        return x


class TransUNet(nn.Module):
    """R50-ViT-B/16 TransUNet (see the module doc): NCHW images of
    ``img_size`` x ``img_size`` in, :class:`models.unet.UNetOutput` out.
    Float32 only."""

    # the trunk and the patch embedding carry no dropout site: the MC
    # protocol runs them once a batch (engine.steps.mc_forward)
    mc_shared_blocks = 1

    def __init__(self, nb_classes: int = 2, in_channels: int = 3,
                 img_size: int = 224, hidden: int = 768, mlp_dim: int = 3072,
                 heads: int = 12, layers: int = 12,
                 resnet_units=(3, 4, 9), width: int = 64,
                 decoder_channels=(256, 128, 64, 16),
                 head_channels: int = 512, n_skip: int = 3,
                 dropout: float = 0.1, attention_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype != torch.float32:
            raise NotImplementedError(
                f"transunet runs in float32 only, not {dtype}")
        if img_size % 16 or hidden % heads or len(decoder_channels) != 4 \
                or not 0 <= n_skip <= 3:
            raise ValueError("transunet needs img_size a multiple of 16, "
                             "hidden a multiple of heads, four decoder "
                             "channels and n_skip in [0, 3]")
        self.dtype = dtype
        self.n_skip = n_skip
        self.transformer = Transformer(
            in_channels, img_size, hidden, mlp_dim, heads, layers,
            tuple(resnet_units), width, dropout, attention_dropout)
        skips = (width * 8, width * 4, width, 0)[:n_skip] + (0,) * (4 - n_skip)
        self.decoder = DecoderCup(hidden, head_channels,
                                  tuple(decoder_channels), skips)
        self.segmentation_head = nn.Sequential(
            Conv2d(decoder_channels[-1], nb_classes, 3, padding=1))
        self.reset_parameters_like_flax()
        self.train(False)

    def forward(self, x, generators=None):
        """``generators``: one per MC sample riding the batch (sample-major),
        or None for the deterministic forward."""
        return self.decode_rest(*self.encode_shared(x), generators)

    def encode_shared(self, x):
        """The dropout-free trunk, patch embedding and position add, run
        once on the images before :meth:`decode_rest` fans out over the MC
        samples. -> (embeddings (N, tokens, hidden), skips)."""
        with profiling.span("transunet.trunk"):
            profiling.count("transunet.trunk_images", x.shape[0])
            embeddings, skips = self.transformer.embeddings(x)
            return embeddings, skips[:self.n_skip]

    def decode_rest(self, embeddings, skips, generators=None):
        """The embeddings' dropout, the encoder, the decoder and the head
        from :meth:`encode_shared`'s outputs (repeated per sample): every
        site draws as in the full forward, whose outputs these equal."""
        profiling.count("transunet.samples", embeddings.shape[0])
        with profiling.span("transunet.encoder", device=embeddings.device):
            x = self.transformer.embeddings.dropout(embeddings, generators)
            x = self.transformer.encoder(x, generators)
        with profiling.span("transunet.decoder"):
            logits = self.segmentation_head(self.decoder(x, skips))
        return UNetOutput(logits)

    def reset_parameters_like_flax(self, generator=None):
        """The train state's initialization (``engine.state``; the name is
        the U-Net's, whose original is flax): every linear Xavier-uniform
        with zero bias, as the published ``Mlp`` initializes its own (its
        bias N(0, 1e-6) aside); every conv kernel U(-sqrt(1/fan_in),
        sqrt(1/fan_in)) (the trunk's are standardized before use) with zero
        bias; the position table N(0, 0.02); norms scale 1, shift 0, and
        BatchNorm's running statistics 0 and 1. Drawn from ``generator``
        module by module in registration order. Returns the model."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    nn.init.xavier_uniform_(m.weight, generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.Conv2d):
                    bound = (1.0 / (m.weight[0].numel())) ** 0.5
                    m.weight.uniform_(-bound, bound, generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()
                elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm,
                                    nn.LayerNorm)):
                    m.reset_parameters()
            self.transformer.embeddings.position_embeddings.normal_(
                0.0, 0.02, generator=generator)
        return self
