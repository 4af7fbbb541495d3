"""Swin UNETR (Hatamizadeh et al., arXiv:2201.01266; the published BraTS 2021
run ``github.com/Project-MONAI/research-contributions`` ``SwinUNETR/BRATS21``,
its model MONAI's ``monai/networks/nets/swin_unetr.py`` ``SwinUNETR`` with
v1 blocks, ``normalize=True``, instance norm) in plain PyTorch functional
ops, float32 (TF32 off under ``reference.unet.precision``), from a dict of
weights, with the benchmark's seeded weights and their calibration. Its
attention is explicit (the scores' matmul, the bias and mask added, the
softmax, the matmul with the values), and it shares nothing between MC
samples: an MC evaluation is T full forwards, each with its sample's masks.
It follows MONAI's code step by step, its quirks included: the padded
tokens of a window are not masked, and a grid no larger than the window is
one window whose bias reads the first n x n entries of the window's index.

Departures from the published model, all forced by the task:
- 2-D (``spatial_dims=2``, as MONAI's class takes it), where the published
  run is 3-D on 128^3 patches: this repository evaluates slice by slice;
- 2 classes under a softmax, the repository's binary task, where BraTS 2021
  has 3 sigmoid outputs;
- the image zero-padded at the bottom and right from 240 to 256 (a
  multiple of 32, which the patch and four mergings need) and the logits
  cropped back;
- dropout draws explicit masks: each site, in forward order, draws its
  whole input's keep mask ``rand(x.shape) < 1 - p`` from the sample's
  generator (``reference.transunet.Masks``) and computes ``where(keep, x /
  (1 - p), 0)``; the sites are ``pos_drop`` on the (N, C, H, W)
  embedding, each block's ``proj_drop`` on its (N nW, n, C) windows and
  the MLP's two on (N, H, W, C);
- ``drop_rate`` 0.1, for MC dropout, where MONAI's default is 0
  (``attn_drop_rate`` and ``dropout_path_rate`` stay 0);
- the MLP's linears named ``fc1``/``fc2`` (MONAI: ``linear1``/``linear2``),
  as the program names them.
"""
from __future__ import annotations

import itertools

import torch
from torch.nn import functional as F

from benchmark.reference.transunet import Masks, dropout  # noqa: F401

EPS = 1e-5
# MONAI's SwinUNETR at its BraTS 2021 widths, 2-D, and the task's classes,
# channels and image size
PUBLISHED = {"nb_classes": 2, "in_channels": 4, "img_size": 240,
             "feature_size": 48, "depths": (2, 2, 2, 2),
             "heads": (3, 6, 12, 24), "window": 7, "patch": 2,
             "mlp_ratio": 4.0, "drop_rate": 0.0, "attn_drop_rate": 0.0,
             "dropout_path_rate": 0.0}


def settings(cfg: dict) -> dict:
    """The configuration's ``swin_unetr`` node over the published values."""
    return {**PUBLISHED, **cfg}


def get_window_size(size: int, window: int, shift: int):
    if size <= window:
        return size, 0
    return window, shift


def relative_position_index(window: int):
    coords = torch.stack(torch.meshgrid(torch.arange(window),
                                        torch.arange(window), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def window_partition(x, window: int):
    b, h, w, c = x.shape
    x = x.view(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window * window,
                                                         c)


def window_reverse(windows, window: int, b: int, h: int, w: int):
    x = windows.view(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def compute_mask(h: int, w: int, window: int, shift: int, device):
    """MONAI's ``compute_mask`` in 2-D: (nW, n, n) of 0 and -100."""
    img_mask = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(-window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(-window), slice(-window, -shift),
                   slice(-shift, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    windows = window_partition(img_mask, window).squeeze(-1)
    mask = windows.unsqueeze(1) - windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def linear(w, name, x):
    return F.linear(x, w[name + ".weight"], w.get(name + ".bias"))


def layer_norm(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], EPS)


def window_attention(w, name, x, heads, window, mask, masks, p):
    """MONAI's ``WindowAttention`` on windows ``x`` (B nW, n, C)."""
    b, n, c = x.shape
    qkv = linear(w, name + ".qkv", x).reshape(b, n, 3, heads, c // heads) \
        .permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    q = q * (c // heads) ** -0.5
    attn = q @ k.transpose(-2, -1)
    index = relative_position_index(window).to(x.device)[:n, :n]
    bias = w[name + ".relative_position_bias_table"][index.reshape(-1)] \
        .reshape(n, n, -1).permute(2, 0, 1)
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b // nw, nw, heads, n, n) \
            + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, -1)
    x = (attn @ v).transpose(1, 2).reshape(b, n, c)
    return dropout(linear(w, name + ".proj", x), masks, p)


def swin_block(w, name, x, heads, window, shift, mask, masks, p):
    """MONAI's ``SwinTransformerBlock`` on (B, H, W, C)."""
    shortcut = x
    x = layer_norm(w, name + ".norm1", x)
    b, h, wd, c = x.shape
    ws, ss = get_window_size(h, window, shift)
    pad_b, pad_r = (ws - h % ws) % ws, (ws - wd % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
    _, hp, wp, _ = x.shape
    if ss > 0:
        x = torch.roll(x, shifts=(-ss, -ss), dims=(1, 2))
    windows = window_partition(x, ws)
    # the bias reads the configured window's index, as MONAI's does
    windows = window_attention(w, name + ".attn", windows, heads, window,
                               mask if ss > 0 else None, masks, p)
    x = window_reverse(windows.view(-1, ws, ws, c), ws, b, hp, wp)
    if ss > 0:
        x = torch.roll(x, shifts=(ss, ss), dims=(1, 2))
    x = shortcut + x[:, :h, :wd, :].contiguous()
    y = layer_norm(w, name + ".norm2", x)
    y = dropout(F.gelu(linear(w, name + ".mlp.fc1", y)), masks, p)
    return x + dropout(linear(w, name + ".mlp.fc2", y), masks, p)


def patch_merging(w, name, x):
    """MONAI's ``PatchMerging`` in 2-D on (B, H, W, C)."""
    h, wd = x.shape[1:3]
    if h % 2 == 1 or wd % 2 == 1:
        x = F.pad(x, (0, 0, 0, wd % 2, 0, h % 2))
    x = torch.cat([x[:, j::2, i::2, :] for i, j
                   in itertools.product(range(2), range(2))], -1)
    return linear(w, name + ".reduction",
                  layer_norm(w, name + ".norm", x))


def basic_layer(w, name, x, cfg, stage, masks):
    """MONAI's ``BasicLayer`` on NCHW -> NCHW."""
    window, heads = cfg["window"], cfg["heads"][stage]
    b, c, h, wd = x.shape
    ws, ss = get_window_size(h, window, window // 2)
    x = x.permute(0, 2, 3, 1)
    hp, wp = -(-h // ws) * ws, -(-wd // ws) * ws
    mask = compute_mask(hp, wp, ws, ss, x.device) if ss > 0 else None
    for i in range(cfg["depths"][stage]):
        x = swin_block(w, f"{name}.blocks.{i}", x, heads, window,
                       0 if i % 2 == 0 else window // 2, mask, masks,
                       cfg["drop_rate"])
    x = patch_merging(w, name + ".downsample", x.view(b, h, wd, -1))
    return x.permute(0, 3, 1, 2)


def proj_out(x):
    x = x.permute(0, 2, 3, 1)
    return F.layer_norm(x, x.shape[-1:]).permute(0, 3, 1, 2)


def swin_vit(w, x, cfg, masks):
    """The five hidden states of the padded images ``x``."""
    x = F.conv2d(x, w["swinViT.patch_embed.proj.weight"],
                 w["swinViT.patch_embed.proj.bias"], stride=cfg["patch"])
    x = dropout(x, masks, cfg["drop_rate"])
    states = [proj_out(x)]
    for stage in range(4):
        x = basic_layer(w, f"swinViT.layers{stage + 1}.0", x, cfg, stage,
                        masks)
        states.append(proj_out(x))
    return states


def instance_norm(x):
    var, mean = torch.var_mean(x, dim=(2, 3), keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + EPS)


def conv(w, name, x):
    weight = w[name + ".conv.weight"]
    return F.conv2d(x, weight, w.get(name + ".conv.bias"),
                    padding=weight.shape[-1] // 2)


def res_block(w, name, x):
    """MONAI's ``UnetResBlock``: conv3x3, IN, lrelu, conv3x3, IN, plus the
    (projected) input, lrelu."""
    out = F.leaky_relu(instance_norm(conv(w, name + ".conv1", x)), 0.01)
    out = instance_norm(conv(w, name + ".conv2", out))
    if name + ".conv3.conv.weight" in w:
        x = instance_norm(conv(w, name + ".conv3", x))
    return F.leaky_relu(out + x, 0.01)


def up_block(w, name, x, skip):
    """MONAI's ``UnetrUpBlock``: a 2x2 stride-2 transposed conv, the skip
    concatenated, a residual block."""
    x = F.conv_transpose2d(x, w[name + ".transp_conv.conv.weight"], None,
                           stride=2)
    return res_block(w, name + ".conv_block", torch.cat((x, skip), 1))


def padded(x, cfg):
    pad = -cfg["img_size"] % 32
    return F.pad(x, (0, pad, 0, pad))


def features(w: dict, x, cfg: dict, masks=None):
    """``decoder1``'s output (N, feature_size, H, W) on the images ``x`` (N,
    C, img_size, img_size), cropped to ``img_size``: what the class head
    reads."""
    cfg = settings(cfg)
    x_in = padded(x, cfg)
    hs = swin_vit(w, x_in, cfg, masks)
    enc0 = res_block(w, "encoder1.layer", x_in)
    enc1 = res_block(w, "encoder2.layer", hs[0])
    enc2 = res_block(w, "encoder3.layer", hs[1])
    enc3 = res_block(w, "encoder4.layer", hs[2])
    dec4 = res_block(w, "encoder10.layer", hs[4])
    dec3 = up_block(w, "decoder5", dec4, hs[3])
    dec2 = up_block(w, "decoder4", dec3, enc3)
    dec1 = up_block(w, "decoder3", dec2, enc2)
    dec0 = up_block(w, "decoder2", dec1, enc1)
    out = up_block(w, "decoder1", dec0, enc0)
    size = cfg["img_size"]
    return out[:, :, :size, :size]


def forward(w: dict, x, cfg: dict, masks=None):
    """Logits (N, classes, H, W) of the images ``x`` (N, C, img_size,
    img_size), with one sample's :class:`Masks` (None: no dropout); ``cfg``
    the configuration's ``swin_unetr`` node. Float32 or TF32 as the
    caller's switches say (``reference.unet.precision``)."""
    return F.conv2d(features(w, x, cfg, masks), w["out.conv.conv.weight"],
                    w["out.conv.conv.bias"])


def leaf_shapes(cfg: dict) -> dict:
    """{name: shape} of every weight of the Swin UNETR of ``cfg``."""
    cfg = settings(cfg)
    fs, window = cfg["feature_size"], cfg["window"]
    shapes = {}

    def conv_leaf(name, cout, cin, k, bias=False, transposed=False):
        shapes[name + ".conv.weight"] = (cin, cout, k, k) if transposed \
            else (cout, cin, k, k)
        if bias:
            shapes[name + ".conv.bias"] = (cout,)

    def norm(name, c):
        shapes[name + ".weight"] = shapes[name + ".bias"] = (c,)

    def dense(name, cout, cin, bias=True):
        shapes[name + ".weight"] = (cout, cin)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def res(name, cin, cout):
        conv_leaf(name + ".conv1", cout, cin, 3)
        conv_leaf(name + ".conv2", cout, cout, 3)
        if cin != cout:
            conv_leaf(name + ".conv3", cout, cin, 1)

    patch = cfg["patch"]
    shapes["swinViT.patch_embed.proj.weight"] = (fs, cfg["in_channels"],
                                                 patch, patch)
    shapes["swinViT.patch_embed.proj.bias"] = (fs,)
    for s, (depth, heads) in enumerate(zip(cfg["depths"], cfg["heads"])):
        dim, layer = fs << s, f"swinViT.layers{s + 1}.0"
        hidden = int(dim * cfg["mlp_ratio"])
        for i in range(depth):
            block = f"{layer}.blocks.{i}"
            norm(block + ".norm1", dim)
            shapes[block + ".attn.relative_position_bias_table"] = (
                (2 * window - 1) ** 2, heads)
            dense(block + ".attn.qkv", 3 * dim, dim)
            dense(block + ".attn.proj", dim, dim)
            norm(block + ".norm2", dim)
            dense(block + ".mlp.fc1", hidden, dim)
            dense(block + ".mlp.fc2", dim, hidden)
        dense(layer + ".downsample.reduction", 2 * dim, 4 * dim, bias=False)
        norm(layer + ".downsample.norm", 4 * dim)
    res("encoder1.layer", cfg["in_channels"], fs)
    for name, c in (("encoder2", fs), ("encoder3", 2 * fs),
                    ("encoder4", 4 * fs), ("encoder10", 16 * fs)):
        res(name + ".layer", c, c)
    for name, cin, cout in (("decoder5", 16 * fs, 8 * fs),
                            ("decoder4", 8 * fs, 4 * fs),
                            ("decoder3", 4 * fs, 2 * fs),
                            ("decoder2", 2 * fs, fs), ("decoder1", fs, fs)):
        conv_leaf(name + ".transp_conv", cout, cin, 2, transposed=True)
        res(name + ".conv_block", 2 * cout, cout)
    conv_leaf("out.conv", cfg["nb_classes"], fs, 1, bias=True)
    return shapes


def seeded_weights(cfg: dict, generator: torch.Generator, device) -> dict:
    """Seeded weights from ``generator``, MONAI's initialization: out of one
    uniform draw every conv kernel ``U(-sqrt(1 / fan_in), ..)`` (torch's
    default; a transposed kernel (in, out, k, k) has fan_in out k k); out
    of one normal draw every linear and every relative position bias table
    N(0, 0.02) (MONAI's trunc-normal cuts at +-2, 100 standard deviations,
    which no draw reaches); biases 0; LayerNorm scales 1, shifts 0."""
    shapes = leaf_shapes(cfg)
    kernels = [n for n, s in shapes.items() if len(s) == 4]
    normal = [n for n, s in shapes.items()
              if len(s) == 2 and n.endswith((".weight", "_table"))]
    w = {}
    for names, draw in ((kernels, torch.rand), (normal, torch.randn)):
        sizes = [torch.Size(shapes[n]).numel() for n in names]
        flat = draw(sum(sizes), generator=generator, device=device)
        for name, part in zip(names, torch.split(flat, sizes)):
            shape = shapes[name]
            if len(shape) == 4:
                bound = (1.0 / (shape[1] * shape[2] * shape[3])) ** 0.5
                w[name] = ((part * 2 - 1) * bound).view(shape)
            else:
                w[name] = (0.02 * part).view(shape)
    for name, shape in shapes.items():
        if name not in w:
            w[name] = (torch.ones if name.endswith(".weight")
                       else torch.zeros)(shape, device=device)
    return w


@torch.no_grad()
def calibrate(w: dict, x, cfg: dict, logit_std: float = 2.0,
              background=None, background_logit: float = -8.0):
    """Make seeded inference weights give spread maps, in place: the 1x1
    class head is fitted (least squares over the pixels of ``x``) so that
    its logit difference is the seeded head's, scaled and centred to
    median 0 and standard deviation ``logit_std`` over the foreground
    pixels, and ``background_logit`` on the pixels of ``background`` (an
    (N, H, W) bool mask, or None), as a trained model is sure of the empty
    background; the two logits are minus and plus half the difference.
    InstanceNorm keeps no statistics to calibrate."""
    f = features(w, x, cfg)
    head_w, head_b = w["out.conv.conv.weight"], w["out.conv.conv.bias"]
    design = f.permute(0, 2, 3, 1).reshape(-1, f.shape[1]).double()
    diff = design @ (head_w[1] - head_w[0]).reshape(-1).double() \
        + float(head_b[1] - head_b[0])
    bg = torch.zeros_like(diff, dtype=torch.bool) if background is None \
        else background.reshape(-1).to(diff.device)
    fg = diff[~bg]
    target = (diff - fg.median()) * (logit_std / fg.std())
    target = torch.where(bg, torch.full_like(target, background_logit),
                         target)
    design = torch.cat([design, torch.ones_like(design[:, :1])], 1)
    theta = torch.linalg.lstsq(design.cpu(), target[:, None].cpu()).solution
    theta = theta[:, 0].to(head_w.device, head_w.dtype) / 2
    head_w.copy_(torch.stack([-theta[:-1], theta[:-1]]).view_as(head_w))
    head_b.copy_(torch.stack([-theta[-1], theta[-1]]))
