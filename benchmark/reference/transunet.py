"""TransUNet R50-ViT-B/16 (arXiv:2102.04306; ``github.com/Beckschen/TransUNet``
``networks/vit_seg_modeling.py``, ``networks/vit_seg_modeling_resnet_skip.py``,
``get_r50_b16_config``) in plain PyTorch functional ops, float32, NCHW,
from a dict of weights, with the benchmark's seeded weights and their
calibration. It shares no trunk between MC samples: an MC evaluation is T
full forwards, each with its sample's masks.

Departures from the published code, all forced by the task:
- the root conv takes the configuration's ``in_channels`` (the 4 BraTS
  modalities) where the published model repeats a grayscale image to 3;
- ``img_size`` is the task's (240 for BraTS slices, so a 15 x 15 grid of
  patches of 1 x 1), as the published ``train.py`` derives the grid from
  ``img_size``; ``n_classes`` 2 is the published config's own;
- dropout draws explicit masks: each site, in forward order, draws its
  whole input's keep mask ``rand(x.shape) < 1 - p`` from the sample's
  generator (:class:`Masks`, ``reference.streams.generator``) and computes
  ``where(keep, x / (1 - p), 0)``; a site of p = 0 draws nothing;
- the weights are named as the program names them: the published names,
  but a decoder site's conv ``0`` and BatchNorm ``1`` are ``Conv_0`` and
  ``BatchNorm_0``; q, k and v stay three projections, as published.

BatchNorm runs in ``eval`` mode (running statistics, eps 1e-5) or
``calibrate`` mode (sets the running statistics to the batch's mean and
biased variance, then as ``eval``).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

BN_EPS = 1e-5


class Masks:
    """One sample's dropout draws: each call is the next site's keep mask
    of the input's shape, from the sample's generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, x, keep: float):
        return torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep


def dropout(x, masks, p: float):
    if masks is None or p == 0.0:
        return x
    keep = 1.0 - p
    return torch.where(masks(x, keep), x / keep, 0.0)


def std_conv(w, name, x, stride=1, padding=0):
    weight = w[name + ".weight"]
    var, mean = torch.var_mean(weight, dim=(1, 2, 3), keepdim=True,
                               unbiased=False)
    return F.conv2d(x, (weight - mean) / torch.sqrt(var + 1e-5), None,
                    stride, padding)


def group_norm(w, name, x, groups, eps):
    return F.group_norm(x, groups, w[name + ".weight"], w[name + ".bias"],
                        eps)


def bottleneck(w, name, x, stride):
    """conv1x1 -> GN -> ReLU -> conv3x3 -> GN -> ReLU -> conv1x1 -> GN, plus
    the (projected) input, ReLU."""
    residual = x
    if name + ".downsample.weight" in w:
        proj = std_conv(w, name + ".downsample", x, stride)
        residual = group_norm(w, name + ".gn_proj", proj, proj.shape[1],
                              1e-5)
    y = F.relu(group_norm(w, name + ".gn1", std_conv(w, name + ".conv1", x),
                          32, 1e-6))
    y = F.relu(group_norm(w, name + ".gn2",
                          std_conv(w, name + ".conv2", y, stride, 1), 32,
                          1e-6))
    y = group_norm(w, name + ".gn3", std_conv(w, name + ".conv3", y), 32,
                   1e-6)
    return F.relu(residual + y)


def trunk(w, x, units):
    """ResNetV2: -> (its output, [stage 2, stage 1 padded, root])."""
    prefix = "transformer.embeddings.hybrid_model"
    size = x.shape[2]
    x = F.relu(group_norm(w, prefix + ".root.gn",
                          std_conv(w, prefix + ".root.conv", x, 2, 3), 32,
                          1e-6))
    features = [x]
    x = F.max_pool2d(x, 3, 2)
    for i, n in enumerate(units):
        for u in range(n):
            x = bottleneck(w, f"{prefix}.body.block{i + 1}.unit{u + 1}", x,
                           2 if u == 0 and i > 0 else 1)
        if i < len(units) - 1:
            right = int(size / 4 / (i + 1))
            feat = torch.zeros(x.shape[:2] + (right, right), dtype=x.dtype,
                               device=x.device)
            feat[:, :, :x.shape[2], :x.shape[3]] = x
            features.append(feat)
    return x, features[::-1]


def embeddings(w, x, cfg):
    """-> (the patch tokens plus the position table, the skips)."""
    x, features = trunk(w, x, cfg["resnet_units"])
    prefix = "transformer.embeddings"
    patch = w[prefix + ".patch_embeddings.weight"].shape[-1]
    x = F.conv2d(x, w[prefix + ".patch_embeddings.weight"],
                 w[prefix + ".patch_embeddings.bias"], stride=patch)
    x = x.flatten(2).transpose(-1, -2)
    return x + w[prefix + ".position_embeddings"], features


def linear(w, name, x):
    return F.linear(x, w[name + ".weight"], w[name + ".bias"])


def layer_norm(w, name, x):
    return F.layer_norm(x, x.shape[-1:], w[name + ".weight"],
                        w[name + ".bias"], 1e-6)


def attention(w, name, x, heads, masks, p):
    b, n, d = x.shape

    def split(t):
        return t.view(b, n, heads, d // heads).permute(0, 2, 1, 3)

    q, k, v = (split(linear(w, f"{name}.{part}", x))
               for part in ("query", "key", "value"))
    scores = torch.matmul(q, k.transpose(-1, -2)) / ((d // heads) ** 0.5)
    probs = dropout(torch.softmax(scores, -1), masks, p)
    context = torch.matmul(probs, v).permute(0, 2, 1, 3).reshape(b, n, d)
    return dropout(linear(w, name + ".out", context), masks, p)


def encoder(w, x, cfg, masks):
    x = dropout(x, masks, cfg["dropout"])
    for i in range(cfg["layers"]):
        name = f"transformer.encoder.layer.{i}"
        x = x + attention(w, name + ".attn",
                          layer_norm(w, name + ".attention_norm", x),
                          cfg["heads"], masks, cfg["attention_dropout"])
        h = layer_norm(w, name + ".ffn_norm", x)
        h = dropout(F.gelu(linear(w, name + ".ffn.fc1", h)), masks,
                    cfg["dropout"])
        x = x + dropout(linear(w, name + ".ffn.fc2", h), masks,
                        cfg["dropout"])
    return layer_norm(w, "transformer.encoder.encoder_norm", x)


def batch_norm(w, name, y, mode):
    mean, var = w[name + ".running_mean"], w[name + ".running_var"]
    if mode == "calibrate":
        var_b, mean_b = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
        mean.copy_(mean_b)
        var.copy_(var_b)
    scale = w[name + ".weight"] * torch.rsqrt(var + BN_EPS)
    return (y - mean[:, None, None]) * scale[:, None, None] \
        + w[name + ".bias"][:, None, None]


def conv_bn_relu(w, name, x, mode):
    """conv3x3 without bias -> BatchNorm -> ReLU."""
    y = F.conv2d(x, w[name + ".Conv_0.weight"], None, padding=1)
    return F.relu(batch_norm(w, name + ".BatchNorm_0", y, mode))


def decoder(w, tokens, features, cfg, mode):
    b, n, d = tokens.shape
    g = int(round(n ** 0.5))
    x = conv_bn_relu(w, "decoder.conv_more",
                     tokens.permute(0, 2, 1).contiguous().view(b, d, g, g),
                     mode)
    for i in range(len(cfg["decoder_channels"])):
        x = F.interpolate(x, scale_factor=2, mode="bilinear",
                          align_corners=True)
        if i < cfg["n_skip"]:
            x = torch.cat([x, features[i]], 1)
        x = conv_bn_relu(w, f"decoder.blocks.{i}.conv1", x, mode)
        x = conv_bn_relu(w, f"decoder.blocks.{i}.conv2", x, mode)
    return x


def forward(w: dict, x, cfg: dict, masks=None, mode: str = "eval"):
    """Logits (N, classes, H, W) of the images ``x`` (N, C, H, W), with one
    sample's :class:`Masks` (None: no dropout); ``cfg`` the model's
    settings (the configuration's ``transunet`` node). Float32 or TF32 as
    the caller's switches say (``reference.unet.precision``)."""
    return F.conv2d(features(w, x, cfg, masks, mode),
                    w["segmentation_head.0.weight"],
                    w["segmentation_head.0.bias"], padding=1)


def features(w: dict, x, cfg: dict, masks=None, mode: str = "eval"):
    """The decoder's output (N, decoder_channels[-1], H, W), which the class
    head reads."""
    tokens, skips = embeddings(w, x, cfg)
    return decoder(w, encoder(w, tokens, cfg, masks), skips, cfg, mode)


def leaf_shapes(cfg: dict) -> dict:
    """{name: shape} of every weight of the TransUNet of ``cfg`` (the
    configuration's ``transunet`` node), and every BatchNorm's running
    statistics."""
    shapes = {}
    hidden, width, units = cfg["hidden"], cfg["width"], cfg["resnet_units"]
    grid = cfg["img_size"] // 16
    patch = cfg["img_size"] // 16 // grid

    def conv(name, cout, cin, k, bias=False):
        shapes[name + ".weight"] = (cout, cin, k, k)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def norm(name, c, running=False):
        shapes[name + ".weight"] = shapes[name + ".bias"] = (c,)
        if running:
            shapes[name + ".running_mean"] = \
                shapes[name + ".running_var"] = (c,)

    def dense(name, cout, cin):
        shapes[name + ".weight"] = (cout, cin)
        shapes[name + ".bias"] = (cout,)

    def site(name, cout, cin):
        conv(name + ".Conv_0", cout, cin, 3)
        norm(name + ".BatchNorm_0", cout, running=True)

    emb = "transformer.embeddings"
    shapes[emb + ".position_embeddings"] = (1, grid * grid, hidden)
    body = emb + ".hybrid_model"
    conv(body + ".root.conv", width, cfg["in_channels"], 7)
    norm(body + ".root.gn", width)
    cin = width
    for i, n in enumerate(units):
        cmid, cout = width << i, width << (i + 2)
        for u in range(1, n + 1):
            name = f"{body}.body.block{i + 1}.unit{u}"
            norm(name + ".gn1", cmid)
            conv(name + ".conv1", cmid, cin, 1)
            norm(name + ".gn2", cmid)
            conv(name + ".conv2", cmid, cmid, 3)
            norm(name + ".gn3", cout)
            conv(name + ".conv3", cout, cmid, 1)
            if u == 1:
                conv(name + ".downsample", cout, cin, 1)
                norm(name + ".gn_proj", cout)
            cin = cout
    conv(emb + ".patch_embeddings", hidden, cin, patch, bias=True)
    for i in range(cfg["layers"]):
        name = f"transformer.encoder.layer.{i}"
        norm(name + ".attention_norm", hidden)
        norm(name + ".ffn_norm", hidden)
        dense(name + ".ffn.fc1", cfg["mlp_dim"], hidden)
        dense(name + ".ffn.fc2", hidden, cfg["mlp_dim"])
        for part in ("query", "key", "value", "out"):
            dense(f"{name}.attn.{part}", hidden, hidden)
    norm("transformer.encoder.encoder_norm", hidden)
    site("decoder.conv_more", cfg["head_channels"], hidden)
    ins = [cfg["head_channels"]] + list(cfg["decoder_channels"][:-1])
    skips = [width * 8, width * 4, width, 0][:cfg["n_skip"]] \
        + [0] * (4 - cfg["n_skip"])
    for i, (c, cout, skip) in enumerate(zip(ins, cfg["decoder_channels"],
                                            skips)):
        site(f"decoder.blocks.{i}.conv1", cout, c + skip)
        site(f"decoder.blocks.{i}.conv2", cout, cout)
    conv("segmentation_head.0", cfg["nb_classes"], cfg["decoder_channels"][-1],
         3, bias=True)
    return shapes


def seeded_weights(cfg: dict, generator: torch.Generator, device) -> dict:
    """Seeded weights from ``generator``: out of one uniform draw, every
    linear Xavier-uniform (``U(-sqrt(6 / (fan_in + fan_out)), ..)``, as the
    published ``Mlp`` initializes its own) and every conv kernel
    ``U(-sqrt(1 / fan_in), ..)`` (the trunk's are standardized before use);
    then the position table N(0, 0.02); biases 0; norm scales 1, shifts 0;
    BatchNorm's running mean 0 and variance 1."""
    shapes = leaf_shapes(cfg)
    drawn = [n for n, s in shapes.items()
             if n.endswith(".weight") and len(s) >= 2]
    sizes = [torch.Size(shapes[n]).numel() for n in drawn]
    flat = torch.rand(sum(sizes), generator=generator, device=device)
    w = {}
    for name, part in zip(drawn, torch.split(flat, sizes)):
        shape = shapes[name]
        fan_in = shape[1] * (shape[2] * shape[3] if len(shape) == 4 else 1)
        bound = (6.0 / (fan_in + shape[0])) ** 0.5 if len(shape) == 2 \
            else (1.0 / fan_in) ** 0.5
        w[name] = ((part * 2 - 1) * bound).view(shape)
    pos = "transformer.embeddings.position_embeddings"
    w[pos] = 0.02 * torch.randn(shapes[pos], generator=generator,
                                device=device)
    for name, shape in shapes.items():
        if name not in w:
            ones = name.endswith((".weight", "running_var"))
            w[name] = (torch.ones if ones else torch.zeros)(shape,
                                                            device=device)
    return w


@torch.no_grad()
def calibrate(w: dict, x, cfg: dict, logit_std: float = 2.0,
              background=None, background_logit: float = -8.0):
    """Make seeded inference weights give spread maps, in place: every
    decoder BatchNorm's running statistics become those of its input on
    the images ``x``; then the 3x3 class head is fitted (least squares over
    the pixels of ``x``, on each pixel's 3x3 neighbourhood of features) so
    that its logit difference is the seeded head's, scaled and centred to
    median 0 and standard deviation ``logit_std`` over the foreground
    pixels, and ``background_logit`` on the pixels of ``background`` (an
    (N, H, W) bool mask, or None), as a trained model is sure of the empty
    background; the two logits are minus and plus half the difference."""
    f = features(w, x, cfg, mode="calibrate")
    head_w = w["segmentation_head.0.weight"]
    head_b = w["segmentation_head.0.bias"]
    design = F.unfold(f, 3, padding=1).transpose(1, 2) \
        .reshape(-1, head_w[0].numel()).double()
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
