"""TransUNet R50-ViT-B/16 (arXiv:2102.04306; ``github.com/Beckschen/TransUNet``
``networks/vit_seg_modeling.py``, ``networks/vit_seg_modeling_resnet_skip.py``,
``get_r50_b16_config``) in plain PyTorch functional ops, float32, NCHW,
from a dict of weights: the reference that the tests hold
``rcu_tpu_torch.models.transunet`` to. It imports neither JAX nor anything
of ``rcu_tpu_torch``, and shares no trunk between MC samples: an MC
evaluation is T full forwards, each with its sample's masks.

Departures from the published code, all forced by the task:
- the root conv takes ``in_channels`` images (the 4 BraTS modalities) where
  the published model repeats a grayscale image to 3 channels;
- ``img_size`` is the task's (240 for BraTS slices, so a 15 x 15 grid of
  patches of 1 x 1), as the published ``train.py`` derives the grid from
  ``img_size``; ``n_classes`` 2 is the published config's own;
- dropout draws explicit masks: each site, in forward order, draws its
  whole input's keep mask ``rand(x.shape) < 1 - p`` from the sample's
  generator (:class:`Masks`) and computes ``where(keep, x / (1 - p), 0)``;
  a site of p = 0 draws nothing;
- the weights are named as the port names them: the published ones, but a
  decoder site's conv ``0`` and BatchNorm ``1`` are ``Conv_0`` and
  ``BatchNorm_0``; q, k and v stay three projections, as published;
- BatchNorm in ``train`` mode normalizes with the batch's mean and biased
  variance, as torch's does, and updates no running statistics.

BatchNorm runs in one of three modes: ``eval`` (running statistics, eps
1e-5), ``train`` (the batch's) and ``calibrate`` (sets the running
statistics to the batch's, then as ``eval``). Both TF32 switches are off
while a forward runs (:func:`full_float32`).
"""
from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

BN_EPS = 1e-5
# get_r50_b16_config, and the task's image size, channels and classes
PUBLISHED = {"nb_classes": 2, "in_channels": 3, "img_size": 224,
             "hidden": 768, "mlp_dim": 3072, "heads": 12, "layers": 12,
             "resnet_units": (3, 4, 9), "width": 64,
             "decoder_channels": (256, 128, 64, 16), "head_channels": 512,
             "n_skip": 3, "dropout": 0.1, "attention_dropout": 0.0}


@contextlib.contextmanager
def full_float32():
    """Both TF32 switches off within the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Masks:
    """One sample's dropout draws: each call is the next site's keep mask
    of the input's shape, from the sample's generator."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.drawn = []  # every mask drawn, in order

    def __call__(self, x, keep: float):
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        self.drawn.append(mask)
        return mask


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
    if mode != "eval":
        var_b, mean_b = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
        if mode == "calibrate":
            mean.copy_(mean_b.detach())
            var.copy_(var_b.detach())
        else:
            mean, var = mean_b, var_b
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
    settings (:data:`PUBLISHED`'s keys)."""
    cfg = {**PUBLISHED, **cfg}
    with full_float32():
        tokens, features = embeddings(w, x, cfg)
        features = decoder(w, encoder(w, tokens, cfg, masks), features, cfg,
                           mode)
        return F.conv2d(features, w["segmentation_head.0.weight"],
                        w["segmentation_head.0.bias"], padding=1)
