"""The FLOPs of the published TransUNet R50-ViT-B/16 (``github.com/Beckschen/
TransUNet``), counted from its shapes: 2 x the multiply-adds of every
convolution and linear layer, and of the attention's two matmuls (the
scores and their product with the values), whatever implements them. The
trunk (ResNetV2 and the patch embedding) runs once an image under the MC
protocol; the encoder and the decoder once a sample. Norms, activations,
dropout, softmax and the upsampling are not counted.

``model`` is the configuration's ``transunet`` node with every key given
(``benchmark/configs/brats_transunet.json``).
"""
from __future__ import annotations


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """2 x multiply-adds of a convolution with output h x w."""
    return 2 * cin * cout * k * k * h * w


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def trunk_flops(model: dict, h: int, w: int) -> int:
    """One image through the root, the three stages of bottlenecks and the
    patch embedding."""
    width, units = int(model["width"]), model["resnet_units"]
    h, w = _out(h, 7, 2, 3), _out(w, 7, 2, 3)
    total = _conv(int(model["in_channels"]), width, 7, h, w)
    h, w = _out(h, 3, 2, 0), _out(w, 3, 2, 0)  # the max-pool
    cin = width
    for i, n in enumerate(units):
        cmid, cout = width << i, width << (i + 2)
        for u in range(int(n)):
            stride = 2 if u == 0 and i > 0 else 1
            total += _conv(cin, cmid, 1, h, w)
            oh, ow = _out(h, 3, stride, 1), _out(w, 3, stride, 1)
            total += _conv(cmid, cmid, 3, oh, ow)
            total += _conv(cmid, cout, 1, oh, ow)
            if u == 0:  # the projection, at the unit's stride
                total += _conv(cin, cout, 1, oh, ow)
            h, w, cin = oh, ow, cout
    return total + _conv(cin, int(model["hidden"]), 1, h, w)


def encoder_flops(model: dict, h: int, w: int) -> int:
    """One sample through the transformer's blocks: the q, k, v and out
    projections, the MLP and the attention's two matmuls."""
    d, mlp = int(model["hidden"]), int(model["mlp_dim"])
    tokens = (h // 16) * (w // 16)
    per_layer = 2 * tokens * (4 * d * d + 2 * d * mlp) \
        + 2 * 2 * tokens * tokens * d
    return int(model["layers"]) * per_layer


def decoder_flops(model: dict, h: int, w: int) -> int:
    """One sample through ``conv_more``, the four decoder blocks and the
    class head."""
    gh, gw = h // 16, w // 16
    head = int(model["head_channels"])
    channels = list(model["decoder_channels"])
    width, n_skip = int(model["width"]), int(model["n_skip"])
    skips = ([width * 8, width * 4, width] + [0])[:n_skip] \
        + [0] * (4 - n_skip)
    total = _conv(int(model["hidden"]), head, 3, gh, gw)
    cin = head
    for i, (cout, skip) in enumerate(zip(channels, skips)):
        oh, ow = gh << (i + 1), gw << (i + 1)
        total += _conv(cin + skip, cout, 3, oh, ow)
        total += _conv(cout, cout, 3, oh, ow)
        cin = cout
    return total + _conv(cin, int(model["nb_classes"]), 3, gh << 4, gw << 4)


def sample_flops(model: dict, h: int, w: int) -> int:
    """One MC sample of an image: the encoder and the decoder."""
    return encoder_flops(model, h, w) + decoder_flops(model, h, w)
