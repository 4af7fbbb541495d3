"""The FLOPs of the 2-D Swin UNETR (MONAI's ``SwinUNETR``, v1 blocks) that
the program runs, counted from its shapes: 2 x the multiply-adds of every
convolution (transposed ones included) and linear layer, and of the window
attention's two matmuls (the scores and their product with the values),
whatever implements them. The work actually done is counted: at the
padded image (240 -> 256), and each block's qkv, attention and out
projection over its grid padded to whole windows (at 256 the four stages'
128, 64, 32 and 16 pad to 133, 70, 35 and 21; a grid no larger than the
window is one window). The padding,
``encoder1`` and the patch embedding run once an image under the MC
protocol; the rest once a sample. Norms, activations, dropout, softmax,
the bias and mask add, rolls and copies are not counted.

``model`` is the configuration's ``swin_unetr`` node with every key given
(``benchmark/configs/brats_swinunetr.json``); ``h`` and ``w`` the image's
size before padding.
"""
from __future__ import annotations

ALIGN = 32


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """2 x multiply-adds of a stride-1 'same' convolution with output h x w
    (or of a k x k stride-k transposed one with output h x w at k = 1)."""
    return 2 * cin * cout * k * k * h * w


def _res_block(cin: int, cout: int, h: int, w: int) -> int:
    """MONAI's ``UnetResBlock``: two 3x3 convs, a 1x1 projection where the
    channels change."""
    total = _conv(cin, cout, 3, h, w) + _conv(cout, cout, 3, h, w)
    return total + (_conv(cin, cout, 1, h, w) if cin != cout else 0)


def padded(size: int) -> int:
    return -(-size // ALIGN) * ALIGN


def shared_flops(model: dict, h: int, w: int) -> int:
    """One image through ``encoder1`` and the patch embedding."""
    h, w = padded(h), padded(w)
    cin, fs, patch = (int(model[k]) for k in ("in_channels", "feature_size",
                                              "patch"))
    return _res_block(cin, fs, h, w) \
        + 2 * cin * fs * patch * patch * (h // patch) * (w // patch)


def windows(size: int, window: int) -> tuple:
    """(window side, padded grid side) of a square grid of ``size``."""
    side = size if size <= window else window
    return side, -(-size // side) * side


def swin_flops(model: dict, h: int, w: int) -> int:
    """One sample through the four stages and their mergings."""
    h, w = padded(h) // int(model["patch"]), padded(w) // int(model["patch"])
    fs, window = int(model["feature_size"]), int(model["window"])
    total = 0
    for s, depth in enumerate(model["depths"]):
        dim, gh, gw = fs << s, h >> s, w >> s
        hidden = int(dim * float(model["mlp_ratio"]))
        side, ph = windows(gh, window)
        _, pw = windows(gw, window)
        tokens, padded_tokens = gh * gw, ph * pw
        block = 2 * padded_tokens * (3 * dim * dim + dim * dim) \
            + 2 * 2 * padded_tokens * side * side * dim \
            + 2 * tokens * 2 * dim * hidden
        total += int(depth) * block
        total += 2 * (tokens // 4) * 4 * dim * 2 * dim  # the merging
    return total


def decoder_flops(model: dict, h: int, w: int) -> int:
    """One sample through ``encoder2``-``4``, ``encoder10``, the five up
    blocks and the class head."""
    h, w = padded(h), padded(w)
    fs, classes = int(model["feature_size"]), int(model["nb_classes"])
    total = _res_block(fs, fs, h >> 1, w >> 1) \
        + _res_block(2 * fs, 2 * fs, h >> 2, w >> 2) \
        + _res_block(4 * fs, 4 * fs, h >> 3, w >> 3) \
        + _res_block(16 * fs, 16 * fs, h >> 5, w >> 5)
    for level, (cin, cout) in zip((4, 3, 2, 1, 0),
                                  ((16 * fs, 8 * fs), (8 * fs, 4 * fs),
                                   (4 * fs, 2 * fs), (2 * fs, fs),
                                   (fs, fs))):
        oh, ow = h >> level, w >> level
        total += _conv(cin, cout, 1, oh, ow)  # the 2x2 stride-2 up-conv
        total += _res_block(2 * cout, cout, oh, ow)
    return total + _conv(fs, classes, 1, h, w)


def sample_flops(model: dict, h: int, w: int) -> int:
    """One MC sample of an image: the Swin stages and the decoder."""
    return swin_flops(model, h, w) + decoder_flops(model, h, w)
