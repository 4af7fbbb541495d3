"""The yardstick's arithmetic: published peaks of one NVIDIA H100, the
convolution FLOPs of the U-Net counted from its shapes, and the bytes of
the eval reduction kernel.

The FLOPs are 2 x the multiply-adds of every convolution of the published
model (``alainjungo/reliability-challenges-uncertainty``'s 2-D U-Net), as
torch's FLOP counter counts them, whatever implements them: the fast
decoder's fused 4x4 transposed up-conv counts as the plain 3x3 conv on
the upsampled map that it replaces, and a split decoder conv as the one
conv over the concatenation.
"""
from __future__ import annotations

# NVIDIA's data sheet, H100 SXM, dense rates without sparsity, at 700 W
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # float32 with TF32 off
PEAK_HBM_BYTES_PER_S = 3.35e12

# the eval kernel reads fg and uncertainty (float32) and target,
# prediction and mask (uint8) once per voxel
EVALSTATS_BYTES_PER_VOXEL = 4 + 4 + 1 + 1 + 1
EVALSTATS_KERNEL = "fused_eval_stats_kernel"


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> int:
    """2 x multiply-adds of a stride-1 'same' convolution, output h x w."""
    return 2 * cin * cout * k * k * h * w


def unet_forward_flops(model: dict, h: int, w: int) -> int:
    """Convolution FLOPs of one image's forward through the U-Net of
    ``model`` (the config's ``unet`` node: depth, start_filters,
    in_channels, nb_classes)."""
    depth, ch = int(model["depth"]), int(model["start_filters"])
    cin, total = int(model["in_channels"]), 0
    sizes = [(h >> i, w >> i) for i in range(depth + 1)]
    for level in range(depth + 1):  # the down blocks, then the bottom
        c = ch << level
        total += conv_flops(cin, c, 3, *sizes[level])
        total += conv_flops(c, c, 3, *sizes[level])
        cin = c
    for level in reversed(range(depth)):  # up-conv, then its block
        c = ch << level
        total += conv_flops(2 * c, c, 3, *sizes[level])
        total += conv_flops(2 * c, c, 3, *sizes[level])
        total += conv_flops(c, c, 3, *sizes[level])
    total += conv_flops(ch, ch, 3, *sizes[0])  # the head's ConvBnRelu
    total += conv_flops(ch, int(model["nb_classes"]), 1, *sizes[0])
    return total


def train_step_flops(model: dict, h: int, w: int, batch: int) -> int:
    """A train step: the forward and a backward of twice its work."""
    return 3 * unet_forward_flops(model, h, w) * batch


def evalstats_bytes(voxels: int) -> int:
    return EVALSTATS_BYTES_PER_VOXEL * voxels
