"""The yardstick's counts from shapes: the published U-Net's convolution
FLOPs against torch's FLOP counter on the program's model, the train
step's, and the eval kernel's bytes."""
from __future__ import annotations

import pytest
import torch

from benchmark import roofline

BRATS = {"depth": 4, "dropout": 0.05, "in_channels": 4, "nb_classes": 2,
         "start_filters": 32}
ISIC = {**BRATS, "in_channels": 3}


@pytest.mark.parametrize("model,hw,gflop", [
    (BRATS, (240, 240), 29.8672128), (ISIC, (192, 256), 25.458376704)])
def test_bench_forward_flops_from_shapes(model, hw, gflop):
    assert roofline.unet_forward_flops(model, *hw) == pytest.approx(
        gflop * 1e9, rel=1e-12)


@pytest.mark.parametrize("fast", [False, True])
def test_bench_forward_flops_match_torch_counter(fast):
    """The plain model counts as the shapes say. The fast decoder's fused
    up-conv (a 4x4 kernel over each input pixel) does fewer multiply-adds
    than the 3x3 conv over the four output pixels it replaces, and the
    yardstick counts the published model's conv whatever runs."""
    from torch.utils.flop_counter import FlopCounterMode
    from rcu_tpu_torch.models import FAST_DECODER_KWARGS, get_model
    small = {**BRATS, "start_filters": 8}
    net = get_model("unet", {**small, **(FAST_DECODER_KWARGS if fast
                                         else {})})
    with torch.inference_mode(), FlopCounterMode(display=False) as count:
        net(torch.zeros((1, 4, 64, 48)))
    want = roofline.unet_forward_flops(small, 64, 48)
    if fast:
        assert count.get_total_flops() < want
    else:
        assert count.get_total_flops() == want


def test_bench_train_step_flops():
    assert roofline.train_step_flops(BRATS, 240, 240, 32) == \
        3 * 32 * roofline.unet_forward_flops(BRATS, 240, 240)
    assert roofline.train_step_flops(BRATS, 240, 240, 32) / 1e12 == \
        pytest.approx(2.8673, abs=1e-4)


def test_bench_eval_kernel_bytes():
    assert roofline.EVALSTATS_BYTES_PER_VOXEL == 11
    assert roofline.evalstats_bytes(155 * 240 * 240) / 1e6 == \
        pytest.approx(98.208, abs=1e-3)
    assert roofline.evalstats_bytes(32 * 192 * 256) / 1e6 == \
        pytest.approx(17.301504, abs=1e-6)
    # the least time of a BraTS subject's planes at the published rate
    assert roofline.evalstats_bytes(155 * 240 * 240) \
        / roofline.PEAK_HBM_BYTES_PER_S * 1e3 == pytest.approx(0.02932,
                                                               abs=1e-5)
