"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA card: they carry the ``cuda`` marker
and skip without one. This file imports neither JAX nor the JAX package,
so the card's machine runs it as it is::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from rcu_tpu_torch.eval.direct import evaluate_subjects
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.ops.cuda import evalstats

THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)
EDGES = np.float32([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 0.0])


def make_subject(seed, shape, masked=True):
    """fg with exact bin-edge values and their neighbours, uncertainty with
    exact threshold values; sizes that fill no whole block or quad."""
    rng = np.random.RandomState(seed)
    fg = rng.rand(*shape).astype(np.float32)
    flat = fg.reshape(-1)
    salt = np.concatenate([EDGES, np.nextafter(EDGES, np.float32(2)),
                           np.nextafter(EDGES, np.float32(-1))])
    k = min(flat.size, salt.size)
    flat[rng.choice(flat.size, k, replace=False)] = salt[:k]
    target = rng.rand(*shape) < 0.3
    unc = rng.rand(*shape).astype(np.float32)
    flat = unc.reshape(-1)
    k = min(flat.size, 2 * len(THRESHOLDS))
    flat[rng.choice(flat.size, k, replace=False)] = \
        np.resize(np.float32(THRESHOLDS), k)
    mask = rng.rand(*shape) < 0.8 if masked else None
    return fg, target, fg > 0.5, unc, mask


def port_inputs(fg, target, prediction, unc, mask, device="cpu"):
    def u8(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.uint8)).to(device)
    return (torch.from_numpy(fg).to(device), u8(target), u8(prediction),
            torch.from_numpy(unc).to(device), None if mask is None else u8(mask))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,masked", [((155, 48, 48), True),
                                          ((3, 17, 19), True),
                                          ((1, 1, 7), False)])
def test_cuda_kernel_matches_plain_version(cuda_device, shape, masked):
    fg, target, prediction, unc, mask = make_subject(5, shape, masked)
    weight = mask if masked else np.ones(shape, bool)
    inputs = port_inputs(fg, target, prediction, unc, weight, cuda_device)
    before = evalstats.fused_eval_stats.launches
    got = evalstats.fused_eval_stats(*inputs, THRESHOLDS)
    again = evalstats.fused_eval_stats(*inputs, THRESHOLDS)
    torch.cuda.synchronize()
    assert evalstats.fused_eval_stats.launches == before + 2
    want = evalstats.fused_eval_stats_reference(*inputs, THRESHOLDS)
    for key, value in want.items():
        assert torch.equal(got[key], again[key]), key  # bit-identical reruns
        if key == "bins_conf_sum":
            torch.testing.assert_close(got[key], value, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got[key], value), key


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    fg, target, prediction, unc, mask = make_subject(6, (2, 8, 8))
    inputs = list(port_inputs(fg, target, prediction, unc, mask, cuda_device))
    with pytest.raises(TypeError):
        evalstats.fused_eval_stats(inputs[0], inputs[1].float(), *inputs[2:],
                                   THRESHOLDS)
    n = inputs[0].numel()
    shifted = torch.cat([inputs[0].reshape(-1), inputs[0].reshape(-1)[:1]])[1:]
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        evalstats.fused_eval_stats(shifted, *[x.reshape(-1)[:n] for x in inputs[1:]],
                                   THRESHOLDS)


class TinyVolumes:
    """Two small volumes in memory with the SubjectDataset read interface."""
    subjects = ["a", "b"]

    def __init__(self, shape=(5, 24, 20)):
        rng = np.random.RandomState(9)
        self._images = {s: rng.rand(*shape, 4).astype(np.float32)
                        for s in self.subjects}
        self._labels = {s: (rng.rand(*shape) < 0.3).astype(np.uint8)
                        for s in self.subjects}

    def read_volume(self, subject, category):
        return (self._images if category == "images" else self._labels)[subject]

    def shape(self, subject, category="images"):
        return self.read_volume(subject, category).shape


@pytest.mark.cuda
def test_cuda_main_path_launches_the_kernel_once_per_subject(cuda_device,
                                                             tmp_path):
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    model = get_model("unet", dict(nb_classes=2, in_channels=4, depth=2,
                                   start_filters=8, dropout=0.1))
    with torch.no_grad():  # spread fg away from 0.5 over the bins
        model.Conv_2.weight.mul_(50.0)
    dataset = TinyVolumes()
    cpu = evaluate_subjects(model, dataset, str(tmp_path / "cpu"), mc=0,
                            batch_size=2, masked=False, device="cpu")
    before = evalstats.fused_eval_stats.launches
    gpu = evaluate_subjects(model.to(cuda_device), dataset,
                            str(tmp_path / "gpu"), mc=0, batch_size=2,
                            masked=False, device=cuda_device)
    assert evalstats.fused_eval_stats.launches == before + 2
    for subject, ece in cpu.items():  # a voxel at a bin edge may flip
        assert gpu[subject] == pytest.approx(ece, rel=1e-3)
    evaluate_subjects(model, dataset, str(tmp_path / "mc"), mc=3,
                      batch_size=2, masked=False, device=cuda_device)
    assert evalstats.fused_eval_stats.launches == before + 4
