"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA card: they carry the ``cuda`` marker
and skip without one. This file imports neither JAX nor the JAX package,
so the card's machine runs it as it is::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from rcu_tpu_torch.eval.direct import evaluate_subjects, model_from_flax
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.models.convert import flax_from_state_dict
from rcu_tpu_torch.ops.cuda import evalstats, int8conv

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


def same_bits(a, b):
    """Equal tensors, NaN for NaN (bit-identical reruns)."""
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


def odd_subject(kind, shape, seed=7):
    """``skewed``: 95 % of fg below 0.1 (real maps pile into bin 0 and
    tn); ``nonfinite``: NaN and +-inf in fg and u; else make_subject."""
    fg, target, prediction, unc, mask = make_subject(seed, shape)
    rng = np.random.RandomState(seed + 1)
    if kind == "skewed":
        low = rng.rand(*shape) < 0.95
        fg = np.where(low, rng.rand(*shape) * 0.1, fg).astype(np.float32)
        target = target & ~low
        prediction = fg > 0.5
    elif kind == "nonfinite":
        special = np.float32([np.nan, np.inf, -np.inf])
        for plane in (fg, unc):
            flat = plane.reshape(-1)
            flat[rng.choice(flat.size, 30, replace=False)] = np.resize(special, 30)
        prediction = fg > 0.5
    return fg, target, prediction, unc, mask


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,thresholds", [
    ("plain", (5, 31, 29), (0.5, 0.1, 0.9, 0.1, 0.3, 0.3)),  # unsorted, duplicates
    ("plain", (5, 31, 29), THRESHOLDS[::-1]),
    ("plain", (5, 31, 29), ()),
    ("plain", (1_000_003,), tuple(np.linspace(0.0, 1.0, 23))),  # the most
    ("skewed", (155, 48, 48), THRESHOLDS),
    ("nonfinite", (5, 31, 29), THRESHOLDS),
    ("nonfinite", (3, 17, 19), (0.3, float("nan"), 0.1, float("inf"))),
    ("plain", (15,), THRESHOLDS),  # one 8-voxel chunk and a ragged tail
    ("plain", (5,), THRESHOLDS),  # less than one chunk
])
def test_cuda_kernel_exact_on_odd_inputs(cuda_device, kind, shape, thresholds):
    """Sizes that are no multiple of the chunk; exact counts and
    bit-identical reruns against the plain version."""
    fg, target, prediction, unc, mask = odd_subject(kind, shape)
    inputs = port_inputs(fg, target, prediction, unc, mask, cuda_device)
    got = evalstats.fused_eval_stats(*inputs, thresholds)
    again = evalstats.fused_eval_stats(*inputs, thresholds)
    torch.cuda.synchronize()
    want = evalstats.fused_eval_stats_reference(*inputs, thresholds)
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert same_bits(got[key], again[key]), key
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        if key == "bins_conf_sum":
            torch.testing.assert_close(got[key], value, rtol=1e-6, atol=1e-6,
                                       equal_nan=True)
        else:
            assert torch.equal(got[key], value), (key, got[key], value)


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
    byte = torch.cat([inputs[1].reshape(-1), inputs[1].reshape(-1)[:4]])[4:]
    assert byte.data_ptr() % 8  # 4-byte aligned was enough before
    with pytest.raises(ValueError, match="target must be 8-byte aligned"):
        evalstats.fused_eval_stats(inputs[0].reshape(-1), byte,
                                   *[x.reshape(-1) for x in inputs[2:]], THRESHOLDS)
    # the u8 planes are read 8 bytes at a time: 8-byte alignment is enough
    eight = torch.empty(n + 8, dtype=torch.uint8, device=cuda_device)[8:]
    eight.copy_(inputs[1].reshape(-1))
    assert eight.data_ptr() % 16 == 8
    got = evalstats.fused_eval_stats(inputs[0].reshape(-1), eight,
                                     *[x.reshape(-1) for x in inputs[2:]],
                                     THRESHOLDS)
    want = evalstats.fused_eval_stats_reference(
        inputs[0], inputs[1], *inputs[2:], THRESHOLDS)
    assert torch.equal(got["thresh_counts"], want["thresh_counts"])


@pytest.mark.cuda
@pytest.mark.parametrize("k,shape", [(1, (192, 256)), (3, (64, 80)),
                                     (32, (48, 64)), (3, (49, 57)),
                                     (32, (17, 19))])
def test_cuda_image_axis_matches_plain_and_single_launches(cuda_device, k,
                                                           shape):
    """K images in one launch: counts equal to the plain version's, the
    confidence sums at its bar, and every row bitwise what a launch of
    that image alone gives (the same grid, order and sums an image).
    49x57 and 17x19 are no multiple of a chunk: the images after the first
    take the masked loads."""
    planes = [make_subject(30 + i, shape) for i in range(k)]
    fg, target, prediction, unc, mask = (np.stack(p) for p in zip(*planes))
    inputs = port_inputs(fg, target, prediction, unc, mask, cuda_device)
    before = evalstats.fused_eval_stats.launches
    got = evalstats.fused_eval_stats(*inputs, THRESHOLDS, per_image=True)
    assert evalstats.fused_eval_stats.launches == before + 1
    want = evalstats.fused_eval_stats_reference(*inputs, THRESHOLDS,
                                                per_image=True)
    for key, value in want.items():
        assert got[key].shape[0] == k, key
        if key == "bins_conf_sum":
            torch.testing.assert_close(got[key], value, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got[key], value), key
    rows = evalstats.fused_subject_eval(*inputs, THRESHOLDS, per_image=True)
    for i in range(k):
        one = [p[i].clone() for p in inputs]  # aligned alone
        single = evalstats.fused_eval_stats(*one, THRESHOLDS)
        for key, value in single.items():
            assert same_bits(got[key][i], value), (i, key)
        for part, single_part in zip(rows, evalstats.fused_subject_eval(
                *one, THRESHOLDS)):
            for key, value in single_part.items():
                assert same_bits(part[key][i].contiguous(), value) or \
                    torch.equal(part[key][i].isnan(), value.isnan()), (i, key)
    torch.cuda.synchronize()


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


class TinyBaselineVolumes(TinyVolumes):
    """TinyVolumes with [gt, baseline prediction] labels, as auxiliary_segm
    stores hold them."""

    def read_volume(self, subject, category):
        volume = super().read_volume(subject, category)
        if category != "labels":
            return volume
        baseline = volume.copy()
        baseline[:, :4] = 1 - baseline[:, :4]
        return np.stack([volume, baseline], axis=-1)


def family_models(strategy):
    """Seeded tiny models of a family, heads sharpened so that the maps
    spread."""
    params = dict(nb_classes=2, in_channels=4, depth=2, start_filters=8,
                  dropout=0.1)

    def unet(seed, **options):
        torch.manual_seed(seed)
        model = get_model("unet", {**params, **options})
        with torch.no_grad():
            model.Conv_2.weight.mul_(50.0)
        return model

    if strategy in ("mc", "deterministic"):
        return unet(0)
    if strategy == "aleatoric":
        return unet(1, sigma_out=True)
    if strategy == "ensemble":
        return [unet(2 + k) for k in range(3)]
    if strategy == "auxiliary_feat":
        torch.manual_seed(6)
        postnet = get_model("postnet", dict(nb_classes=2, in_channels=8))
        with torch.no_grad():
            postnet.Conv_0.weight.mul_(20.0)
        return unet(5, provide_features=True), postnet
    return unet(7, in_channels=5)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["aleatoric", "ensemble",
                                      "auxiliary_feat", "auxiliary_segm"])
def test_cuda_families_launch_the_kernel_once_per_subject(cuda_device,
                                                          tmp_path, strategy):
    models = family_models(strategy)
    dataset = TinyBaselineVolumes() if strategy == "auxiliary_segm" \
        else TinyVolumes()
    options = dict(strategy=strategy, batch_size=2, masked=False,
                   is_log_sigma=strategy == "aleatoric")
    cpu = evaluate_subjects(models, dataset, str(tmp_path / "cpu"),
                            device="cpu", **options)
    on_card = models.to(cuda_device) if isinstance(models, torch.nn.Module) \
        else type(models)(m.to(cuda_device) for m in models)
    before = evalstats.fused_eval_stats.launches
    plain = evalstats.fused_eval_stats.plain_calls
    gpu = evaluate_subjects(on_card, dataset, str(tmp_path / "gpu"),
                            device=cuda_device, **options)
    assert evalstats.fused_eval_stats.launches == before + 2
    assert evalstats.fused_eval_stats.plain_calls == plain
    for subject, ece in cpu.items():  # a voxel at a bin edge may flip
        assert gpu[subject] == pytest.approx(ece, rel=1e-3, abs=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(dtype="bfloat16"),
    dict(dtype="bfloat16", fast_decoder=True),
    dict(dtype="bfloat16", fast_decoder=True, fold_bn=True)])
def test_cuda_variants_launch_the_kernel_once_per_subject(cuda_device,
                                                          tmp_path, flags):
    """The bf16 variants on the card: the kernel once per subject on f32
    planes, ECEs near the same variant's on the CPU (bf16 may move a voxel
    across a bin edge in these 2,400-voxel volumes)."""
    params = dict(nb_classes=2, in_channels=4, depth=2, start_filters=8,
                  dropout=0.1)
    torch.manual_seed(0)
    model = get_model("unet", params)
    with torch.no_grad():
        model.Conv_2.weight.mul_(50.0)
    tree = flax_from_state_dict(model.state_dict())
    options = dict(mc=0, batch_size=2, masked=False)
    cpu = evaluate_subjects(model_from_flax("unet", params, *tree, "cpu",
                                            **flags),
                            TinyVolumes(), str(tmp_path / "cpu"),
                            device="cpu", **options)
    before = evalstats.fused_eval_stats.launches
    gpu = evaluate_subjects(model_from_flax("unet", params, *tree, cuda_device,
                                            **flags),
                            TinyVolumes(), str(tmp_path / "gpu"),
                            device=cuda_device, **options)
    assert evalstats.fused_eval_stats.launches == before + 2
    for subject, ece in cpu.items():
        assert gpu[subject] == pytest.approx(ece, abs=2e-2)


def int8_operands(seed, n, h, w, cin, cout, k, extreme=False):
    """Seeded NHWC int8 input and (Cout, k, k, Cin) int8 weights; with
    ``extreme`` every value +-127, the largest sums the kernel can see."""
    rng = np.random.RandomState(seed)
    if extreme:
        x = np.where(rng.rand(n, h, w, cin) < 0.5, -127, 127)
        wq = np.full((cout, k, k, cin), 127)
    else:
        x = rng.randint(-127, 128, (n, h, w, cin))
        wq = rng.randint(-127, 128, (cout, k, k, cin))
    return (torch.from_numpy(x.astype(np.int8)),
            torch.from_numpy(wq.astype(np.int8)))


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,cin,cout,k,pad,dil,extreme", [
    (2, 12, 12, 64, 64, 3, 1, 1, False),
    (3, 45, 53, 4, 32, 3, 1, 1, False),  # Cin 4 (quantize_skip=0), odd sides
    (2, 9, 7, 32, 29, 3, 1, 1, False),  # Cout no multiple of 8
    (2, 11, 13, 5, 10, 3, 1, 1, False),  # Cin no multiple of 16
    (2, 6, 5, 128, 64, 4, 2, 2, False),  # the fused up-conv
    (1, 15, 15, 512, 256, 4, 2, 2, True),  # the widest sums, all +-127
    (1, 30, 30, 256, 256, 3, 1, 1, True),
    (1, 23, 27, 128, 64, 4, 2, 2, False),  # the odd fused up-conv's edges
    (1, 9, 7, 16, 8, 3, 1, 2, False),  # dilated 3x3: phases of 1 and 2 taps
    (2, 5, 6, 16, 3, 1, 0, 2, False),  # dilated 1x1: phases with no tap
    (1, 20, 40, 64, 512, 3, 1, 1, False),  # four 128-channel blocks
])
def test_cuda_int8_conv_matches_plain_version(cuda_device, n, h, w, cin,
                                              cout, k, pad, dil, extreme):
    """The int8 kernel's int32 output equals the exact float64 plain
    version; two runs are bit-identical; one launch a call."""
    x, wq = int8_operands(n + cin, n, h, w, cin, cout, k, extreme)
    before = int8conv.int8_conv.launches
    got = int8conv.int8_conv(x.to(cuda_device), wq.to(cuda_device), pad, dil)
    again = int8conv.int8_conv(x.to(cuda_device), wq.to(cuda_device), pad, dil)
    torch.cuda.synchronize()
    assert int8conv.int8_conv.launches == before + 2
    want = int8conv.int8_conv_reference(x, wq, pad, dil)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_int8_conv_refuses_what_it_does_not_take(cuda_device):
    x, wq = int8_operands(1, 1, 8, 8, 16, 8, 3)
    x, wq = x.to(cuda_device), wq.to(cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        int8conv.int8_conv(x.permute(0, 2, 1, 3), wq, 1)
    with pytest.raises(TypeError):
        int8conv.int8_conv(x.float(), wq, 1)
    with pytest.raises(ValueError, match="lhs_dilation"):
        int8conv.int8_conv(x, wq, 1, 3)
    # a pointer off the 16-byte grain is padded to 32 channels, exactly
    shifted = torch.empty(x.numel() + 1, dtype=torch.int8,
                          device=cuda_device)[1:].view(x.shape)
    shifted.copy_(x)
    assert torch.equal(int8conv.int8_conv(shifted, wq, 1).cpu(),
                       int8conv.int8_conv_reference(x.cpu(), wq.cpu(), 1))


def dequant_terms(seed, n, h, w, cin, cout, k, dtype, pair, folded):
    """A quantized site's operands as ``int8_conv_dequant`` takes them:
    one or two (int8 input, int8 weights, scale in the compute dtype)
    terms and the bias (bf16 folded: the two terms of ``bias_terms``)."""
    from rcu_tpu_torch.models.unet import bias_terms
    rng = np.random.RandomState(seed)
    terms = []
    for part in range(2 if pair else 1):
        x, wq = int8_operands(seed + part, n, h, w, cin, cout, k)
        scale = torch.from_numpy(rng.uniform(2e-5, 2e-3, cout)
                                 .astype(np.float32)).to(dtype)
        terms.append((x, wq, scale))
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    if folded and dtype != torch.float32:
        return terms, *bias_terms(bias, dtype)
    return terms, bias.to(dtype), None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,pair,folded", [
    (torch.bfloat16, False, False), (torch.bfloat16, False, True),
    (torch.bfloat16, True, False), (torch.bfloat16, True, True),
    (torch.float32, False, False), (torch.float32, True, False)])
@pytest.mark.parametrize("n,h,w,cin,cout,k,pad,dil", [
    (2, 12, 12, 64, 64, 3, 1, 1),
    (2, 9, 7, 32, 29, 3, 1, 1),  # Cout no multiple of 8: scalar stores
    (2, 11, 13, 5, 10, 3, 1, 1),  # Cin padded to 16
    (2, 6, 5, 128, 64, 4, 2, 2),  # the fused up-conv
    (1, 23, 27, 128, 64, 4, 2, 2),  # at odd sides
    (1, 15, 15, 256, 512, 3, 1, 1),
])
def test_cuda_int8_conv_dequant_matches_plain_version(
        cuda_device, dtype, pair, folded, n, h, w, cin, cout, k, pad, dil):
    """The fused site (int8 conv, dequantize, split-pair add, bias) on the
    card is bitwise its plain version on the card and on the CPU; reruns
    are bit-identical; one launch a term."""
    terms, bias, lo = dequant_terms(n * cin + cout, n, h, w, cin, cout, k,
                                    dtype, pair, folded)
    card = [tuple(t.to(cuda_device) for t in term) for term in terms]
    on = (lambda t: None if t is None else t.to(cuda_device))
    before = int8conv.int8_conv.launches
    got = int8conv.int8_conv_dequant(card, on(bias), pad, dil, lo=on(lo))
    again = int8conv.int8_conv_dequant(card, on(bias), pad, dil, lo=on(lo))
    torch.cuda.synchronize()
    assert int8conv.int8_conv.launches == before + 2 * len(terms)
    plain_card = int8conv.int8_conv_dequant_reference(card, on(bias), pad,
                                                      dil, on(lo))
    plain_cpu = int8conv.int8_conv_dequant_reference(terms, bias, pad, dil,
                                                     lo)
    assert got.dtype == dtype and got.shape == plain_cpu.shape
    bits = (lambda t: t.float().cpu().view(torch.int32))
    assert torch.equal(bits(got), bits(again))
    assert torch.equal(bits(got), bits(plain_card))
    assert torch.equal(bits(got), bits(plain_cpu))


@pytest.mark.cuda
def test_cuda_int8_conv_dequant_takes_misaligned_and_narrow_inputs(
        cuda_device):
    """A view off the 16-byte grain and Cin 4 are copied and padded for the
    kernel; the output is the plain version's, bitwise."""
    terms, bias, _ = dequant_terms(3, 2, 10, 9, 4, 16, 3, torch.bfloat16,
                                   True, False)
    card = []
    for x, wq, scale in terms:
        shifted = torch.empty(x.numel() + 1, dtype=torch.int8,
                              device=cuda_device)[1:].view(x.shape)
        shifted.copy_(x)
        card.append((shifted, wq.to(cuda_device), scale.to(cuda_device)))
    got = int8conv.int8_conv_dequant(card, bias.to(cuda_device), 1)
    want = int8conv.int8_conv_dequant_reference(terms, bias, 1)
    assert torch.equal(got.cpu().float().view(torch.int32),
                       want.float().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16])
def test_cuda_int8_conv_copies_a_misaligned_view(cuda_device, dtype):
    """At Cin 64 (no padding) a view of x and w one byte off the 16-byte
    grain is copied to an aligned buffer; int32 equal and bf16 bitwise the
    plain version."""
    terms, bias, _ = dequant_terms(5, 2, 10, 9, 64, 24, 3, torch.bfloat16,
                                   False, False)
    (x, wq, scale), = terms

    def shifted(t):
        view = torch.empty(t.numel() + 1, dtype=torch.int8,
                           device=cuda_device)[1:].view(t.shape)
        assert view.data_ptr() % 16
        return view.copy_(t)

    x_card, w_card = shifted(x), shifted(wq)
    before = int8conv.int8_conv.launches
    if dtype == torch.int32:
        got = int8conv.int8_conv(x_card, w_card, 1)
        want = int8conv.int8_conv_reference(x, wq, 1)
    else:
        got = int8conv.int8_conv_dequant(
            [(x_card, w_card, scale.to(cuda_device))], bias.to(cuda_device), 1)
        want = int8conv.int8_conv_dequant_reference(terms, bias, 1)
    assert int8conv.int8_conv.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    bits = (lambda t: t if t.dtype == torch.int32
            else t.float().view(torch.int32))
    assert torch.equal(bits(got.cpu()), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [
    dict(dtype="bfloat16", fast_decoder=True),
    dict(dtype="bfloat16", fast_decoder=True, fold_bn=True),
    dict()])
def test_cuda_int8_unet_runs_the_kernel_at_every_site(cuda_device, flags):
    """A quantized U-Net on the card: one kernel launch per quantized site
    and none of the plain version, logits near the same model's on the
    CPU (int32 sums exact on both; the unquantized level and BatchNorm are
    cuDNN's and oneDNN's)."""
    from rcu_tpu_torch.ops import quant
    torch.backends.cudnn.allow_tf32 = False
    params = dict(nb_classes=2, in_channels=4, depth=3, start_filters=8,
                  dropout=0.1)
    torch.manual_seed(0)
    tree = flax_from_state_dict(get_model("unet", params).state_dict())
    x = torch.from_numpy(np.random.RandomState(3).randn(4, 24, 20, 4)
                         .astype(np.float32))
    out = {}
    for device in ("cpu", cuda_device):
        model = model_from_flax("unet", params, *tree, device, **flags)
        images = x.to(device)
        scales = quant.calibrate_scales(model, [images], mc_dropout=False)
        model.quantize(scales, 1)
        launches = int8conv.int8_conv.launches
        plain = int8conv.int8_conv.plain_calls
        with torch.no_grad():
            layout = images.permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last if flags else
                torch.contiguous_format).to(model.dtype)
            out[str(device)] = model(layout).logits.cpu()
        if device != "cpu":
            # levels 1 and 2: 2 + 1 + 2 + 1 sites each (down pair, up-conv,
            # split pair or concat conv, second up conv), the bottom 2
            sites = (6 if flags.get("fast_decoder") else 5) * 2 + 2
            assert int8conv.int8_conv.launches == launches + sites
            assert int8conv.int8_conv.plain_calls == plain
    scale = float(out["cpu"].abs().max())
    assert float((out["cpu"] - out[str(cuda_device)]).abs().max()) \
        <= 0.05 * scale


class TinyImages:
    """Seven small native-2D images in memory (images (H, W, 4)), the third
    of another shape, so that a chunk of 4 splits into three same-shape
    parts and the tail of 3 is one; ``with_baseline``: [gt, baseline]
    labels, as auxiliary_segm stores hold them."""
    subjects = [f"i{n}" for n in range(7)]

    def __init__(self, with_baseline=False):
        rng = np.random.RandomState(11)
        self._data = {}
        for n, s in enumerate(self.subjects):
            shape = (20, 24) if n == 2 else (24, 20)
            labels = (rng.rand(*shape) < 0.3).astype(np.uint8)
            if with_baseline:
                baseline = labels.copy()
                baseline[:4] = 1 - baseline[:4]
                labels = np.stack([labels, baseline], axis=-1)
            self._data[s] = {"images": rng.rand(*shape, 4).astype(np.float32),
                             "labels": labels}

    def read_volume(self, subject, category):
        return self._data[subject][category]

    def shape(self, subject, category="images"):
        return self.read_volume(subject, category).shape


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["mc", "deterministic", "aleatoric",
                                      "ensemble", "auxiliary_feat",
                                      "auxiliary_segm"])
def test_cuda_native_2d_eval_matches_cpu(cuda_device, tmp_path, strategy):
    """The native-2D direct eval on the card: one launch a same-shape part
    (4 here, for 7 images), never the plain version, and the ECE of each
    image near the CPU's (mc: its own stream on each device, so only
    finite)."""
    torch.backends.cudnn.allow_tf32 = False
    models = family_models(strategy)
    dataset = TinyImages(with_baseline=strategy == "auxiliary_segm")
    options = dict(strategy=strategy, batch_size=4, masked=False,
                   is_log_sigma=strategy == "aleatoric", mc=3)
    cpu = evaluate_subjects(models, dataset, str(tmp_path / "cpu"),
                            device="cpu", **options)
    on_card = models.to(cuda_device) if isinstance(models, torch.nn.Module) \
        else type(models)(m.to(cuda_device) for m in models)
    before = evalstats.fused_eval_stats.launches
    plain = evalstats.fused_eval_stats.plain_calls
    gpu = evaluate_subjects(on_card, dataset, str(tmp_path / "gpu"),
                            device=cuda_device, **options)
    assert evalstats.fused_eval_stats.launches == before + 4
    assert evalstats.fused_eval_stats.plain_calls == plain
    assert gpu.keys() == cpu.keys() == set(TinyImages.subjects)
    for subject, ece in cpu.items():
        assert np.isfinite(gpu[subject])
        if strategy != "mc":  # a pixel at a bin edge may flip
            assert gpu[subject] == pytest.approx(ece, rel=1e-3, abs=1e-3)


# ----------------------------------------------------------- training

TRAIN_UNET = dict(nb_classes=2, in_channels=4, depth=3, start_filters=16,
                  dropout=0.0)


def train_batch(seed, n=2, hw=(64, 64), labels_channels=None):
    rng = np.random.RandomState(seed)
    images = rng.randn(n, *hw, 4).astype(np.float32)
    shape = (n, *hw) + ((labels_channels,) if labels_channels else ())
    labels = (rng.rand(*shape) < 0.3).astype(np.uint8)
    return {"images": torch.from_numpy(images),
            "labels": torch.from_numpy(labels), "valid": torch.ones(n)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ce", "aleatoric", "auxiliary_feat",
                                  "auxiliary_segm"])
def test_cuda_train_step_matches_cpu(cuda_device, kind):
    """One train step on the card against the CPU from the same weights,
    at the smoke run's bars (``chip_smoke.train_step_card_vs_cpu`` raises
    on a miss: the loss rtol 1e-5, each gradient within 1e-3 of its
    tensor's max, or, where a ReLU or pool choice went otherwise, a card
    step on the CPU's choices within 1e-3 of the CPU's or float64's; the
    BatchNorm statistics, adam's update from identical gradients), with
    TF32 off and the caller's flags back afterwards."""
    import chip_smoke
    from rcu_tpu_torch.engine import steps
    from rcu_tpu_torch.eval.device import full_float32
    batch, frozen, noise = train_batch(1), None, None
    if kind == "ce":
        model = chip_smoke.seeded_train_model(TRAIN_UNET, 1)
        make = lambda f: steps.make_train_step()  # noqa: E731
    elif kind == "aleatoric":
        model = chip_smoke.seeded_train_model({**TRAIN_UNET,
                                               "sigma_out": True}, 2)
        noise = torch.randn((10, 2, 2, 64, 64),
                            generator=torch.Generator().manual_seed(3))
        make = lambda f: steps.make_train_step(  # noqa: E731
            "aleatoric", is_log_sigma=True)
    elif kind == "auxiliary_feat":
        frozen = chip_smoke.seeded_train_model(
            {**TRAIN_UNET, "provide_features": True}, 4).eval()
        model = chip_smoke.seeded_train_model(
            {"nb_classes": 2, "in_channels": 16, "nb_convs": 3}, 5)
        make = lambda f: steps.make_auxiliary_train_step(f)  # noqa: E731
    else:
        model = chip_smoke.seeded_train_model({**TRAIN_UNET,
                                               "in_channels": 5}, 6)
        batch = train_batch(7, labels_channels=2)
        make = lambda f: steps.make_auxiliary_train_step()  # noqa: E731
    with full_float32():
        chip_smoke.train_step_card_vs_cpu(kind, model, make, batch,
                                          frozen=frozen, noise=noise)


@pytest.mark.cuda
def test_cuda_prefetch_feeds_pinned_batches(cuda_device):
    """The read-ahead feed: host batches pinned, device batches equal."""
    from rcu_tpu_torch.data import loader
    batches = [{"images": np.random.RandomState(i).rand(4, 8, 8, 2)
                .astype(np.float32), "valid": np.ones(4, np.float32)}
               for i in range(5)]
    pinned = []
    real = loader._host_tensors

    def spy(batch, pin):
        out = real(batch, pin)
        pinned.append(all(t.is_pinned() for t in out.values()))
        return out

    loader._host_tensors = spy
    try:
        got = list(loader.prefetch(iter(batches), cuda_device))
    finally:
        loader._host_tensors = real
    assert pinned == [True] * 5
    for want, have in zip(batches, got):
        for key in want:
            assert have[key].device.type == "cuda"
            assert np.array_equal(have[key].cpu().numpy(), want[key])
