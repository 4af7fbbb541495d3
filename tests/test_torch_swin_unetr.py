"""The port's Swin UNETR (``rcu_tpu_torch/models/swin_unetr.py``) against the
benchmark's plain reference (``benchmark/reference/swin_unetr.py``) on the
CPU at a small size: feature 12 with heads (3, 6, 12, 24) (head dim 4),
window 7, 64 x 64 images, so stage 1's 32 x 32 grid pads to 35 x 35 and
stage 4's 4 x 4 grid is one unshifted window (MONAI's rule), and one 60 x
60 case for the image's pad and crop. The cases: the deterministic
forward; the MC forward through ``mc_forward``'s shared prefix, through
the full T x B forward and through the reference's T full forwards, with
bitwise equal masks; a mesh part's masks; the shift mask and the bias
index against their formulas; the direct eval's rows against the
reference's; a train step's loss and gradients against the reference's
autograd; the published configuration's parameter count; the registry's
refusals; the reference importing neither JAX nor the port. The ``cuda``
case runs on a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_swin_unetr.py -m cuda

Tolerances: program and reference run the same float32 operations in
another grouping (the program's prefix runs once for the T samples, its
linears, convs and attention over T x B rows, its attention as one SDPA
call with the bias and mask added inside, its InstanceNorm through
``F.instance_norm``, the reference's through ``var_mean``), so they part
by float32 rounding: ~1e-6 of logits of scale ~3 seen, held at 1e-5
relative (rtol) and 1e-5 absolute; the InstanceNorms renormalize each
plane, so round-off does not grow through the decoder.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.drivers.direct_eval import _rows
from benchmark.reference import evalrows
from benchmark.reference import swin_unetr as ref
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval import direct
from rcu_tpu_torch.models import get_model, swin_unetr, transunet
from rcu_tpu_torch.utils import profiling

SMALL = {"in_channels": 4, "nb_classes": 2, "img_size": 64,
         "feature_size": 12, "heads": [3, 6, 12, 24], "drop_rate": 0.1}
CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-5
T, B = 3, 2
THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)


def small_model(seed=0, cfg=SMALL):
    net = get_model("swin_unetr", cfg)
    net.reset_parameters_like_flax(torch.Generator().manual_seed(seed))
    return net


def weights(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def images(n=B, size=64, seed=3):
    return torch.randn(n, 4, size, size,
                       generator=torch.Generator().manual_seed(seed))


class RecordedMasks(ref.Masks):
    """The reference's masks of one sample, kept in draw order."""

    def __init__(self, generator):
        super().__init__(generator)
        self.drawn = []

    def __call__(self, x, keep):
        mask = super().__call__(x, keep)
        self.drawn.append(mask)
        return mask


@pytest.fixture
def record_masks(monkeypatch):
    """Every mask the program's dropout sites draw, in order."""
    drawn = []
    keep = transunet.ElementDropout._keep

    def recorded(x, generators, keep_prob):
        mask = keep(x, generators, keep_prob)
        drawn.append(mask)
        return mask
    monkeypatch.setattr(transunet.ElementDropout, "_keep",
                        staticmethod(recorded))
    return drawn


@pytest.mark.parametrize("size", [64, 60])
def test_deterministic_forward_matches_reference(size):
    """At 60 the image pads to 64 and the logits are cropped back."""
    cfg = {**SMALL, "img_size": size}
    net, x = small_model(cfg=cfg), images(size=size)
    with torch.no_grad():
        got = net(x).logits
        want = ref.forward(weights(net), x, cfg)
    assert got.shape == (B, 2, size, size)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_mc_forward_shared_prefix_full_batch_and_reference(record_masks):
    """Three ways to T samples of B images, on the same generators: the
    protocol's shared prefix, one forward of T x B rows, T reference
    forwards. The masks are bitwise equal (each site's T x B rows are the
    samples' draws in order); the probabilities agree to rounding."""
    net, x = small_model(), images()
    rng = (5, 1)
    with torch.no_grad():
        shared = steps.mc_forward(net, x.permute(0, 2, 3, 1),
                                  steps.batch_generators(rng, T, CPU))
        shared_masks = list(record_masks)
        record_masks.clear()
        full = net(torch.cat([x] * T),
                   steps.batch_generators(rng, T, CPU)).logits
        full_masks = list(record_masks)
        samples = [RecordedMasks(steps.seeded_generator((*rng, t), CPU))
                   for t in range(T)]
        want = torch.cat([ref.forward(weights(net), x, SMALL, masks)
                          for masks in samples])
    # pos_drop, then each of 8 blocks' proj_drop and two MLP sites
    assert len(shared_masks) == len(full_masks) == 1 + 8 * 3
    for site, (a, b) in enumerate(zip(shared_masks, full_masks)):
        assert torch.equal(a, b)
        rows = a.shape[0] // T
        for t in range(T):
            assert torch.equal(a[t * rows:(t + 1) * rows],
                               samples[t].drawn[site])
    # stage 1's first proj_drop: 25 padded windows of 49 tokens an image
    assert shared_masks[1].shape == (T * B * 25, 49, 12)
    kept = torch.cat([m.flatten() for m in full_masks]).float().mean()
    assert 0.85 < kept < 0.95  # keep probability 0.9
    torch.testing.assert_close(full, want, rtol=RTOL, atol=ATOL)
    probs = torch.softmax(full, 1).reshape(T, B, 2, 64, 64) \
        .permute(0, 1, 3, 4, 2)
    torch.testing.assert_close(shared, probs, rtol=RTOL, atol=ATOL)


def test_generators_for_rows_draw_the_whole_batch_masks():
    """A mesh device's part (``ShardGenerators``) draws the whole batch's
    masks and keeps its rows, the windows' rows too, so its outputs are
    those rows of the whole forward."""
    net, x = small_model(), images(4)
    with torch.no_grad():
        whole = net(x, steps.batch_generators((2, 0), 1, CPU)).logits
        part = net(x[1:3], steps.batch_generators((2, 0), 1, CPU,
                                                  rows=(1, 3, 4))).logits
    torch.testing.assert_close(part, whole[1:3], rtol=RTOL, atol=ATOL)


def test_shift_mask_and_bias_index_against_their_formulas():
    """The program's index and shift mask against the formulas written out
    token by token, and against the reference's MONAI code."""
    window, shift = 7, 3
    index = swin_unetr.relative_position_index(window)
    for i in range(window * window):
        for j in range(window * window):
            dh, dw = i // window - j // window, i % window - j % window
            assert index[i, j] == (dh + 6) * 13 + (dw + 6)
    assert torch.equal(index, ref.relative_position_index(window))

    for size in (35, 21, 14):
        mask = swin_unetr.shift_mask(size, window, shift, CPU)

        def region(r):
            return 0 if r < size - window else 1 if r < size - shift else 2
        per_side = size // window
        assert mask.shape == (per_side ** 2, 49, 49)
        for k in range(per_side ** 2):
            rows = [(k // per_side) * window + t // window
                    for t in range(49)]
            cols = [(k % per_side) * window + t % window for t in range(49)]
            labels = torch.tensor([3 * region(r) + region(c)
                                   for r, c in zip(rows, cols)])
            want = torch.where(labels[:, None] != labels[None], -100.0, 0.0)
            assert torch.equal(mask[k], want)
        assert torch.equal(mask, ref.compute_mask(size, size, window, shift,
                                                  CPU))


def test_one_window_grid_reads_the_window_index_head():
    """A grid no larger than the window is one unshifted window whose bias
    reads the first n x n entries of the configured window's index, as
    MONAI's does (stage 4 at 64: a 4 x 4 grid, 16 tokens)."""
    assert swin_unetr.window_size(4, 7, 3) == (4, 0)
    assert swin_unetr.window_size(8, 7, 3) == (7, 3)
    attn = small_model().swinViT.layers4[0].blocks[1].attn
    table = attn.relative_position_bias_table
    bias = attn.bias(16)
    index = ref.relative_position_index(7)[:16, :16]
    assert torch.equal(bias[0], table[index.reshape(-1)].view(16, 16, -1)
                       .permute(2, 0, 1))


def test_evaluate_subjects_rows_match_reference(tmp_path):
    """The direct eval (MC, T = 3, batches of 3 of a 6-slice volume) of two
    subjects, each its own stream (seed, i), against the reference's rows
    from T full forwards a batch and the plain eval rows."""
    from benchmark import inputs
    volumes = inputs.brats_volumes(2, (6, 64, 64), 4, 11, CPU)
    net = small_model()
    w = weights(net)
    calibration = torch.from_numpy(volumes[0]["images"]).permute(0, 3, 1, 2)
    ref.calibrate(w, calibration, SMALL)
    net.load_state_dict(w)
    pool = inputs.VolumePool(volumes, ["s0", "s1"])
    direct.evaluate_subjects(net, pool, str(tmp_path), strategy="mc", mc=T,
                             batch_size=3, seed=17, thresholds=THRESHOLDS,
                             masked=False, device=CPU, run_id="bench")
    rows = _rows(str(tmp_path), THRESHOLDS)
    for i, name in enumerate(["s0", "s1"]):
        volume = volumes[i]
        x = torch.from_numpy(volume["images"]).permute(0, 3, 1, 2)
        with torch.no_grad():
            probs = torch.cat([
                sum(torch.softmax(ref.forward(
                    w, x[lo:lo + 3], SMALL,
                    ref.Masks(steps.seeded_generator((17, i, b, t), CPU))),
                    1).double() for t in range(T))
                for b, lo in enumerate(range(0, 6, 3))])
        fg, ent = evalrows.mc_summary(probs, T)
        want = evalrows.eval_row(fg, ent, torch.from_numpy(
            volume["labels"] > 0), torch.ones_like(fg, dtype=torch.bool),
            THRESHOLDS)
        got = rows[name]
        assert len(set(np.digitize(fg.flatten().numpy(),
                                   np.linspace(0, 1, 11)))) >= 4
        assert abs(got["ece"] - want["ece"]) < 1e-6
        for key in ("tp", "tn", "fp", "fn", "n", "bins_count", "uncertain"):
            assert got[key] == want[key], key


class _Capture:
    """What a TrainStep needs of a train state: the model, and a step that
    keeps the gradients instead of applying them."""

    def __init__(self, model):
        self.model, self.grads = model, None

    def step(self):
        self.grads = {n: p.grad.clone()
                      for n, p in self.model.named_parameters()}


def test_train_step_matches_reference_autograd():
    """One ``make_train_step`` step (dropout from the step's generator)
    against the reference's loss (the mean cross-entropy) and its autograd
    gradients: a finite loss and a gradient on every parameter."""
    net, x = small_model(), images(2)
    labels = (x[:, 0] > 0.5).long()
    state = _Capture(net)
    batch = {"images": x.permute(0, 2, 3, 1), "labels": labels,
             "valid": torch.ones(2)}
    metrics = steps.make_train_step()(state, batch,
                                      steps.step_generator(20, 0, 0, CPU))
    assert torch.isfinite(metrics["loss"])
    params = {n for n, _ in net.named_parameters()}
    assert set(state.grads) == params
    w = weights(net)
    for name in params:
        w[name].requires_grad_(True)
    logits = ref.forward(w, x, SMALL,
                         ref.Masks(steps.step_generator(20, 0, 0, CPU)))
    loss = torch.nn.functional.cross_entropy(logits, labels)
    loss.backward()
    torch.testing.assert_close(metrics["loss"], loss.detach(), rtol=1e-6,
                               atol=0.0)
    # float32 rounding of the two groupings, on the scale of the leaf or of
    # the median leaf, whichever is larger (a bias before an InstanceNorm
    # or a softmax has a gradient of 0 in exact arithmetic)
    scales = {n: float(w[n].grad.abs().max()) for n in params}
    median = float(np.median(list(scales.values())))
    for name in params:
        assert torch.isfinite(state.grads[name]).all(), name
        gap = float((state.grads[name] - w[name].grad).abs().max())
        assert gap <= 1e-4 * max(scales[name], median), name


def test_published_parameter_count():
    """MONAI's SwinUNETR at the BraTS 2021 widths in 2-D, 4 channels, 2
    classes: the count written out from the layer list (convs without
    bias but the patch embedding's and the class head's; the merging's
    reduction without bias)."""
    fs, window = 48, 7

    def conv(cin, cout, k, bias=False):
        return cin * cout * k * k + (cout if bias else 0)

    def res(cin, cout):
        return conv(cin, cout, 3) + conv(cout, cout, 3) \
            + (conv(cin, cout, 1) if cin != cout else 0)

    total = conv(4, fs, 2, bias=True)
    for s, heads in enumerate((3, 6, 12, 24)):
        d = fs << s
        block = 2 * d + (2 * window - 1) ** 2 * heads + (3 * d * d + 3 * d) \
            + (d * d + d) + 2 * d + (4 * d * d + 4 * d) + (4 * d * d + d)
        total += 2 * block + 4 * d * 2 * d + 2 * 4 * d
    total += res(4, fs) + res(fs, fs) + res(2 * fs, 2 * fs) \
        + res(4 * fs, 4 * fs) + res(16 * fs, 16 * fs)
    for cin, cout in ((16 * fs, 8 * fs), (8 * fs, 4 * fs), (4 * fs, 2 * fs),
                      (2 * fs, fs), (fs, fs)):
        total += cin * cout * 4 + res(2 * cout, cout)
    total += conv(fs, 2, 1, bias=True)
    with torch.device("meta"):
        net = get_model("swin_unetr", {"in_channels": 4, "nb_classes": 2,
                                       "img_size": 240})
    count = sum(p.numel() for p in net.parameters())
    assert count == total == 25_139_996
    assert set(net.state_dict()) == set(ref.leaf_shapes({}))


def test_dropout_counts_under_its_own_model():
    """Swin UNETR's dropout sites count ``swinunetr.dropout_elements``;
    TransUNet's keep ``transunet.dropout_elements``."""
    net, x = small_model(), images(1)
    profiling.clear()
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        net(x, steps.batch_generators((1, 0), 1, CPU))
    counts = profiling.counters()
    assert counts["swinunetr.dropout_elements"] > 0
    assert "transunet.dropout_elements" not in counts
    assert counts["swinunetr.windows"] == 2 * (25 + 9 + 4 + 1)
    assert {m.counter for m in get_model("transunet", {
        "img_size": 32, "hidden": 64, "mlp_dim": 128, "heads": 4,
        "layers": 1, "resnet_units": [1, 1, 1], "width": 32,
        "decoder_channels": [32, 16, 8, 4], "head_channels": 64}).modules()
        if isinstance(m, transunet.ElementDropout)} == {
        "transunet.dropout_elements"}


def test_registry_refusals():
    with pytest.raises(ValueError, match='unknown swin_unetr param "depth"'):
        get_model("swin_unetr", {**SMALL, "depth": 4})
    with pytest.raises(NotImplementedError, match="float32 only"):
        get_model("swin_unetr", {**SMALL, "dtype": "bfloat16"})
    with pytest.raises(NotImplementedError, match="dropout_path_rate"):
        get_model("swin_unetr", {**SMALL, "dropout_path_rate": 0.1})
    with pytest.raises(NotImplementedError, match="attn_drop_rate"):
        get_model("swin_unetr", {**SMALL, "attn_drop_rate": 0.1})
    with pytest.raises(NotImplementedError, match="v2 blocks"):
        get_model("swin_unetr", {**SMALL, "use_v2": True})
    with pytest.raises(ValueError, match="patch 2"):
        get_model("swin_unetr", {**SMALL, "patch": 4})
    with pytest.raises(ValueError, match="img_size above 32"):
        get_model("swin_unetr", {**SMALL, "img_size": 32})
    with pytest.raises(ValueError, match="img_size 64 got images"):
        small_model()(images(size=60))


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; import benchmark.reference.swin_unetr; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rcu_tpu', 'rcu_tpu_torch'}; "
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code], timeout=120,
                          cwd=str(__import__("pathlib").Path(
                              __file__).resolve().parents[1])
                          ).returncode == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the published widths at the cell's "
                    "size, and the CUDA events, run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_published_widths_match_reference_and_count(card):
    """On the card in f32 (TF32 off) at the published widths and 240 x 240:
    the protocol's forward of 2 slices against the reference's T forwards,
    the counters and the two spans' device seconds."""
    from rcu_tpu_torch.eval.device import full_float32
    cfg = {"in_channels": 4, "nb_classes": 2, "img_size": 240,
           "drop_rate": 0.1}
    net = small_model(cfg=cfg)
    w = {k: v.to(card) for k, v in weights(net).items()}
    net, x = net.to(card), images(size=240).to(card)
    profiling.clear()
    with full_float32(), torch.inference_mode(), torch.profiler.profile():
        probs = steps.mc_forward(net, x.permute(0, 2, 3, 1),
                                 steps.batch_generators((4, 0), T, card))
        torch.cuda.synchronize()
    with full_float32(), torch.no_grad():
        want = torch.cat([torch.softmax(ref.forward(w, x, cfg, ref.Masks(
            steps.seeded_generator((4, 0, t), card))), 1)
            for t in range(T)]).reshape(T, B, 2, 240, 240) \
            .permute(0, 1, 3, 4, 2)
    torch.testing.assert_close(probs, want, rtol=RTOL, atol=ATOL)
    counts = profiling.counters()
    assert counts["swinunetr.images"] == B
    assert counts["swinunetr.samples"] == T * B
    assert counts["swinunetr.windows"] == 990 * T * B
    seconds = profiling.device_seconds()
    assert seconds["swinunetr.swin"] > seconds[
        "swinunetr.window_attention"] > 0
