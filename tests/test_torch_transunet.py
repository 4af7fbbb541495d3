"""The port's TransUNet (``rcu_tpu_torch/models/transunet.py``) against its
plain reference (``tests/transunet_reference.py``) at a tiny size on the CPU:
the deterministic forward; the MC forward through ``mc_forward``'s shared
trunk, through the full T x B forward and through the reference's T full
forwards, with bitwise equal masks; the direct eval's rows against the
reference's; a train step's loss and gradients against the reference's
autograd; the published configuration's parameter count; the weights'
round trip through a checkpoint, ``eval.direct.load_model``, the
``eval_direct`` CLI and the ``TrainLoop``. The ``cuda`` cases run on a card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_transunet.py -m cuda

Tolerances: program and reference run the same float32 operations in
another grouping (the program's trunk runs once for the T samples, its
matmuls and convs over T x B rows, its decoder BatchNorm through
``F.batch_norm``), so they part by float32 rounding: ~1e-7 of the logits'
scale seen, held at 1e-5 relative (rtol) and 1e-6 absolute.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import transunet_reference as ref
from benchmark.drivers.direct_eval import _rows
from benchmark.reference import evalrows
from rcu_tpu_torch.data import h5
from rcu_tpu_torch.data.nifti import ImageProperties
from rcu_tpu_torch.data.split import save_split
from rcu_tpu_torch.engine import config as cfg_lib
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.engine.train import TrainLoop
from rcu_tpu_torch.eval import direct
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.models import transunet
from rcu_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"in_channels": 4, "nb_classes": 2, "img_size": 32, "hidden": 64,
        "mlp_dim": 128, "heads": 4, "layers": 2, "resnet_units": [1, 1, 1],
        "width": 32, "decoder_channels": [32, 16, 8, 4], "head_channels": 64}
CPU = torch.device("cpu")
RTOL, ATOL = 1e-5, 1e-6
T, B = 3, 2
THRESHOLDS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)


def tiny_model(seed=0, images=None, logit_std=2.0):
    """The tiny TransUNet from ``seed``; with ``images`` (N, C, H, W) its
    decoder BatchNorms calibrated on them and its class head scaled to a
    logit difference of std ``logit_std`` there, so that the maps spread
    over the bins; else random BatchNorm statistics."""
    net = get_model("transunet", TINY)
    net.reset_parameters_like_flax(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    if images is None:
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
        return net
    w = weights(net)
    with torch.no_grad():
        logits = ref.forward(w, images, TINY, mode="calibrate")
        scale = logit_std / float((logits[:, 1] - logits[:, 0]).std())
        w["segmentation_head.0.weight"].mul_(scale)
        w["segmentation_head.0.bias"].normal_(0.0, 0.5, generator=g)
    net.load_state_dict(w)
    return net


def weights(net):
    return {k: v.detach().clone() for k, v in net.state_dict().items()}


def images(n=B, seed=3):
    return torch.randn(n, 4, 32, 32, generator=torch.Generator().manual_seed(
        seed))


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


def test_deterministic_forward_matches_reference():
    net, x = tiny_model(), images()
    with torch.no_grad():
        got = net(x).logits
        want = ref.forward(weights(net), x, TINY)
    assert got.shape == (B, 2, 32, 32)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_mc_forward_shared_trunk_full_batch_and_reference(record_masks):
    """Three ways to T samples of B images, on the same generators: the
    protocol's shared trunk, one forward of T x B rows, T reference
    forwards. The masks are bitwise equal (each site's T x B rows are the
    samples' draws in order); the probabilities agree to rounding."""
    net, x = tiny_model(), images()
    rng = (5, 1)
    with torch.no_grad():
        shared = steps.mc_forward(net, x.permute(0, 2, 3, 1),
                                  steps.batch_generators(rng, T, CPU))
        shared_masks = list(record_masks)
        record_masks.clear()
        full = net(torch.cat([x] * T),
                   steps.batch_generators(rng, T, CPU)).logits
        full_masks = list(record_masks)
        samples = [ref.Masks(steps.seeded_generator((*rng, t), CPU))
                   for t in range(T)]
        want = torch.cat([ref.forward(weights(net), x, TINY, masks)
                          for masks in samples])
    # the embeddings' site and each layer's two MLP sites; p = 0 draws none
    assert len(shared_masks) == len(full_masks) == 1 + 2 * TINY["layers"]
    for site, (a, b) in enumerate(zip(shared_masks, full_masks)):
        assert torch.equal(a, b)
        for t in range(T):
            assert torch.equal(a[t * B:(t + 1) * B], samples[t].drawn[site])
    kept = torch.cat([m.flatten() for m in full_masks]).float().mean()
    assert 0.85 < kept < 0.95  # keep probability 0.9
    torch.testing.assert_close(full, want, rtol=RTOL, atol=ATOL)
    probs = torch.softmax(full, 1).reshape(T, B, 2, 32, 32) \
        .permute(0, 1, 3, 4, 2)
    torch.testing.assert_close(shared, probs, rtol=RTOL, atol=ATOL)


def test_attention_dropout_draws_on_the_probabilities(record_masks):
    """With attention dropout (0 in the published config) the probabilities
    and the out projection's output are masked too: four sites a layer,
    in the reference's order, and the same logits."""
    cfg = {**TINY, "attention_dropout": 0.1}
    net = get_model("transunet", cfg)
    net.load_state_dict(tiny_model().state_dict())
    x = images()
    with torch.no_grad():
        got = net(x, steps.batch_generators((6, 0), 1, CPU)).logits
        masks = ref.Masks(steps.seeded_generator((6, 0, 0), CPU))
        want = ref.forward(weights(net), x, cfg, masks)
    assert len(record_masks) == len(masks.drawn) == 1 + 4 * TINY["layers"]
    for a, b in zip(record_masks, masks.drawn):
        assert torch.equal(a, b)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def test_decoder_sites_take_nchw_inputs():
    """The decoder's 9 conv -> BN -> ReLU sites get NCHW-contiguous inputs,
    which the fused epilogue takes on a card (``ConvBnRelu.
    fuses_epilogue``); the tokens' transposed view is channels-last."""
    from rcu_tpu_torch.models.unet import ConvBnRelu
    net, seen = tiny_model(), []
    for m in net.modules():
        if isinstance(m, ConvBnRelu):
            m.register_forward_pre_hook(
                lambda mod, args: seen.append(args[0].is_contiguous()))
    with torch.no_grad():
        net(images(), steps.batch_generators((1, 0), 1, CPU))
    assert seen == [True] * 9


def test_generators_for_rows_draw_the_whole_batch_masks(record_masks):
    """A mesh device's part (``ShardGenerators``) draws the whole batch's
    masks and keeps its rows, so its outputs are those rows of the whole
    forward."""
    net, x = tiny_model(), images(4)
    with torch.no_grad():
        whole = net(x, steps.batch_generators((2, 0), 1, CPU)).logits
        part = net(x[1:3], steps.batch_generators((2, 0), 1, CPU,
                                                  rows=(1, 3, 4))).logits
    torch.testing.assert_close(part, whole[1:3], rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="rows 0:3"):
        net(x[:2], steps.batch_generators((2, 0), 1, CPU, rows=(0, 3, 4)))


def test_evaluate_subjects_rows_match_reference(tmp_path):
    """The direct eval (MC, T = 3, batches of 3 of an 8-slice volume) of two
    subjects, each its own stream (seed, i), against the reference's rows
    from T full forwards a batch and the plain eval rows."""
    from benchmark import inputs
    volumes = inputs.brats_volumes(2, (8, 32, 32), 4, 11, CPU)
    calibration = torch.from_numpy(volumes[0]["images"]).permute(0, 3, 1, 2)
    net = tiny_model(images=calibration)
    pool = inputs.VolumePool(volumes, ["s0", "s1"])
    direct.evaluate_subjects(net, pool, str(tmp_path), strategy="mc", mc=T,
                             batch_size=3, seed=17, thresholds=THRESHOLDS,
                             masked=False, device=CPU, run_id="bench")
    rows = _rows(str(tmp_path), THRESHOLDS)
    w = weights(net)
    for i, name in enumerate(["s0", "s1"]):
        volume = volumes[i]
        x = torch.from_numpy(volume["images"]).permute(0, 3, 1, 2)
        with torch.no_grad():
            probs = torch.cat([
                sum(torch.softmax(ref.forward(
                    w, x[lo:lo + 3], TINY,
                    ref.Masks(steps.seeded_generator((17, i, b, t), CPU))),
                    1).double() for t in range(T))
                for b, lo in enumerate(range(0, 8, 3))])
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
    """One ``make_train_step`` step in train mode (dropout from the step's
    generator, BatchNorm on the batch's statistics) against the reference's
    loss (the mean cross-entropy) and its autograd gradients."""
    net, x = tiny_model(), images(4)
    labels = (x[:, 0] > 0.5).long()
    state = _Capture(net)
    batch = {"images": x.permute(0, 2, 3, 1), "labels": labels,
             "valid": torch.ones(4)}
    metrics = steps.make_train_step()(state, batch,
                                      steps.step_generator(20, 0, 0, CPU))
    w = weights(net.eval())
    params = {n for n, _ in net.named_parameters()}
    for name in params:
        w[name].requires_grad_(True)
    logits = ref.forward(w, x, TINY,
                         ref.Masks(steps.step_generator(20, 0, 0, CPU)),
                         mode="train")
    loss = torch.nn.functional.cross_entropy(logits, labels)
    loss.backward()
    torch.testing.assert_close(metrics["loss"], loss.detach(), rtol=1e-6,
                               atol=0.0)
    assert set(state.grads) == params
    # float32 rounding of the two groupings (~2e-6 seen), on the scale of
    # the leaf or of the median leaf, whichever is larger: the key
    # projections' biases have a gradient of 0 in exact arithmetic (the
    # softmax ignores a constant added to a row of scores), round-off alone
    scales = {n: float(w[n].grad.abs().max()) for n in params}
    median = float(np.median(list(scales.values())))
    for name in params:
        gap = float((state.grads[name] - w[name].grad).abs().max())
        assert gap <= 1e-4 * max(scales[name], median), name


def test_published_parameter_count():
    """get_r50_b16_config at 240 x 240, 4 channels, 2 classes: the count
    written out from the layer list (the trunk's StdConv2d have no bias,
    nor have the decoder's convs before their BatchNorm)."""
    def conv(cin, cout, k, bias=False):
        return cin * cout * k * k + (cout if bias else 0)

    def norm(c):
        return 2 * c

    def unit(cin, cout, cmid, project):
        return (conv(cin, cmid, 1) + norm(cmid) + conv(cmid, cmid, 3)
                + norm(cmid) + conv(cmid, cout, 1) + norm(cout)
                + (conv(cin, cout, 1) + norm(cout) if project else 0))

    trunk = conv(4, 64, 7) + norm(64)
    trunk += unit(64, 256, 64, True) + 2 * unit(256, 256, 64, False)
    trunk += unit(256, 512, 128, True) + 3 * unit(512, 512, 128, False)
    trunk += unit(512, 1024, 256, True) + 8 * unit(1024, 1024, 256, False)
    embeddings = conv(1024, 768, 1, bias=True) + 225 * 768
    block = norm(768) * 2 + 4 * (768 * 768 + 768) \
        + (768 * 3072 + 3072) + (3072 * 768 + 768)
    encoder = 12 * block + norm(768)
    decoder = conv(768, 512, 3) + norm(512)
    for cin, cout in ((512 + 512, 256), (256 + 256, 128), (128 + 64, 64),
                      (64, 16)):
        decoder += conv(cin, cout, 3) + norm(cout) + conv(cout, cout, 3) \
            + norm(cout)
    head = conv(16, 2, 3, bias=True)
    with torch.device("meta"):
        net = get_model("transunet", {"in_channels": 4, "nb_classes": 2,
                                      "img_size": 240})
    count = sum(p.numel() for p in net.parameters())
    assert count == trunk + embeddings + encoder + decoder + head \
        == 105_301_474


def test_benchmark_reference_copy_equals_this_reference():
    """The benchmark's copy of the reference (``benchmark/reference/
    transunet.py``, which adds seeded weights) computes the same logits
    and draws the same masks as this file's."""
    from benchmark.reference import transunet as bench_ref
    net, x = tiny_model(), images()
    cfg = {**ref.PUBLISHED, **TINY}
    with torch.no_grad():
        want = ref.forward(weights(net), x, TINY, ref.Masks(
            steps.seeded_generator((8, 0), CPU)))
        got = bench_ref.forward(weights(net), x, cfg, bench_ref.Masks(
            steps.seeded_generator((8, 0), CPU)))
    assert torch.equal(got, want)


def test_registry_refusals():
    with pytest.raises(ValueError, match='unknown transunet param "depth"'):
        get_model("transunet", {**TINY, "depth": 4})
    with pytest.raises(NotImplementedError, match="float32 only"):
        get_model("transunet", {**TINY, "dtype": "bfloat16"})
    with pytest.raises(ValueError, match="multiple of 16"):
        get_model("transunet", {**TINY, "img_size": 40})


def test_reference_imports_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, 'tests'); "
            "import transunet_reference; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'rcu_tpu', 'rcu_tpu_torch'}; "
            "sys.exit(1 if bad else 0)")
    assert subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          timeout=120).returncode == 0


def _store(path, n_subjects=3, n_slices=8, seed=9):
    rng = np.random.RandomState(seed)
    with h5.DatasetWriter(path) as w:
        for i in range(n_subjects):
            labels = np.zeros((n_slices, 32, 32), np.uint8)
            labels[1:, 8:20, 10:22] = 1
            x = rng.randn(n_slices, 32, 32, 4).astype(np.float32) * 0.5
            x[..., 0] += labels
            x[0] = 0.0
            w.add_subject(f"s{i:02d}", {"images": x, "labels": labels},
                          props=ImageProperties(size=(32, 32, n_slices)))
    return path


def test_train_loop_checkpoint_load_model_and_cli(tmp_path):
    """``model: {transunet: ...}`` through the TrainLoop (one epoch, adam),
    its checkpoint through ``eval.direct.load_model`` (the same weights)
    and the ``eval_direct`` CLI (the CSVs of ``evaluate_subjects`` on the
    loaded model, byte for byte)."""
    store = _store(str(tmp_path / "ds.h5"))
    split = str(tmp_path / "split.json")
    save_split(split, ["s00", "s01"], ["s02"], ["s02"])
    data = {"batch_size": 4, "dataset": store, "indexing": {"slice": {}},
            "num_workers": 0}
    model = {"transunet": {**TINY, "dropout": 0.1}}
    with open(tmp_path / "train.yaml", "w") as f:
        yaml.safe_dump({"config": {
            "train_name": "tu", "train_dir": str(tmp_path / "out"),
            "split": split, "epochs": 1, "model": model,
            "optimizer": {"adam": {"lr": 1e-4}}, "seed": 20,
            "valid_every_nth": 1, "log_every_nth": 2, "others": {},
            "train_data": {**data, "selection_strategy": {"none-black": {}},
                           "shuffle": True},
            "valid_data": {**data, "shuffle": False}},
            "meta": {"type": "train-config", "version": 0}}, f)
    loop = TrainLoop(cfg_lib.load(str(tmp_path / "train.yaml"),
                                  "train-config"), hooks=[], device="cpu")
    loop.run()
    loop.save_checkpoint(0, best=True)
    trained = weights(loop.state.model)
    model_dir = os.path.dirname(loop.model_files.weight_checkpoint_dir)
    loaded = direct.load_model(model_dir, "best", CPU)
    assert isinstance(loaded, transunet.TransUNet) and not loaded.training
    for name, value in weights(loaded).items():
        assert torch.equal(value, trained[name]), name
    with open(tmp_path / "test.yaml", "w") as f:
        yaml.safe_dump({"config": {
            "test_name": "tu_mc", "model_dir": model_dir, "split": split,
            "seed": 20, "test_at": "best", "others": {"mc": T},
            "test_data": {"batch_size": 3, "dataset": store,
                          "indexing": {"slice": {}}, "shuffle": False}},
            "meta": {"type": "test-config", "version": 0}}, f)
    from rcu_tpu_torch.cli import eval_direct
    eval_direct.main(str(tmp_path / "test.yaml"), run_id="tu",
                     out_dir=str(tmp_path / "cli"), unmasked=True,
                     device="cpu")
    direct.evaluate_subjects(loaded, h5.SubjectDataset(store, ["s02"]),
                             str(tmp_path / "call"), strategy="mc", mc=T,
                             batch_size=3, seed=20, masked=False, device=CPU,
                             run_id="tu")
    names = sorted(os.listdir(tmp_path / "call"))
    assert names == sorted(os.listdir(tmp_path / "cli")) and names
    for name in names:
        with open(tmp_path / "cli" / name) as a, \
                open(tmp_path / "call" / name) as b:
            assert a.read() == b.read(), name


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the fused epilogue and the CUDA "
                    "events have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_mc_forward_matches_reference_and_counts(card):
    """On the card in f32 (TF32 off): the protocol's forward against the
    reference's T forwards, the decoder's 9 sites through the fused
    epilogue, and the encoder's device seconds read from its events."""
    from rcu_tpu_torch.eval.device import full_float32
    net, x = tiny_model(), images()
    w = {k: v.to(card) for k, v in weights(net).items()}
    net, x = net.to(card), x.to(card)
    profiling.clear()
    with full_float32(), torch.inference_mode(), torch.profiler.profile():
        probs = steps.mc_forward(net, x.permute(0, 2, 3, 1),
                                 steps.batch_generators((4, 0), T, card))
        torch.cuda.synchronize()
    with torch.no_grad():
        want = torch.cat([torch.softmax(ref.forward(w, x, TINY, ref.Masks(
            steps.seeded_generator((4, 0, t), card))), 1)
            for t in range(T)]).reshape(T, B, 2, 32, 32).permute(0, 1, 3, 4,
                                                                   2)
    torch.testing.assert_close(probs, want, rtol=RTOL, atol=ATOL)
    counts = profiling.counters()
    assert counts["unet.epilogue_fused"] == 9
    assert counts.get("unet.epilogue_eager", 0) == 0
    assert counts["transunet.trunk_images"] == B
    assert counts["transunet.samples"] == T * B
    assert profiling.device_seconds()["transunet.encoder"] > 0
