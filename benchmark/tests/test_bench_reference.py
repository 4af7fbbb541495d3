"""The plain reference against the program at a tiny size on the CPU: the
U-Net's forward with and without the MC dropout stream, the MC summary
and eval rows against the program's eval reduction, and the first train
steps against the program's train step and Adam. (A test may import
both; the reference imports nothing of the program.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import evalrows, streams
from benchmark.reference.train import adam_steps
from benchmark.reference.unet import calibrate, forward, seeded_weights

MODEL = {"depth": 2, "dropout": 0.05, "in_channels": 4, "nb_classes": 2,
         "start_filters": 8}
TH = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95)


def _program(weights, **options):
    from rcu_tpu_torch.models import get_model
    net = get_model("unet", {**MODEL, **options})
    missing, unexpected = net.load_state_dict(weights, strict=False)
    assert not unexpected
    assert all(k.endswith("num_batches_tracked") for k in missing)
    return net


@pytest.fixture
def setup(cpu):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((6, 4, 16, 24), generator=gen)
    w = seeded_weights(MODEL, torch.Generator().manual_seed(3), cpu)
    calibrate(w, x, MODEL["depth"])
    return w, x


def test_bench_reference_forward_matches_program(setup):
    w, x = setup
    with torch.no_grad():
        want = forward(w, x, MODEL["depth"])
        got = _program(w)(x).logits
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fast", [False, True])
def test_bench_reference_mc_stream_matches_program(setup, fast):
    from rcu_tpu_torch.engine import steps
    from rcu_tpu_torch.eval.pipeline import sample_generators
    w, x = setup
    options = {"split_decoder_concat": True, "fused_upsample": True} \
        if fast else {}
    names, t = (2 ** 31 + 9, 3), 4
    images = x.permute(0, 2, 3, 1)
    with torch.no_grad():
        got = steps.mc_forward(_program(w, **options), images,
                               sample_generators(names, 0, t, "cpu"))
        got = got.mean(0)[..., 1]
        total = sum(torch.softmax(forward(
            w, x, MODEL["depth"], streams.Masks(
                streams.generator(names + (0, s), "cpu"), 0.95)), 1)
            for s in range(t))
    fg, _ = evalrows.mc_summary(total, t)
    torch.testing.assert_close(got.double(), fg, rtol=1e-5, atol=1e-6)


def test_bench_eval_rows_match_the_program_reduction(cpu):
    from rcu_tpu_torch.ops.cuda.evalstats import fused_subject_eval
    rng = np.random.default_rng(4)
    shape = (3, 40, 50)
    fg = torch.from_numpy(rng.random(shape).astype(np.float32))
    # exact bin edges and thresholds among the values
    fg.view(-1)[:11] = torch.linspace(0, 1, 11)
    ent = torch.from_numpy(rng.random(shape).astype(np.float32))
    ent.view(-1)[:11] = torch.tensor(TH)
    target = torch.from_numpy(rng.random(shape) < 0.3)
    mask = torch.from_numpy(rng.random(shape) < 0.7)
    bins, confusion, correction = fused_subject_eval(
        fg, target, fg > 0.5, ent, mask, TH)
    row = evalrows.eval_row(fg.double(), ent.double(), target, mask, TH)
    assert row["bins_count"] == bins["bins_count"].tolist()
    for k in ("tp", "tn", "fp", "fn", "n"):
        assert row[k] == int(confusion[k])
    assert row["ece"] == pytest.approx(float(bins["ece"]), abs=1e-12)
    assert row["dice"] == pytest.approx(float(confusion["dice"]), rel=1e-6)
    assert row["uncertain"] == [[int(correction[k][j]) for k in
                                 ("tpu", "tnu", "fpu", "fnu")]
                                for j in range(len(TH))]


def test_bench_train_steps_match_the_program(cpu):
    from rcu_tpu_torch.engine import steps
    from rcu_tpu_torch.engine.state import TrainState
    from rcu_tpu_torch.models import get_optimizer
    w0 = seeded_weights(MODEL, torch.Generator().manual_seed(8), cpu)
    gen = torch.Generator().manual_seed(1)
    batches = [(torch.randn((4, 4, 16, 16), generator=gen),
                torch.randint(0, 2, (4, 16, 16), generator=gen))
               for _ in range(3)]
    want = adam_steps(w0, batches, [streams.generator((7, 0, k), "cpu")
                                    for k in range(3)], MODEL, 1e-4, 0.95)
    net = _program(w0)
    optimizer = get_optimizer("adam", {"lr": 1e-4})
    state = TrainState(net, optimizer,
                       optimizer.init(dict(net.named_parameters())))
    step = steps.make_train_step()
    losses, first = [], None
    for k, (x, y) in enumerate(batches):
        batch = {"images": x.permute(0, 2, 3, 1), "labels": y,
                 "valid": torch.ones(4)}
        losses.append(float(step(state, batch, steps.step_generator(
            7, 0, k, "cpu"))["loss"]))
        if first is None:
            first = state.opt_state["mu"].clone() / 0.1
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    params = dict(net.named_parameters())
    sizes = [p.numel() for p in params.values()]
    grads = dict(zip(params, torch.split(first, sizes)))
    got = {"losses": losses,
           "grad_norm": {k: float(g.norm()) for k, g in grads.items()},
           "change_norm": {k: float((p.detach() - w0[k]).norm())
                           for k, p in params.items()}}
    ref = {"losses": want["losses"],
           "grad_norm": {k: float(g.norm())
                         for k, g in want["first_grad"].items()},
           "change_norm": {k: float(c.norm())
                           for k, c in want["change"].items()}}
    gaps = compare.train_gaps(got, ref)
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-4
    # the kernels' changes; a bias before BatchNorm whose channel no
    # sample dropped has a gradient of round-off, which Adam magnifies
    kernels = [k for k in ref["change_norm"] if k.endswith("Conv_0.weight")]
    assert max(abs(got["change_norm"][k] - ref["change_norm"][k])
               / ref["change_norm"][k] for k in kernels) < 1e-3
