"""The port's int8 direct eval end to end against the JAX package's: both
``evaluate_direct``s with ``quantize=True`` and the production flags (bf16,
fast decoder, and the BN fold on the single-forward protocols) on the
same H5 store and flax checkpoints, and the port's own f32 run, for the
deterministic and mc protocols (the ensemble's runs are
``tests/test_torch_quant_e2e_ensemble.py``).

The weights follow the recipe of ``tests/test_torch_variants.py``
(BatchNorm statistics of the test images, spread antisymmetric heads,
96x32x32 subjects) at the flagship's dropout rate, 0.05, for which the
JAX package sized its calibration margin. On such random weights int8 sits
near the JAX package's 1e-3 ECE/Dice gate in both packages: with these
seeds JAX's own int8 runs lie 0.4e-3 to 2.3e-3 from its f32 runs, beyond
the gate in 5 of the 7 (printed by :func:`assert_held_like_jax`). So the
port is held to the gate where JAX's own int8 run meets it:
- its int8 run within 1e-3 of JAX's int8 run (deterministic, ensemble;
  MC masks cannot equal flax's, so not mc);
- its int8 run within 1e-3 of its own f32 run where JAX's int8 run is
  within 1e-3 of JAX's f32 run on the same weights, and within twice
  JAX's own deviation where that misses the gate.
"""
import numpy as np
import pytest

from rcu_tpu.data.split import save_split
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu_torch.cli import eval_direct as port_cli
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.ops.cuda import int8conv
from tests.test_torch_direct import make_store
from tests.test_torch_strategies import write_config, write_model
from tests.test_torch_variants import (E2E_SHAPE, GATE, TEST_SUBJECTS,
                                       UNET, assert_within_gate, e2e_net,
                                       read_ece_dice, read_volumes, run_both)

INT8 = dict(dtype="bfloat16", fast_decoder=True, quantize=True)
NET = {**UNET, "dropout": 0.05}  # the flagship's rate


def deviation(want_dir, got_dir):
    """The largest per-subject ECE or Dice difference of two runs."""
    want, got = read_ece_dice(want_dir), read_ece_dice(got_dir)
    return max(abs(got[s][i] - want[s][i]) for s in want for i in (0, 1))


def assert_held_like_jax(f32_dir, int8_dir, jax_f32_dir, jax_int8_dir):
    """The port's int8 run against its f32 run at the gate where JAX's
    int8 run meets it against JAX's f32 run, else within twice JAX's own
    deviation; the CSVs' files and rows as the f32 run's."""
    jax_dev = deviation(jax_f32_dir, jax_int8_dir)
    print(f"JAX's int8 run {jax_dev:.3e} from its f32 run, the port's "
          f"{deviation(f32_dir, int8_dir):.3e} from its own")
    got = assert_within_gate(f32_dir, int8_dir, max(GATE, 2 * jax_dev))
    assert got != read_ece_dice(f32_dir)  # int8 did run
    return jax_dev


def build_env(tmp):
    """{protocol: config file}: deterministic, mc (3 samples) and a
    2-member ensemble."""
    store = make_store(tmp, E2E_SHAPE)
    split_file = str(tmp / "split.json")
    save_split(split_file, ["s00"], ["s01"], list(TEST_SUBJECTS))
    x = np.concatenate([v for v, _ in read_volumes(store)])

    def net(name, seed):
        return write_model(tmp / name, "unet", NET, *e2e_net(
            "unet", NET, x, seed, "Conv_2", std=2.0)[1:])

    members = [net(f"member{k}", 4 + k) for k in range(2)]
    configs = {}
    for name, model_dir, others in (
            ("deterministic", net("plain", 2), {"mc": 0}),
            ("mc", net("mc", 3), {"mc": 3}),
            ("ensemble", members[0], {"model_dir": members[1:],
                                      "test_at": "best"})):
        configs[name] = write_config(tmp / f"{name}.yaml", name, model_dir,
                                     split_file, store, others)
    return configs


def f32_runner(env, tmp_path_factory):
    """(JAX's, the port's) f32 run dirs of a protocol, each run once."""
    runs = {}

    def get(strategy):
        if strategy not in runs:
            runs[strategy] = run_both(
                env[strategy], tmp_path_factory.mktemp(f"f32_{strategy}"),
                strategy)
        return runs[strategy]
    return get


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return build_env(tmp_path_factory.mktemp("torch_quant_e2e"))


@pytest.fixture(scope="module")
def f32_runs(env, tmp_path_factory):
    return f32_runner(env, tmp_path_factory)


def port_run(config_file, out_dir, strategy, **flags):
    port_direct.evaluate_direct(port_cfg.load(config_file), str(out_dir),
                                run_id=strategy, strategy=strategy,
                                device="cpu", **flags)
    return out_dir


def check_int8_run(env, f32_runs, tmp_path, strategy, fold):
    """int8 within the gate of JAX's int8 run, and held against the f32
    run like JAX's own (:func:`assert_held_like_jax`)."""
    flags = dict(INT8, fold_bn=fold)
    calls = int8conv.int8_conv.plain_calls
    jax_dir, port_dir = run_both(env[strategy], tmp_path, strategy, **flags)
    assert int8conv.int8_conv.plain_calls > calls  # the sites ran int8
    jax_f32, f32_dir = f32_runs(strategy)
    assert_within_gate(jax_dir, port_dir, GATE)
    assert_held_like_jax(f32_dir, port_dir, jax_f32, jax_dir)


@pytest.mark.parametrize("strategy,fold", [
    ("deterministic", False), ("deterministic", True)])
def test_int8_matches_jax_and_f32(env, f32_runs, tmp_path, strategy, fold):
    check_int8_run(env, f32_runs, tmp_path, strategy, fold)


@pytest.mark.parametrize("skip", [None, 0, 2])
def test_int8_mc_stays_with_f32_under_the_same_generators(env, f32_runs,
                                                          tmp_path, skip):
    """The mc protocol calibrates under one dropout sample; against the f32
    run under the port's own generators it is held like JAX's int8 run
    against JAX's f32 run, at the default skip (1), with every level
    quantized and with two kept (where JAX's run meets the gate)."""
    jax_f32, f32_dir = f32_runs("mc")
    jax_int8, int8_dir = run_both(env["mc"], tmp_path / "int8", "mc",
                                  quantize_skip_levels=skip, **INT8)
    jax_dev = assert_held_like_jax(f32_dir, int8_dir, jax_f32, jax_int8)
    if skip == 2:
        assert jax_dev <= GATE


@pytest.mark.parametrize("strategy", ["aleatoric", "auxiliary_feat",
                                      "auxiliary_segm"])
def test_int8_scope_is_jax_s(env, tmp_path, strategy):
    """The other families keep the f32/bf16 paths: both packages raise the
    same ValueError before any model loads."""
    for run in (lambda: jax_evaluate_direct(
                    jax_cfg.load(env["mc"], "test-config"),
                    str(tmp_path / "jax"), strategy=strategy, quantize=True),
                lambda: port_run(env["mc"], tmp_path / "port", strategy,
                                 quantize=True)):
        with pytest.raises(ValueError, match="quantize=True covers"):
            run()


def test_cli_quantize_flags(env, tmp_path, monkeypatch):
    """-quantize and -quantize_skip reach the run; -quantize_skip without
    -quantize is a parser error, as in bin/eval_direct.py."""
    seen = {}
    monkeypatch.setattr(port_cli, "main",
                        lambda *args: seen.setdefault("args", args))
    monkeypatch.setattr("sys.argv", [
        "eval_direct", "-config_file", env["deterministic"], "-quantize",
        "-quantize_skip", "2", "-device", "cpu"])
    port_cli.cli()
    assert seen["args"][-2:] == (True, 2)
    monkeypatch.setattr("sys.argv", ["eval_direct", "-config_file", "x",
                                     "-quantize_skip", "2"])
    with pytest.raises(SystemExit):
        port_cli.cli()
    monkeypatch.undo()
    out_dir = tmp_path / "cli"
    calls = int8conv.int8_conv.plain_calls
    port_cli.main(env["deterministic"], run_id="cli", out_dir=str(out_dir),
                  mc=0, device="cpu", dtype="bfloat16", fast_decoder=True,
                  fold_bn=True, quantize=True, quantize_skip=0)
    assert int8conv.int8_conv.plain_calls > calls
    assert set(read_ece_dice(out_dir)) == set(TEST_SUBJECTS)
