"""The port's direct eval end to end in bf16 with the fast decoder against
the JAX package's for the ensemble (3 members), the mc run in bf16 against
the port's own f32 run under the same generators, and the scope checks of
fold_bn and int8 (the other families are
``tests/test_torch_variants_e2e.py``; the end-to-end weights,
``tests/test_torch_variants.py``).
"""
import pytest

from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import direct as port_direct
from tests.test_torch_variants import (GATE, SIGMA_ENVELOPE,
                                       assert_within_gate, build_e2e_env,
                                       read_ece_dice, run_both)


@pytest.fixture(scope="module")
def e2e_env(tmp_path_factory):
    return build_e2e_env(tmp_path_factory.mktemp("torch_variants_ensemble"))


@pytest.mark.parametrize("strategy", ["ensemble"])
def test_bf16_fast_decoder_matches_jax(e2e_env, tmp_path, strategy):
    jax_dir, port_dir = run_both(e2e_env[strategy], tmp_path, strategy,
                                 dtype="bfloat16", fast_decoder=True)
    gate = SIGMA_ENVELOPE if strategy == "aleatoric" else GATE
    assert_within_gate(jax_dir, port_dir, gate)


def test_mc_bf16_stays_with_f32_under_the_same_generators(e2e_env,
                                                          tmp_path):
    """MC masks cannot equal flax's; under the port's own generators the
    bf16 fast-decoder run stays within the gate of the f32 run."""
    config = port_cfg.load(e2e_env["mc"])
    runs = {}
    for name, flags in (("f32", {}), ("bf16", dict(dtype="bfloat16",
                                                   fast_decoder=True))):
        runs[name] = tmp_path / name
        port_direct.evaluate_direct(config, str(runs[name]), run_id="mc",
                                    device="cpu", **flags)
    got = assert_within_gate(runs["f32"], runs["bf16"], GATE)
    assert got != read_ece_dice(runs["f32"])  # bf16 did run


def test_scope_checks_raise_as_in_jax(e2e_env, tmp_path):
    """fold_bn with mc: ValueError in both packages; so is int8 on a
    family outside its scope."""
    config_file = e2e_env["mc"]
    with pytest.raises(ValueError, match="fold_bn covers"):
        jax_evaluate_direct(jax_cfg.load(config_file, "test-config"),
                            str(tmp_path / "jax"), fold_bn=True)
    with pytest.raises(ValueError, match="fold_bn covers"):
        port_direct.evaluate_direct(port_cfg.load(config_file),
                                    str(tmp_path / "port"), device="cpu",
                                    fold_bn=True)
    # mc=0 is the deterministic protocol, which folds
    port_direct.evaluate_direct(port_cfg.load(config_file),
                                str(tmp_path / "det"), device="cpu", mc=0,
                                fold_bn=True)
    with pytest.raises(ValueError, match="quantize=True covers"):
        jax_evaluate_direct(jax_cfg.load(config_file, "test-config"),
                            str(tmp_path / "jax_q"), strategy="aleatoric",
                            quantize=True)
    with pytest.raises(ValueError, match="quantize=True covers"):
        port_direct.evaluate_direct(port_cfg.load(config_file),
                                    str(tmp_path / "q"), device="cpu",
                                    strategy="aleatoric", quantize=True)
