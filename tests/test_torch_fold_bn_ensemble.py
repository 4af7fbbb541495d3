"""The port's direct eval end to end in bf16 with the fast decoder and the
BatchNorm fold against the JAX package's, for the ensemble and aleatoric families (the
other single-forward families are ``tests/test_torch_fold_bn_e2e.py``; the fold itself,
``tests/test_torch_fold_bn.py``; the end-to-end weights,
``tests/test_torch_variants.py``). Per-subject ECE and Dice within the JAX
package's bf16 gate (1e-3, 2e-3 for the sigma protocol).
"""
import pytest

from tests.test_torch_variants import (GATE, SIGMA_ENVELOPE,
                                       assert_within_gate, build_e2e_env,
                                       run_both)


@pytest.fixture(scope="module")
def e2e_env(tmp_path_factory):
    return build_e2e_env(tmp_path_factory.mktemp("torch_fold_bn"))


@pytest.mark.parametrize("strategy", ["ensemble", "aleatoric"])
def test_bf16_fast_decoder_fold_matches_jax(e2e_env, tmp_path, strategy):
    """The JAX package's production flags, bf16 + fast decoder + fold, on
    every single-forward family."""
    jax_dir, port_dir = run_both(e2e_env[strategy], tmp_path, strategy,
                                 dtype="bfloat16", fast_decoder=True,
                                 fold_bn=True)
    gate = SIGMA_ENVELOPE if strategy == "aleatoric" else GATE
    assert_within_gate(jax_dir, port_dir, gate)
