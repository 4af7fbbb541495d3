"""The port's int8 direct eval end to end against the JAX package's for the
2-member ensemble (union calibration, every member its own int8 weights),
with and without the BN fold: the recipe, weights and bars of
``tests/test_torch_quant_e2e.py``.
"""
import pytest

from tests.test_torch_quant_e2e import build_env, check_int8_run, f32_runner


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return build_env(tmp_path_factory.mktemp("torch_quant_e2e_ensemble"))


@pytest.fixture(scope="module")
def f32_runs(env, tmp_path_factory):
    return f32_runner(env, tmp_path_factory)


@pytest.mark.parametrize("strategy,fold", [
    ("ensemble", False), ("ensemble", True)])
def test_int8_matches_jax_and_f32(env, f32_runs, tmp_path, strategy, fold):
    check_int8_run(env, f32_runs, tmp_path, strategy, fold)
