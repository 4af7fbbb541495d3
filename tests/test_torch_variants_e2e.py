"""The port's direct eval end to end in bf16 with the fast decoder against
the JAX package's, for the deterministic, auxiliary_feat, auxiliary_segm
and aleatoric families, with the model.json int8 scales and the CLI's
variant flags (the ensemble and mc runs and the scope checks are
``tests/test_torch_variants_ensemble.py``; the model-level variants and
the shared end-to-end weights, ``tests/test_torch_variants.py``).

Each family of ``rcu_tpu.eval.direct`` runs with the same flags on the
same flax checkpoints and store; per-subject ECE and Dice must stay within
the JAX package's bf16 gate (``tests/test_bf16_parity.py``: 1e-3, 2e-3
for the sigma protocol).
"""
import os

import pytest
import torch

from rcu_tpu_torch.cli import eval_direct as port_cli
from rcu_tpu_torch.eval import direct as port_direct
from tests.test_torch_strategies import write_model
from tests.test_torch_unet import flax_net
from tests.test_torch_variants import (E2E_SHAPE, GATE, SIGMA_ENVELOPE, UNET,
                                       assert_within_gate, build_e2e_env,
                                       run_both)


@pytest.fixture(scope="module")
def e2e_env(tmp_path_factory):
    return build_e2e_env(tmp_path_factory.mktemp("torch_variants"))


@pytest.mark.parametrize("strategy", ["deterministic", "auxiliary_feat",
                                      "auxiliary_segm", "aleatoric"])
def test_bf16_fast_decoder_matches_jax(e2e_env, tmp_path, strategy):
    jax_dir, port_dir = run_both(e2e_env[strategy], tmp_path, strategy,
                                 dtype="bfloat16", fast_decoder=True)
    gate = SIGMA_ENVELOPE if strategy == "aleatoric" else GATE
    assert_within_gate(jax_dir, port_dir, gate)


def test_quant_scales_checkpoint_raises(e2e_env, tmp_path):
    """A model.json with int8 scales loads (the int8 slice is ported): the
    sites of the levels it quantizes take its dict and their int8 weights
    at load; a dict without a site's key raises at the forward."""
    _, p, stats = flax_net("unet", UNET, E2E_SHAPE[1:], seed=1)
    model_dir = write_model(tmp_path / "quant", "unet",
                            {**UNET, "quant_scales": {"site": 1.0},
                             "quant_skip_levels": 1}, p, stats)
    model = port_direct.load_model(model_dir, "best", "cpu")
    assert model.quant_scales == {"site": 1.0}
    assert model.ConvBlock_1.ConvBnRelu_0.Conv_0.int8_w0.dtype == torch.int8
    with pytest.raises(KeyError, match="calibrate"):
        model(torch.zeros(1, 4, *E2E_SHAPE[1:]))


def test_cli_variant_flags(e2e_env, tmp_path, monkeypatch):
    """-dtype, -fast_decoder and -fold_bn parse and reach the run."""
    seen = {}
    monkeypatch.setattr(port_cli, "main",
                        lambda *args: seen.setdefault("args", args))
    monkeypatch.setattr("sys.argv", [
        "eval_direct", "-config_file", e2e_env["deterministic"], "-dtype",
        "bfloat16", "-fast_decoder", "-fold_bn", "-device", "cpu"])
    port_cli.cli()
    assert seen["args"][-5:] == ("bfloat16", True, True, False, None)
    monkeypatch.setattr("sys.argv", ["eval_direct", "-config_file", "x",
                                     "-dtype", "float16"])
    with pytest.raises(SystemExit):
        port_cli.cli()
    monkeypatch.undo()
    out_dir = str(tmp_path / "cli")
    port_cli.main(e2e_env["deterministic"], run_id="cli", out_dir=out_dir,
                  mc=0, device="cpu", dtype="bfloat16", fast_decoder=True,
                  fold_bn=True)
    assert "eval_calibration_cli.csv" in os.listdir(out_dir)
