"""The port's inference service in the JAX package's inference variants
against ``rcu_tpu.serve`` in the same variant, on one flax-schema
checkpoint: the fast decoder and the BN fold at the f32 bar (counts
exact), bf16 at ``tests.test_torch_variants``' bf16 bar, and int8
(``quantize=True``: calibrated on the first request) with the calibrated
scales compared and the probabilities at ``tests.test_torch_quant``'s bar.
"""
import numpy as np
import pytest
import torch

from tests.test_torch_serve import (assert_like_jax, env,  # noqa: F401
                                    jax_service, port_service)
from tests.test_torch_quant import SOFTMAX_BAR
from tests.test_torch_variants import GATE, bf16_bar, nchw, roundings

DEPTH = 2


@pytest.mark.parametrize("flags", [dict(fast_decoder=True),
                                   dict(fold_bn=True),
                                   dict(fast_decoder=True, fold_bn=True)])
def test_f32_variant_matches_jax(env, flags):  # noqa: F811
    images, labels = env["subjects"]["s02"]
    jax_svc = jax_service(env["model_dir"], mc=0, **flags)
    port = port_service(env["model_dir"], mc=0, **flags)
    for kw in ({}, {"target": labels}):
        assert_like_jax(port.predict(images, **kw),
                        jax_svc.predict(images, **kw))


@pytest.mark.parametrize("flags", [dict(dtype="bfloat16"),
                                   dict(dtype="bfloat16", fast_decoder=True)])
def test_bf16_matches_jax_bf16(env, flags):  # noqa: F811
    """Probabilities within half the bf16 bar of the logits (the softmax
    fg is 1/4-Lipschitz in the logit difference), the ECE within the 1e-3
    gate of the JAX service's; the bf16 service's maps differ from f32."""
    images, labels = env["subjects"]["s02"]
    jax_svc = jax_service(env["model_dir"], mc=0, **flags)
    port = port_service(env["model_dir"], mc=0, **flags)
    plain = port_service(env["model_dir"], mc=0)
    f32 = plain.predict(images)
    want = jax_svc.predict(images, target=labels)
    got = port.predict(images, target=labels)
    assert {k: (v.dtype, v.shape) for k, v in got.items()} == \
        {k: (np.asarray(v).dtype, np.asarray(v).shape)
         for k, v in want.items()}
    with torch.no_grad():
        scale = float(plain.model(nchw(images)).logits.abs().max())
    bar = bf16_bar(roundings(DEPTH, flags.get("fast_decoder", False)),
                   scale) / 2
    assert np.abs(got["probabilities"] - want["probabilities"]).max() <= bar
    assert abs(float(got["ece"]) - float(want["ece"])) <= GATE
    assert not np.array_equal(got["probabilities"], f32["probabilities"])


@pytest.mark.parametrize("members", [0, 1])
def test_int8_service_matches_jax(env, members):  # noqa: F811
    """First-request calibration on the centre slices (mc=0 and the
    ensemble: deterministic passes): the port's scales are the JAX
    service's at rtol 1e-5, its probabilities within the int8 bar of the
    JAX service's, and a second request reuses the scales bitwise."""
    images, labels = env["subjects"]["s02"]
    kw = dict(mc=0, quantize=True,
              members=[env["model_dir"]] * members or None)
    jax_svc = jax_service(env["model_dir"], **kw)
    port = port_service(env["model_dir"], **kw)
    want = jax_svc.predict(images)
    got = port.predict(images)
    scales = port.model.quant_scales
    assert set(scales) == set(jax_svc.model.quant_scales)
    for key, value in jax_svc.model.quant_scales.items():
        assert scales[key] == pytest.approx(value, rel=1e-5), key
    assert all(m.quant_scales is scales for m in
               (port.models if members else [port.model]))
    np.testing.assert_allclose(got["probabilities"], want["probabilities"],
                               atol=SOFTMAX_BAR)
    again = port.predict(images, target=labels)
    np.testing.assert_array_equal(again["probabilities"],
                                  got["probabilities"])
    plain = port_service(env["model_dir"], mc=0).predict(images)
    assert not np.array_equal(plain["probabilities"], got["probabilities"])
