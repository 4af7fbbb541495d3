"""The port's inference service (``rcu_tpu_torch.serve``) against
``rcu_tpu.serve`` for the MC family, both loaded from one flax-schema
checkpoint written by the JAX checkpoint service.

The deterministic protocol (``mc=0``) must give the JAX service's result:
the same keys, dtypes and shapes, the maps at the f32 bar, the prediction
and the eval counts exactly, the ECE at the direct-eval tests' rtol 1e-4.
The weights keep every fg value away from the bin edges and 0.5
(``tests.test_torch_direct._margin_weights``), where a 1-ulp difference
between the frameworks would flip a count. The MC masks cannot equal
flax's: an MC request must equal the port's own ``pipeline.infer`` on the
stream ``(seed, request index)`` bitwise, scored and unscored alike.
"""
import numpy as np
import pytest
import torch

from rcu_tpu.data import h5
from rcu_tpu.serve import VolumeInferenceService as JaxService
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.parallel import make_mesh
from rcu_tpu_torch.serve import VolumeInferenceService
from tests.test_torch_direct import PARAMS, _margin_weights, make_store
from tests.test_torch_strategies import write_model

BAR = dict(rtol=1e-3, atol=2e-4)  # the f32 bar of test_model_weight_parity
SCORE_RTOL = 1e-4  # the direct-eval tests' float cells
MAPS = ("probabilities", "entropy", "sigma", "confidence")
COUNTS = ("tp", "tn", "fp", "fn", "tpu", "tnu", "fpu", "fnu")


def read_subjects(store, subjects=("s02", "s03")):
    """{subject: (images (Z, H, W, 4), labels (Z, H, W))}."""
    reader = h5.SubjectDataset(store)
    out = {s: (np.asarray(reader.read_volume(s, "images")),
               np.asarray(reader.read_volume(s, "labels"))) for s in subjects}
    reader.close()
    return out


def random_mask(shape, seed=7):
    return (np.random.RandomState(seed).rand(*shape) > 0.3).astype(np.uint8)


def port_service(model_dir, **kw):
    return VolumeInferenceService(model_dir, batch_size=2, device="cpu", **kw)


def jax_service(model_dir, **kw):
    return JaxService(model_dir, batch_size=2, **kw)


def assert_like_jax(got, want, maps=BAR):
    """The port's result against the JAX service's: keys, dtypes and
    shapes; the maps at ``maps`` (a dict of assert_allclose bars); the
    prediction, the counts and the booleans exactly; the other scores at
    rtol 1e-4."""
    assert set(got) == set(want)
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].dtype == value.dtype, key
        assert got[key].shape == value.shape, key
        name = key.replace("correction_", "")
        if key in MAPS:
            np.testing.assert_allclose(got[key], value, err_msg=key, **maps)
        elif key == "prediction" or name in COUNTS or value.dtype == bool:
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, rtol=SCORE_RTOL,
                                       atol=1e-12, err_msg=key)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    store = make_store(tmp)
    params, stats, _ = _margin_weights(store)
    return {"model_dir": write_model(tmp / "model_x", "unet", PARAMS, params,
                                     stats),
            "subjects": read_subjects(store)}


@pytest.fixture(scope="module")
def services(env):
    """The deterministic services of both packages."""
    return (jax_service(env["model_dir"], mc=0),
            port_service(env["model_dir"], mc=0))


@pytest.mark.parametrize("subject,scored,masked", [
    ("s02", False, False), ("s02", True, False), ("s03", True, True)])
def test_deterministic_matches_jax(env, services, subject, scored, masked):
    images, labels = env["subjects"][subject]
    kw = {}
    if scored:
        kw["target"] = labels
        if masked:
            kw["mask"] = random_mask(labels.shape)
    want = services[0].predict(images, **kw)
    got = services[1].predict(images, **kw)
    assert_like_jax(got, want)
    assert ("ece" in got) == scored


def test_mc_request_is_the_ports_mc_scan(env):
    """Request ``i`` of a service draws from the stream ``(seed, i)``: the
    unscored artifacts equal ``pipeline.infer`` (the port's ``_mc_scan``)
    on it bitwise, a scored request at the same index gives the same maps,
    a fresh service repeats them, the next request draws anew; the schema
    is the JAX service's."""
    images, labels = env["subjects"]["s02"]
    first = port_service(env["model_dir"], mc=3, seed=5)
    got = first.predict(images)
    want = pipeline.infer("mc", first.model,
                          {"images": torch.from_numpy(images)}, 2, mc=3,
                          rng=(5, 1))
    np.testing.assert_array_equal(got["probabilities"], want["fg"].numpy())
    np.testing.assert_array_equal(got["entropy"], want["entropy"].numpy())
    np.testing.assert_array_equal(got["prediction"],
                                  want["prediction"].numpy())
    scored = port_service(env["model_dir"], mc=3, seed=5).predict(
        images, target=labels)
    for key in ("probabilities", "entropy", "prediction"):
        np.testing.assert_array_equal(scored[key], got[key])
    again = port_service(env["model_dir"], mc=3, seed=5).predict(images)
    np.testing.assert_array_equal(again["probabilities"], got["probabilities"])
    second = first.predict(images)
    assert not np.array_equal(second["probabilities"], got["probabilities"])
    want = jax_service(env["model_dir"], mc=3).predict(images, target=labels)
    assert {k: (v.dtype, v.shape) for k, v in scored.items()} == \
        {k: (np.asarray(v).dtype, np.asarray(v).shape)
         for k, v in want.items()}


def test_single_image_and_the_small_volume_batch(env):
    """A (H, W, C) image is a one-slice volume served at batch 1; the
    served-shape labels follow the JAX service's."""
    images, labels = env["subjects"]["s02"]
    jax_svc = jax_service(env["model_dir"], mc=0)
    port = port_service(env["model_dir"], mc=0)
    for kw in ({"images": images[1]},
               {"images": images[1], "target": labels[1]},
               {"images": images[:2]}, {"images": images}):
        assert_like_jax(port.predict(**kw), jax_svc.predict(**kw))
    assert port.compiled_shapes() == jax_svc.compiled_shapes()
    assert "1-slices-b1" in port.compiled_shapes()
    assert port._effective_batch(155) == 2


def test_batch_rule_of_a_155_slice_volume(env):
    """min(batch_size, the next power of two >= Z): 155 slices at batch 32
    run as 32, 32, 32, 32 and a ragged 27, as the direct eval runs them."""
    service = VolumeInferenceService(env["model_dir"], mc=0, batch_size=32,
                                     device="cpu")
    assert [service._effective_batch(z) for z in (1, 2, 3, 17, 155)] == \
        [1, 2, 4, 32, 32]
    split = pipeline._split(155, 32, None, torch.device("cpu"))
    assert [hi - lo for lo, hi, _ in split.batches] == [32, 32, 32, 32, 27]


def test_served_shapes_lru_at_its_cap(env):
    """The labels of the shapes served stay a bounded LRU; an evicted shape
    still answers."""
    images, labels = env["subjects"]["s02"]
    jax_svc = jax_service(env["model_dir"], mc=0, max_programs=2)
    port = port_service(env["model_dir"], mc=0, max_programs=2)
    volume = np.concatenate([images, images])
    target = np.concatenate([labels, labels])
    for nz in (2, 3, 4, 2):
        kw = dict(images=volume[:nz], target=target[:nz])
        assert_like_jax(port.predict(**kw), jax_svc.predict(**kw))
        assert port.compiled_shapes() == jax_svc.compiled_shapes()
        assert len(port.compiled_shapes()) <= 2


def test_per_image_rows_equal_single_requests(env, services):
    """K images in one request: each row equals that image's own request
    (one kernel launch for all K) and the JAX service's row."""
    images, labels = env["subjects"]["s03"]
    got = services[1].predict(images, target=labels, per_image=True)
    assert_like_jax(got, services[0].predict(images, target=labels,
                                             per_image=True))
    assert got["ece"].shape == (3,) and "probabilities" not in got
    for i in range(3):
        single = services[1].predict(images[i], target=labels[i])
        np.testing.assert_allclose(got["ece"][i], single["ece"], rtol=1e-5,
                                   atol=1e-7)
        for key in single:
            if key.startswith("correction_"):
                np.testing.assert_allclose(got[key][i], single[key],
                                           rtol=1e-5, atol=1e-7)


REJECTIONS = {
    "mask without a target": dict(mask=np.ones((3, 16, 20), np.uint8)),
    "target shape": dict(target=np.zeros((3, 4, 4), np.uint8)),
    "channels": dict(images=np.zeros((3, 16, 20, 3), np.float32)),
    "images rank": dict(images=np.zeros((16, 20), np.float32)),
    "empty": dict(images=np.zeros((0, 16, 20, 4), np.float32)),
    "baseline elsewhere": dict(baseline=np.zeros((3, 16, 20), np.uint8)),
    "sigma bounds elsewhere": dict(sigma_bounds=(0.0, 1.0)),
    "per_image without targets": dict(per_image=True),
    "per_image target shape": dict(per_image=True,
                                   target=np.zeros((2, 16, 20), np.uint8)),
}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_rejections_are_jax_s(env, services, case):
    kw = {"images": np.zeros((3, 16, 20, 4), np.float32), **REJECTIONS[case]}
    with pytest.raises(ValueError) as want:
        services[0].predict(**kw)
    with pytest.raises(ValueError) as got:
        services[1].predict(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(mc=3, fold_bn=True),
    dict(members=["x"], aux_segm=True),
    dict(segm_model_dir="x", aux_segm=True)])
def test_constructor_rejections_are_jax_s(env, kw):
    with pytest.raises(ValueError) as want:
        jax_service(env["model_dir"], **kw)
    with pytest.raises(ValueError) as got:
        port_service(env["model_dir"], **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(), dict(subject_parallel=True)])
def test_multi_device_modes_wait_for_their_slice(env, kw):
    """The service on a virtual 2-entry CPU mesh, in latency mode (each
    request split over the devices) and throughput mode (a device a
    request): an MC request, scored and unscored, answers as one device
    does on the stream ``(seed, request index)``: bitwise in throughput
    mode, the maps at 1e-6 and the counts exact in latency mode (the
    per-device forwards may round apart in the last bit); the mode's
    batch rule and pool (the modes themselves:
    tests/test_torch_parallel_serve.py)."""
    images, labels = env["subjects"]["s02"]
    mesh = make_mesh(n_devices=2, device="cpu")
    one = port_service(env["model_dir"], mc=3, seed=5)
    many = port_service(env["model_dir"], mc=3, seed=5, mesh=mesh, **kw)
    assert many.pool_size == (2 if kw else 1)
    assert many.batch_size == 2 and many._effective_batch(1) == (1 if kw
                                                                 else 2)
    for request in ({}, {"target": labels}):
        want, got = one.predict(images, **request), \
            many.predict(images, **request)
        assert set(got) == set(want)
        for key, value in want.items():
            if kw or key.replace("correction_", "") in COUNTS \
                    or key == "prediction":
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                np.testing.assert_allclose(got[key], value, rtol=1e-6,
                                           atol=1e-6, err_msg=key)


def test_the_card_is_the_default(env, monkeypatch):
    """No device asked for: the service runs on the card, and raises where
    there is none rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VolumeInferenceService(env["model_dir"], mc=0)
