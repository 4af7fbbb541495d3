"""The staged test loop and the inference service on virtual CPU meshes,
against the port's own single-device runs of the same checkpoints and
against the JAX package's runs on its virtual CPU mesh.

- ``TestLoop`` / ``strategies.test_*`` with ``mesh=``: the loader's
  batches split over the data devices, a model copy on each; the NIfTI
  artifacts and metrics.csv equal the single device's (deterministic,
  MC on the same stream, aleatoric, the ensemble on a 1-D mesh and over a
  2 x 1 model x data mesh, auxiliary_feat); the deterministic, aleatoric
  and model x data ensemble runs against ``rcu_tpu``'s test strategies on
  ``rcu_tpu.parallel`` meshes at the f32 bar
  (``tests/test_torch_test_loop.py``'s checks).
- ``VolumeInferenceService`` in latency mode (``mesh``) and throughput
  mode (``subject_parallel``, a pool of devices): 4 client threads of
  scored requests, each answer bitwise the same service's serial one
  (``tests/test_serve.py``'s check) and the single device's (bitwise in
  throughput mode); a per_image request; int8 calibrated once, on the
  first request, then copied to every device; a scored request against
  ``rcu_tpu.serve``'s service on a 2-device mesh in either mode
  (``tests/test_torch_serve.py``'s bar).
"""
import concurrent.futures
import os

import jax
import numpy as np
import pytest

from rcu_tpu import strategies as jax_strategies
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.parallel import ensemble as jax_ensemble
from rcu_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rcu_tpu_torch import strategies
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.parallel import make_mesh
from rcu_tpu_torch.parallel.ensemble import make_ensemble_mesh
from tests.test_torch_parallel import one_thread  # noqa: F401
from rcu_tpu_torch.serve import VolumeInferenceService
from tests.test_torch_direct import PARAMS, _margin_weights, make_store
from tests.test_torch_serve import (COUNTS, assert_like_jax, jax_service,
                                    read_subjects)
from tests.test_torch_strategies import write_model
from tests.test_torch_test_loop import (TEST_SUBJECTS, UNET,  # noqa: F401
                                        assert_artifacts_close,
                                        assert_metrics_close, env, read_nifti,
                                        run_files, seeded_model, write_config)


def cpu_mesh(n):
    return make_mesh(n_devices=n, device="cpu")


def run_test(config_file, test_dir, runner, **kw):
    config = port_cfg.load(config_file, "test-config")
    config.test_dir = str(test_dir)
    return runner(config, device="cpu", **kw)


def assert_same_run(want_dir, got_dir, planes):
    assert run_files(got_dir) == run_files(want_dir)
    for subject in TEST_SUBJECTS:
        for postfix in ("prediction",) + planes:
            want = read_nifti(want_dir, subject, postfix)
            got = read_nifti(got_dir, subject, postfix)
            assert got.dtype == want.dtype
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{subject} {postfix}")
    with open(os.path.join(want_dir, "metrics.csv")) as a, \
            open(os.path.join(got_dir, "metrics.csv")) as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def models(env):  # noqa: F811
    tmp, store, split, model_dir = env
    members = [model_dir] + [seeded_model(tmp / f"member{k}", "unet", UNET,
                                          10 + k, head_scale=3.0)
                             for k in range(3)]
    return {
        "model_dir": model_dir, "members": members,
        "sigma": seeded_model(tmp / "sigma", "unet",
                              {**UNET, "sigma_out": True}, 14),
        "segmenter": seeded_model(tmp / "segm", "unet", UNET, 15),
        "postnet": seeded_model(tmp / "post", "postnet",
                                {"nb_classes": 2,
                                 "in_channels": UNET["start_filters"]}, 16,
                                head_scale=3.0)}


RUNS = {
    "deterministic": (strategies.test_default, {}, ("probabilities",)),
    "mc": (strategies.test_default, {"mc": 3}, ("probabilities",)),
    "aleatoric": (strategies.test_aleatoric, {"is_log_sigma": False},
                  ("probabilities", "sigma")),
    "ensemble": (strategies.test_ensemble, {"test_at": "best"},
                 ("probabilities",)),
    "auxiliary_feat": (strategies.test_auxiliary_feat, {"test_at": "best"},
                       ("confidence",)),
}


@pytest.mark.parametrize("run", list(RUNS) + ["ensemble_ep"])
def test_test_loop_on_a_mesh_writes_the_single_device_run(env, models,  # noqa: F811
                                                          tmp_path, run):
    _, store, split, _ = env
    runner, others, planes = RUNS["ensemble" if run == "ensemble_ep"
                                  else run]
    model_dir = {"aleatoric": models["sigma"],
                 "auxiliary_feat": models["postnet"]}.get(
        run, models["model_dir"])
    if run.startswith("ensemble"):
        others = {**others, "model_dir": models["members"][1:]}
    if run == "auxiliary_feat":
        others = {**others, "model_dir": models["segmenter"]}
    config = write_config(tmp_path / "t.yaml", run, store, split, model_dir,
                          others)
    mesh = make_ensemble_mesh(2, ["cpu"] * 4) if run == "ensemble_ep" \
        else cpu_mesh(2)
    one = run_test(config, tmp_path / "one", runner)
    many = run_test(config, tmp_path / "mesh", runner, mesh=mesh)
    assert many.device.type == "cpu" and many.mesh is mesh
    assert_same_run(one.run_dir, many.run_dir, planes)


JAX_RUNS = {
    "deterministic": (jax_strategies.test_default, strategies.test_default),
    "aleatoric": (jax_strategies.test_aleatoric, strategies.test_aleatoric),
    "ensemble_ep": (jax_strategies.test_ensemble, strategies.test_ensemble),
}


@pytest.mark.parametrize("run", list(JAX_RUNS))
def test_test_loop_on_a_mesh_matches_jax_on_its_mesh(env, models,  # noqa: F811
                                                     tmp_path, run):
    """The port's loop on a virtual CPU mesh against ``rcu_tpu``'s on its
    own (2 devices; the ensemble's members over a model axis of 2 in
    both): the artifacts at the f32 bar, the predictions equal but at
    argmax ties, metrics.csv's Dice within 1e-4."""
    _, store, split, _ = env
    jax_run, port_run = JAX_RUNS[run]
    others = RUNS["ensemble" if run == "ensemble_ep" else run][1]
    planes = RUNS["ensemble" if run == "ensemble_ep" else run][2]
    model_dir = models["sigma"] if run == "aleatoric" else models["model_dir"]
    if run == "ensemble_ep":
        others = {**others, "model_dir": models["members"][1:]}
    config = write_config(tmp_path / "t.yaml", run, store, split, model_dir,
                          others)
    if run == "ensemble_ep":
        jax_mesh = jax_ensemble.make_ensemble_mesh(2, jax.devices()[:4])
        mesh = make_ensemble_mesh(2, ["cpu"] * 4)
    else:
        jax_mesh, mesh = jax_make_mesh(n_devices=2), cpu_mesh(2)
    jax_config = jax_cfg.load(config, "test-config")
    jax_config.test_dir = str(tmp_path / "jax")
    jax_loop = jax_run(jax_config, mesh=jax_mesh)
    port_loop = run_test(config, tmp_path / "port", port_run, mesh=mesh)
    assert_artifacts_close(jax_loop.run_dir, port_loop.run_dir,
                           TEST_SUBJECTS, planes)
    assert_metrics_close(jax_loop.run_dir, port_loop.run_dir)


# ----------------------------------------------------------------- serving

def volumes(n=4, seed=12):
    rng = np.random.RandomState(seed)
    return [(rng.rand(3, 16, 20, 4).astype(np.float32),
             (rng.rand(3, 16, 20) > 0.6).astype(np.uint8)) for _ in range(n)]


def service(model_dir, **kw):
    return VolumeInferenceService(model_dir, batch_size=2, device="cpu",
                                  **kw)


def assert_bitwise(got, want):
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def assert_like_single(got, want, mode):
    """Throughput mode runs a request as one device does: bitwise. Latency
    mode splits its batches, and a CPU convolution of a part may round
    its last bit apart from the whole batch's: the maps at 1e-6, the
    prediction and the counts exact."""
    if mode == "throughput":
        return assert_bitwise(got, want)
    assert set(got) == set(want)
    for key in want:
        if key == "prediction" or key.replace("correction_", "") in COUNTS:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_concurrent_requests_are_the_serial_answers(models, mode):
    """4 client threads of 8 scored deterministic requests on a 2-entry
    mesh: each answer bitwise the serial answer of the same service, and
    as the single-device service's (:func:`assert_like_single`)."""
    single = service(models["model_dir"], mc=0)
    pooled = service(models["model_dir"], mc=0, mesh=cpu_mesh(2),
                     subject_parallel=mode == "throughput")
    assert pooled.pool_size == (2 if mode == "throughput" else 1)
    requests = volumes() * 2
    serial = [pooled.predict(images, target=target)
              for images, target in requests]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        answers = list(pool.map(
            lambda r: pooled.predict(r[0], target=r[1]), requests))
    for got, want, (images, target) in zip(answers, serial, requests):
        assert_bitwise(got, want)
        assert_like_single(got, single.predict(images, target=target), mode)
    images, target = requests[0]
    assert_like_single(
        pooled.predict(images, target=target, per_image=True),
        single.predict(images, target=target, per_image=True), mode)


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_int8_calibrates_once_then_every_device(models, mode):
    """The first request calibrates on the first device under the
    service-wide lock; the quantized copies answer as a single int8
    service does."""
    requests = volumes(3, seed=4)
    single = service(models["model_dir"], mc=0, quantize=True)
    pooled = service(models["model_dir"], mc=0, quantize=True,
                     mesh=cpu_mesh(2), subject_parallel=mode == "throughput")
    assert pooled._placed is None  # nothing placed before calibration
    for images, target in requests:
        assert_like_single(pooled.predict(images, target=target),
                           single.predict(images, target=target), mode)
    assert pooled.model.quant_scales is not None


def test_ensemble_service_over_the_model_axis(models):
    members = models["members"]
    single = service(members[0], members=members[1:], mc=0)
    ep = service(members[0], members=members[1:], mc=0,
                 mesh=make_ensemble_mesh(2, ["cpu"] * 2))
    for images, target in volumes(2):
        want = single.predict(images, target=target)
        got = ep.predict(images, target=target)
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6,
                                       atol=1e-7, err_msg=key)


@pytest.fixture(scope="module")
def margin_env(tmp_path_factory):
    """Weights that keep every deterministic fg away from the bin edges
    and 0.5 (``tests/test_torch_serve.py``'s), and the subjects."""
    tmp = tmp_path_factory.mktemp("torch_parallel_serve_jax")
    store = make_store(tmp)
    params, stats, _ = _margin_weights(store)
    return {"model_dir": write_model(tmp / "model_x", "unet", PARAMS, params,
                                     stats),
            "subjects": read_subjects(store, ("s02",))}


@pytest.mark.parametrize("mode", ["latency", "throughput"])
def test_mesh_service_matches_jax_mesh_service(margin_env, mode):
    """A scored deterministic request to the port's service on a 2-entry
    CPU mesh against ``rcu_tpu.serve``'s on a 2-device mesh in the same
    mode: the maps at the f32 bar, the prediction and the counts exact,
    the scores at rtol 1e-4."""
    images, labels = margin_env["subjects"]["s02"]
    throughput = mode == "throughput"
    want = jax_service(margin_env["model_dir"], mc=0,
                       mesh=jax_make_mesh(n_devices=2),
                       subject_parallel=throughput)
    got = service(margin_env["model_dir"], mc=0, mesh=cpu_mesh(2),
                  subject_parallel=throughput)
    assert got.batch_size == want.batch_size
    assert_like_jax(got.predict(images, target=labels),
                    want.predict(images, target=labels))
