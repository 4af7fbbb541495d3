"""The port's inference service against ``rcu_tpu.serve`` for the four
other families: aleatoric, ensemble, auxiliary_feat and auxiliary_segm,
each loaded by both packages from the same flax-schema checkpoints.

Unscored and scored requests must give the JAX service's result (keys,
dtypes, shapes; maps at the f32 bar, predictions and counts exact). The
weights are ``tests.test_torch_strategies``' margin-searched ones, whose
planes keep away from every threshold, bin edge and argmax tie on the
test subjects; an aleatoric request carries the run's global sigma bounds
over both subjects, as the search assumed. Per-image rows must equal one
request an image.
"""
import numpy as np
import pytest

from rcu_tpu_torch.serve import VolumeInferenceService
from tests.test_torch_direct import make_store
from tests.test_torch_serve import (assert_like_jax, jax_service,
                                    port_service, random_mask, read_subjects)
from tests.test_torch_strategies import (UNET, aleatoric_weights,
                                         aux_feat_weights, aux_segm_weights,
                                         ensemble_weights, make_wpred_store,
                                         read_test_volumes, write_model)

SUBJECTS = ("s02", "s03")


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """{family: the services' constructor keywords (model_dir first)}, the
    test subjects and their baselines."""
    tmp = tmp_path_factory.mktemp("torch_serve_families")
    store = make_store(tmp)
    wpred = make_wpred_store(tmp, store)
    volumes = read_test_volumes(store)
    params, p, stats = aleatoric_weights(volumes, is_log_sigma=False)
    families = {"aleatoric": dict(
        model_dir=write_model(tmp / "aleatoric", "unet", params, p, stats),
        is_log_sigma=False)}
    dirs = [write_model(tmp / f"member{k}", "unet", UNET, p, stats)
            for k, (p, stats) in enumerate(ensemble_weights(volumes))]
    families["ensemble"] = dict(model_dir=dirs[0], members=dirs[1:])
    (p, stats), (pp, pstats) = aux_feat_weights(volumes)
    families["auxiliary_feat"] = dict(
        model_dir=write_model(tmp / "postnet", "postnet",
                              {"nb_classes": 2, "in_channels": 4}, pp, pstats),
        segm_model_dir=write_model(tmp / "segmenter", "unet", UNET, p, stats))
    params, p, stats = aux_segm_weights(read_test_volumes(wpred))
    families["auxiliary_segm"] = dict(
        model_dir=write_model(tmp / "error_net", "unet", params, p, stats),
        aux_segm=True)
    labels = read_subjects(wpred, SUBJECTS)
    subjects = {s: (images, labels[s][1][..., 0], labels[s][1][..., 1])
                for s, (images, _) in read_subjects(store, SUBJECTS).items()}
    return families, subjects


@pytest.fixture(scope="module")
def services(env):
    """{family: (the JAX service, the port's)}."""
    families, _ = env
    return {name: (jax_service(kw["model_dir"], **{
        k: v for k, v in kw.items() if k != "model_dir"}),
        port_service(kw["model_dir"], **{
            k: v for k, v in kw.items() if k != "model_dir"}))
        for name, kw in families.items()}


@pytest.fixture(scope="module")
def sigma_bounds(env, services):
    """The run's global sigma bounds: the JAX service's unscored sigma over
    both subjects."""
    _, subjects = env
    sigmas = [services["aleatoric"][0].predict(subjects[s][0])["sigma"]
              for s in SUBJECTS]
    return (float(min(s.min() for s in sigmas)),
            float(max(s.max() for s in sigmas)))


def request(family, subject, scored, bounds=None, masked=False):
    images, target, baseline = subject
    kw = {"images": images}
    if family == "auxiliary_segm":
        kw["baseline"] = baseline
    if family == "aleatoric" and (scored or bounds is not None):
        kw["sigma_bounds"] = bounds
    if scored:
        kw["target"] = target
        if masked:
            kw["mask"] = random_mask(target.shape)
    return kw


@pytest.mark.parametrize("family", ["aleatoric", "ensemble", "auxiliary_feat",
                                    "auxiliary_segm"])
@pytest.mark.parametrize("subject,scored", [("s02", False), ("s02", True),
                                            ("s03", True)])
def test_family_matches_jax(env, services, sigma_bounds, family, subject,
                            scored):
    _, subjects = env
    jax_svc, port = services[family]
    assert port.strategy == jax_svc.strategy == family
    assert port.in_channels == jax_svc.in_channels
    kw = request(family, subjects[subject], scored, sigma_bounds,
                 masked=subject == "s03")
    want = jax_svc.predict(**kw)
    got = port.predict(**kw)
    assert_like_jax(got, want)
    assert ("ece" in got) == scored


def test_unscored_aleatoric_with_bounds_folds_on_the_host(env, services,
                                                          sigma_bounds):
    _, subjects = env
    kw = request("aleatoric", subjects["s02"], False, sigma_bounds)
    want = services["aleatoric"][0].predict(**kw)
    got = services["aleatoric"][1].predict(**kw)
    assert "confidence" in got
    assert_like_jax(got, want)


@pytest.mark.parametrize("family", ["aleatoric", "ensemble", "auxiliary_feat",
                                    "auxiliary_segm"])
def test_unscored_artifacts_are_the_scored_ones(env, services, sigma_bounds,
                                                family):
    """An unscored request's artifacts (``pipeline.infer``; aleatoric with
    the run's bounds, folded on the host) equal a scored request's
    (``pipeline.evaluate`` with ``artifacts``) bitwise: every map the
    scored one sends, the unscored one sends too."""
    _, subjects = env
    port = services[family][1]
    unscored = port.predict(**request(family, subjects["s02"], False,
                                      sigma_bounds))
    scored = port.predict(**request(family, subjects["s02"], True,
                                    sigma_bounds))
    maps = {k for k in scored if k != "ece"
            and not k.startswith("correction_")}
    assert maps and maps <= set(unscored)
    for key in maps:
        assert scored[key].dtype == unscored[key].dtype, key
        np.testing.assert_array_equal(scored[key], unscored[key],
                                      err_msg=key)


@pytest.mark.parametrize("family", ["aleatoric", "ensemble", "auxiliary_feat",
                                    "auxiliary_segm"])
def test_per_image_rows_equal_single_requests(env, services, sigma_bounds,
                                              family):
    _, subjects = env
    jax_svc, port = services[family]
    kw = request(family, subjects["s03"], True, sigma_bounds)
    got = port.predict(per_image=True, **kw)
    want = jax_svc.predict(per_image=True, **kw)
    assert {k: (v.dtype, v.shape) for k, v in got.items()} == \
        {k: (np.asarray(v).dtype, np.asarray(v).shape)
         for k, v in want.items()}
    for i in range(len(kw["images"])):
        single = port.predict(**{k: (v[i] if isinstance(v, np.ndarray)
                                     else v) for k, v in kw.items()})
        np.testing.assert_allclose(got["ece"][i], single["ece"], rtol=1e-5,
                                   atol=1e-7)
        for key in single:
            if key.startswith("correction_"):
                np.testing.assert_allclose(got[key][i], single[key],
                                           rtol=1e-5, atol=1e-7)


def test_family_rejections_are_jax_s(env, services, sigma_bounds):
    families, subjects = env
    images = subjects["s02"][0]
    target = subjects["s02"][1]
    cases = [
        ("aleatoric", dict(images=images, target=target)),
        ("aleatoric", dict(images=images, sigma_bounds=(1.0, 1.0))),
        ("auxiliary_segm", dict(images=images)),
        ("auxiliary_segm", dict(images=images,
                                baseline=np.zeros((2, 16, 20), np.uint8))),
        ("ensemble", dict(images=images, sigma_bounds=sigma_bounds)),
    ]
    for family, kw in cases:
        with pytest.raises(ValueError) as want:
            services[family][0].predict(**kw)
        with pytest.raises(ValueError) as got:
            services[family][1].predict(**kw)
        assert str(got.value) == str(want.value), family
    model_dir = families["aleatoric"]["model_dir"]
    for kw in (dict(), dict(is_log_sigma=False, quantize=True)):
        with pytest.raises(ValueError) as want:
            jax_service(model_dir, **kw)
        with pytest.raises(ValueError) as got:
            port_service(model_dir, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="quantize=True covers"):
        VolumeInferenceService(device="cpu", quantize=True,
                               **families["auxiliary_feat"])
