"""The port's native-2D (ISIC) direct eval against ``rcu_tpu.eval.direct``
for the confidence and sigma protocols: aleatoric (two passes, the run's
global sigma bounds), auxiliary_feat (segmenter + PostNet, each image
rescaled by its own confidence range) and auxiliary_segm (an error net on
the images and a baseline prediction), on the synthetic ISIC folder tree of
``tests/test_torch_direct_2d.py`` through the ``rescale`` transform and on
the native-2D H5 store of the same rescaled images.

The same CSVs as the JAX package's must come out (integer and boolean
cells exactly, floats at rtol 1e-4), on weights whose rescaled and folded
planes keep a margin from every threshold and bin edge. The native-2D
path equals the port's own volume path on the images stored as Z = 1
volumes.

Two differences of the JAX driver are held here too. Its sigma-bounds pass
(A) hands the transform zero labels beside each image, which a rescale of
the labels refuses as constant, so ``config/test_isic_aleatoric.yaml``
raises there; the port hands that pass the images alone, and is compared
with the JAX package under a rescale of the images only (the targets are
``labels > 0.5`` either way). And the JAX direct eval opens the folder
dataset without ``others.prediction_dir``; the port reads it, as the
staged test loop does, so the JAX run here gets it through its
``build_dataset``.
"""
import numpy as np
import pytest

from rcu_tpu.engine import databuild as jax_databuild
from tests.test_torch_direct_2d import (HW, N_IMAGES, NAMES, UNET3, Env,
                                        assert_same_csvs, image_inputs,
                                        run_jax, run_port)
from tests.test_torch_strategies import (FOLD_EDGES, THRESHOLDS,
                                         apply, bins_hit, confidence_gaps,
                                         fold, gap, rescale, search, softmax,
                                         spread_head, write_model)
from tests.test_torch_unet import flax_net
from tests.test_torch_variants import calibrate

IMAGES_ONLY = [{"rescale": {"entries": ["images"], "lower": 0, "upper": 1}}]


def aleatoric_weights(inputs, is_log_sigma):
    """A sigma head whose globally rescaled and folded planes keep the
    margin (``tests/test_torch_strategies.aleatoric_weights`` at 3
    channels)."""
    x = np.concatenate(inputs)
    params = {**UNET3, "sigma_out": True}

    def candidate(seed):
        fm, p, stats = flax_net("unet", params, HW, seed=800 + seed)
        p = spread_head(fm, p, stats, x, "Conv_2")
        low = float(np.asarray(apply(fm, p, stats, x).sigma).min())
        p = {**p, "Conv_3": {**p["Conv_3"], "bias": p["Conv_3"]["bias"]
                             + np.float32(0.5 - low)}}
        out = apply(fm, p, stats, x)
        probs = softmax(out.logits)
        pred = probs.argmax(-1)
        sigma = np.exp(out.sigma) if is_log_sigma else np.abs(out.sigma)
        sigma = np.take_along_axis(np.asarray(sigma), pred[..., None],
                                   -1)[..., 0]
        resc = rescale(sigma, sigma.min(), sigma.max())
        margin = min(gap(resc, THRESHOLDS), gap(fold(resc, pred), FOLD_EDGES),
                     float(np.abs(probs[..., 1] - probs[..., 0]).min()))
        return margin if bins_hit(fold(resc, pred)) >= 4 else 0.0, \
            (params, p, stats)

    return search(candidate, "aleatoric")


def aux_feat_weights(inputs):
    """A segmenter giving its features and a PostNet on them, each image's
    own rescale keeping the margin."""
    params = {**UNET3, "provide_features": True}
    post = dict(nb_classes=2, in_channels=UNET3["start_filters"])
    x = np.concatenate(inputs)

    def candidate(seed):
        fm, p, stats = flax_net("unet", params, HW, seed=900 + seed)
        p = spread_head(fm, p, stats, x, "Conv_2")
        features = np.asarray(apply(fm, p, stats, x).features)
        fp, pp, pstats = flax_net("postnet", post, HW, seed=950 + seed)
        # the PostNet's BatchNorm statistics those of the features: the
        # random ones would leave its logits all but constant
        pstats = calibrate("postnet", post, pp, pstats, features)
        pp = spread_head(fp, pp, pstats, features, "Conv_0")
        confs, preds, margin = [], [], np.inf
        for image in inputs:
            out = apply(fm, p, stats, image)
            logits = np.asarray(out.logits)
            margin = min(margin, float(np.abs(logits[..., 1]
                                              - logits[..., 0]).min()))
            preds.append(logits.argmax(-1))
            confs.append(softmax(apply(fp, pp, pstats,
                                       out.features).logits)[..., 1])
        margin = min(margin, confidence_gaps(confs, preds))
        return 0.0 if np.isnan(margin) else margin, ((p, stats), (pp, pstats))

    return search(candidate, "auxiliary_feat")


def aux_segm_weights(inputs, baselines):
    """A 4-channel error net (images and the baseline), each image's own
    rescale keeping the margin."""
    params = {**UNET3, "in_channels": 4}

    def candidate(seed):
        fm, p, stats = flax_net("unet", params, HW, seed=1000 + seed)
        p = spread_head(fm, p, stats, np.concatenate(inputs), "Conv_2")
        confs = [softmax(apply(fm, p, stats, x).logits)[..., 1]
                 for x in inputs]
        margin = confidence_gaps(confs, baselines)
        return 0.0 if np.isnan(margin) else margin, (params, p, stats)

    return search(candidate, "auxiliary_segm")


def aleatoric_dir(env):
    return write_model(env.tmp / "sigma", "unet",
                       *aleatoric_weights(image_inputs(env.arrays), True))


def aux_feat_dirs(env):
    (p, stats), (pp, pstats) = aux_feat_weights(image_inputs(env.arrays))
    segmenter = write_model(env.tmp / "segmenter", "unet", UNET3, p, stats)
    postnet = write_model(env.tmp / "postnet", "postnet", {"nb_classes": 2},
                          pp, pstats)
    return segmenter, postnet


def aux_segm_dir(env):
    baselines = [b[None] for _, _, b in env.arrays.values()]
    return write_model(env.tmp / "error_net", "unet", *aux_segm_weights(
        image_inputs(env.arrays, with_baseline=True), baselines))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    env = Env(tmp_path_factory.mktemp("torch_direct_2d_conf"))
    env.flat_wpred, env.vol_wpred = env.stores(with_baseline=True)
    return env


def family_configs(env, family, dataset, batch_size=4):
    """(the port's config, the JAX package's config) of ``family``."""
    if family == "aleatoric":
        model_dir, others = env.model("aleatoric", aleatoric_dir), \
            {"is_log_sigma": True}
        jax_transform = IMAGES_ONLY
    elif family == "auxiliary_feat":
        segmenter, postnet = env.model("auxiliary_feat", aux_feat_dirs)
        model_dir, others = postnet, {"model_dir": segmenter,
                                      "test_at": "best"}
        jax_transform = None
    else:
        model_dir, others = env.model("auxiliary_segm", aux_segm_dir), \
            {"prediction_dir": env.pred_dir}
        jax_transform = None
        dataset = {"flat": env.flat_wpred, "vol": env.vol_wpred}.get(
            dataset, dataset)
    port = env.config(family, model_dir, others, dataset, batch_size)
    if jax_transform is None or dataset != "folder":
        return port, port
    return port, env.config(family + "_jax", model_dir, others, dataset,
                            batch_size, transform=jax_transform)


@pytest.mark.parametrize("dataset", ["folder", "flat"])
@pytest.mark.parametrize("family,suffix,entry", [
    ("aleatoric", "_globalrescale", "sigma"),
    ("auxiliary_feat", "_rescale", "confidence"),
    ("auxiliary_segm", "_rescale", "confidence")])
def test_confidence_family_matches_jax(env, tmp_path, monkeypatch, family,
                                       suffix, entry, dataset):
    port_config, jax_config = family_configs(env, family, dataset)
    if family == "auxiliary_segm":
        build = jax_databuild.build_dataset
        monkeypatch.setattr(
            jax_databuild, "build_dataset",
            lambda config, subjects=None, prediction_dir=None: build(
                config, subjects, env.pred_dir))
    jax_eces = run_jax(jax_config, tmp_path / "jax", run_id=family,
                       strategy=family)
    # the port detects the strategy; one launch a part (aleatoric: in
    # its second pass)
    port_eces = run_port(port_config, tmp_path / "port", parts=2,
                         run_id=family)
    assert jax_eces.keys() == port_eces.keys() == set(NAMES)
    assert all(np.isfinite(e) for e in port_eces.values())
    csvs = assert_same_csvs(tmp_path / "jax", tmp_path / "port")
    result_id = family + suffix
    minmax = csvs[f"eval_summary_minmax_{family}.csv"]
    assert minmax[1][0] == entry
    rows = csvs[f"eval_ece_{result_id}.csv"]
    assert [r[1] for r in rows[1:]] == NAMES
    counts = [int(c) for c in csvs[f"eval_calibration_{result_id}.csv"][1][2:12]]
    assert sum(c > 0 for c in counts) >= 3, counts


def test_jax_sigma_pass_refuses_a_label_rescale(env, tmp_path):
    """config/test_isic_aleatoric.yaml rescales the labels: the JAX
    driver's pass A rescales zero labels and raises; the port's pass A
    reads no labels, and its run equals the JAX run under a rescale of the
    images alone (above)."""
    port_config, _ = family_configs(env, "aleatoric", "folder")
    with pytest.raises(ValueError, match="constant value"):
        run_jax(port_config, tmp_path / "jax", run_id="aleatoric",
                strategy="aleatoric")
    eces = run_port(port_config, tmp_path / "port", parts=2,
                    run_id="aleatoric")
    assert len(eces) == N_IMAGES


@pytest.mark.parametrize("family", ["aleatoric", "auxiliary_feat",
                                    "auxiliary_segm"])
def test_image_path_equals_volume_path(env, tmp_path, family):
    """The images as native-2D subjects (K = 4) and as Z = 1 volumes give
    the same CSVs: an image is a subject."""
    flat, _ = family_configs(env, family, "flat")
    vol, _ = family_configs(env, family, "vol", batch_size=1)
    run_port(flat, tmp_path / "flat", parts=2, run_id=family)
    run_port(vol, tmp_path / "vol", parts=N_IMAGES, run_id=family)
    assert_same_csvs(tmp_path / "vol", tmp_path / "flat")



def test_prediction_dir_equals_the_stored_baseline(env, tmp_path):
    """auxiliary_segm on the folder tree with ``others.prediction_dir``
    (each baseline merged as a second label channel x 255, then the
    rescale) gives the CSVs of the native-2D store that holds the same
    images with [gt, baseline] labels: a reference for the port's reading
    of ``prediction_dir``, which the JAX direct eval ignores."""
    folder, _ = family_configs(env, "auxiliary_segm", "folder")
    flat, _ = family_configs(env, "auxiliary_segm", "flat")
    run_port(folder, tmp_path / "folder", parts=2, run_id="auxiliary_segm")
    run_port(flat, tmp_path / "flat", parts=2, run_id="auxiliary_segm")
    assert_same_csvs(tmp_path / "flat", tmp_path / "folder")
