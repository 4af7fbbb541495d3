"""The port's test runners of the other families against
``rcu_tpu.strategies`` on the same store, split, yaml configs and flax
checkpoints: aleatoric (``_sigma``), the ensemble (3 members; an empty
member list raises), auxiliary_feat and auxiliary_segm (``_confidence``),
and the ISIC runs, whose run dirs link each image and ground truth and
whose ``_prediction`` artifacts an ISIC auxiliary_segm run then reads as
its baselines. Artifacts as in ``tests/test_torch_test_loop.py``: the same
files, float planes at the f32 bar, predictions equal except at argmax
ties, ``metrics.csv`` within 1e-4."""
import os

import numpy as np
import pytest

from rcu_tpu import strategies as jax_strategies
from rcu_tpu.data.split import save_split
from rcu_tpu_torch import strategies
from rcu_tpu_torch.engine import config as port_cfg
from tests.test_torch_direct import make_store
from tests.test_torch_direct_2d import (HW, NAMES, RESCALE, UNET3, make_tree,
                                        raw_images)
from tests.test_torch_strategies import make_wpred_store
from tests.test_torch_test_loop import (TEST_SUBJECTS, UNET,
                                        assert_artifacts_close,
                                        assert_metrics_close, read_nifti,
                                        run_both, run_files, seeded_model,
                                        write_config)

POSTNET = {"nb_classes": 2, "in_channels": UNET["start_filters"]}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The BraTS-like store and its [gt, baseline] twin, the split, and a
    config of each family with seeded flax weights."""
    tmp = tmp_path_factory.mktemp("torch_test_strategies")
    store = make_store(tmp)
    wpred = make_wpred_store(tmp, store)
    split = str(tmp / "split.json")
    save_split(split, ["s00"], ["s01"], TEST_SUBJECTS)
    members = [seeded_model(tmp / f"member{k}", "unet", UNET, 10 + k)
               for k in range(3)]
    segmenter = seeded_model(tmp / "segmenter", "unet", UNET, 20)
    configs = {
        "aleatoric": write_config(
            tmp / "aleatoric.yaml", "aleatoric", store, split,
            seeded_model(tmp / "sigma", "unet", {**UNET, "sigma_out": True},
                         30), {"is_log_sigma": False}),
        "ensemble": write_config(
            tmp / "ensemble.yaml", "ensemble", store, split, members[0],
            {"model_dir": members[1:], "test_at": "best"}),
        "auxiliary_feat": write_config(
            tmp / "aux_feat.yaml", "aux_feat", store, split,
            seeded_model(tmp / "postnet", "postnet", POSTNET, 40),
            {"model_dir": segmenter, "test_at": "best"}),
        "auxiliary_segm": write_config(
            tmp / "aux_segm.yaml", "aux_segm", wpred, split,
            seeded_model(tmp / "error_net", "unet",
                         {**UNET, "in_channels": 5}, 50)),
    }
    return tmp, store, split, configs


# (planes held at the f32 bar, the fg whose ties excuse a prediction)
FAMILIES = {"aleatoric": (("probabilities", "sigma"), "probabilities"),
            "ensemble": (("probabilities",), "probabilities"),
            "auxiliary_feat": (("confidence",), None),
            "auxiliary_segm": (("confidence",), None)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_run_matches_jax(env, tmp_path, family):
    _, _, _, configs = env
    run = f"test_{family}"
    jax_loop, port_loop = run_both(configs[family], tmp_path,
                                   getattr(jax_strategies, run),
                                   getattr(strategies, run))
    planes, fg = FAMILIES[family]
    extra = {"aleatoric": ["probabilities", "sigma"],
             "ensemble": ["probabilities"]}.get(family, ["confidence"])
    assert run_files(port_loop.run_dir) == sorted(
        ["config.yaml", "log.txt", "metrics.csv"]
        + [f"{s}_{p}.nii.gz" for s in TEST_SUBJECTS
           for p in ["prediction"] + extra])
    if fg is None:  # the frozen segmenter's argmax / the baseline: exact
        for s in TEST_SUBJECTS:
            np.testing.assert_array_equal(
                read_nifti(port_loop.run_dir, s, "prediction"),
                read_nifti(jax_loop.run_dir, s, "prediction"))
    assert_artifacts_close(jax_loop.run_dir, port_loop.run_dir, TEST_SUBJECTS,
                           planes, prediction_fg=fg or planes[0])
    assert_metrics_close(jax_loop.run_dir, port_loop.run_dir)
    if family == "ensemble":
        # anchored under the primary model's train dir when no test_dir
        # is given
        config = port_cfg.load(configs[family])
        loop = strategies.test_ensemble(config, device="cpu")
        assert os.path.dirname(loop.run_dir) == os.path.join(
            os.path.dirname(config.model_dir), "test")


def test_ensemble_without_members_raises(env, tmp_path):
    tmp, store, split, _ = env
    config = port_cfg.load(write_config(
        tmp_path / "e.yaml", "e", store, split, None,
        {"model_dir": [], "test_at": "best"}))
    with pytest.raises(ValueError, match='missing "model_dir"'):
        strategies.test_ensemble(config, device="cpu")
    assert not os.path.exists(tmp_path / "test")


def test_isic_runs_link_inputs_and_feed_auxiliary_segm(tmp_path):
    """ISIC: the default run through the config's rescale, linking each
    image and ground truth into the run dir; its ``_prediction``
    artifacts are the baselines of an auxiliary_segm run
    (``others.prediction_dir``)."""
    path, _ = make_tree(tmp_path, raw_images())
    model_dir = seeded_model(tmp_path / "isic_unet", "unet", UNET3, 60, HW)
    config = write_config(tmp_path / "isic.yaml", "isic", path, "", model_dir,
                          transform=RESCALE, indexing=False)
    jax_loop, port_loop = run_both(config, tmp_path / "default",
                                   jax_strategies.test_default,
                                   strategies.test_default,
                                   symlink_inputs=True)
    assert_artifacts_close(jax_loop.run_dir, port_loop.run_dir, NAMES,
                           ("probabilities",))
    assert_metrics_close(jax_loop.run_dir, port_loop.run_dir)
    for name in NAMES:
        for link, target in (
                (f"{name}.jpg", os.path.join(path + "_Data", f"{name}.jpg")),
                (f"{name}_segmentation.png", os.path.join(
                    path + "_Part1_GroundTruth",
                    f"{name}_segmentation.png"))):
            link = os.path.join(port_loop.run_dir, link)
            assert os.path.islink(link) and os.readlink(link) == target
        assert read_nifti(port_loop.run_dir, name, "probabilities").shape == HW
    error_net = seeded_model(tmp_path / "isic_error", "unet",
                             {**UNET3, "in_channels": 4}, 61, HW)
    config = write_config(tmp_path / "segm.yaml", "segm", path, "", error_net,
                          {"prediction_dir": port_loop.run_dir},
                          transform=RESCALE, indexing=False)
    jax_loop, port_loop_segm = run_both(config, tmp_path / "segm",
                                        jax_strategies.test_auxiliary_segm,
                                        strategies.test_auxiliary_segm,
                                        symlink_inputs=True)
    assert_artifacts_close(jax_loop.run_dir, port_loop_segm.run_dir, NAMES,
                           ("confidence",), prediction_fg="confidence")
    for name in NAMES:  # the baselines passed through
        np.testing.assert_array_equal(
            read_nifti(port_loop_segm.run_dir, name, "prediction"),
            read_nifti(port_loop.run_dir, name, "prediction"))
    assert_metrics_close(jax_loop.run_dir, port_loop_segm.run_dir)
