"""The port's ``save_images`` (``rcu_tpu_torch.cli.save_images``) against
``bin/save_images.py`` on a BraTS NIfTI tree written by the JAX package's
eval actions (``test_torch_analysis_tables.build_action_tree``: a
probabilities, a sigma and a confidence run) and on an ISIC-2017 folder
with seeded 2-D predictions of the same three runs (the sigma run's bounds
from the JAX minmax action).

Bars: the same file set; the image, ground-truth and prediction PNGs and
the colorbar byte for byte; an uncertainty PNG byte for byte where the
two packages' prepared maps are bitwise equal, else its decoded pixels
within one colormap entry. The slice, box and crop helpers agree with the
JAX ones, their asserts included.
"""
import os
import sys

import numpy as np
import pytest
import torch

from rcu_tpu.data import nifti
from rcu_tpu.eval import actions as jax_actions
from rcu_tpu.eval import analysis as jax_analysis
from rcu_tpu.eval import evaldata as jax_evaldata
from rcu_tpu_torch.cli import save_images as port_tool
from rcu_tpu_torch.eval import evaldata as port_evaldata
from rcu_tpu_torch.eval import analysis as port_analysis
from tests.test_torch_analysis_tables import (
    ACTION_RUNS, BRATS_SUBJECTS, build_action_tree, load_bin, point)
from tests.test_torch_direct_2d import NAMES, make_tree, raw_images

IDS = list(ACTION_RUNS)
# per dataset: the subjects drawn, the image entry
DATASETS = {"brats": (BRATS_SUBJECTS[:2], "flair"),
            "isic": (NAMES[:2], "image")}


def build_isic_tree(root) -> dict:
    """An ISIC-2017 test folder and seeded (H, W) predictions of
    ``ACTION_RUNS``; the sigma run's minmax CSV from the JAX action ->
    the directories' values."""
    rng = np.random.RandomState(6)
    raw = raw_images()
    path, _ = make_tree(root, raw)
    pred_dir = os.path.join(str(root), "preds")
    for name, (image, _, _) in raw.items():
        for run, (entry, _) in ACTION_RUNS.items():
            os.makedirs(os.path.join(pred_dir, run), exist_ok=True)
            probs = rng.rand(*image.shape[:2]).astype(np.float32)
            nifti.write(probs, os.path.join(pred_dir, run,
                                            f"{name}_{entry}.nii.gz"))
            nifti.write((probs > 0.5).astype(np.uint8), os.path.join(
                pred_dir, run, f"{name}_prediction.nii.gz"))
    eval_dir = os.path.join(str(root), "eval")
    ed = jax_evaldata.get_isic_data(
        jax_evaldata.EvalData("aleatoric", os.path.join(pred_dir, "aleatoric"),
                              "sigma"), in_dir=path)
    (minmax,) = jax_actions.get_actions(
        ["minmax"], os.path.join(eval_dir, "minmax"), eval_dir, "")
    minmax.setup_eval(ed)
    minmax.start_eval()
    for sf in ed.subject_files:
        minmax.eval_subject(sf, jax_analysis.Loader())
    minmax.finish_eval()
    return {"ISIC_EVAL_DIR": eval_dir, "ISIC_PREDICT_DIR": pred_dir,
            "ISIC_PREPROCESSED_TEST_DATA_DIR": path,
            **{f"ISIC_{slot}_PREDICT": run
               for run, (_, slot) in ACTION_RUNS.items()}}


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("save_images")
    return {"brats": build_action_tree(str(root / "brats")),
            "isic": build_isic_tree(root / "isic")}


def _decoded(path):
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGBA"))


def _colormap_index(rgba):
    """Each pixel's nearest entry of matplotlib's 256-entry inferno map."""
    import matplotlib
    lut = (matplotlib.colormaps["inferno"](np.arange(256))[:, :3] * 255)
    dist = ((rgba[..., None, :3].astype(float) - lut) ** 2).sum(-1)
    return dist.argmin(-1)


def _prepared_maps(dataset, run_id, entry, min_max_dir):
    """{subject: (JAX map, port map)} of one run's prepared uncertainty."""
    jax_entry = getattr(jax_evaldata, f"get_{dataset}_eval_data")([run_id])[0]
    port_entry = getattr(port_evaldata,
                         f"get_{dataset}_eval_data")([run_id])[0]
    img_key = DATASETS[dataset][1]
    jax_prep, _ = jax_analysis.get_uncertainty_preparation(
        jax_entry, rescale_confidence="subject", rescale_sigma="global",
        min_max_dir=min_max_dir)
    port_prep, _ = port_analysis.get_uncertainty_preparation(
        port_entry, rescale_confidence="subject", rescale_sigma="global",
        min_max_dir=min_max_dir)
    out = {}
    for jsf, psf in zip(jax_entry.subject_files, port_entry.subject_files):
        d = jax_prep(jax_analysis.Loader().get_data(jsf, entry,
                                                    images=(img_key,)))
        p = port_tool.prepared_subject(port_prep, psf, entry, img_key,
                                       torch.device("cpu"))
        out[jsf.subject] = (np.asarray(d["uncertainty"]), p["uncertainty"])
    return out


@pytest.mark.parametrize("dataset", ["brats", "isic"])
def test_same_pngs(trees, tmp_path, monkeypatch, capsys, dataset):
    values = trees[dataset]
    subjects, _ = DATASETS[dataset]
    jax_tool = load_bin("save_images")
    key = f"{dataset.upper()}_SUBJECTS"
    for mod in (jax_tool, port_tool):
        monkeypatch.setattr(mod, key, subjects)
    plots = f"{dataset.upper()}_PLOT_DIR"
    point(monkeypatch, **{plots: str(tmp_path / "jax")}, **values)
    jax_tool.main(dataset, IDS)
    jax_out = capsys.readouterr().out
    point(monkeypatch, **{plots: str(tmp_path / "port")})
    port_tool.main(dataset, IDS, device="cpu")
    assert capsys.readouterr().out == jax_out

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)
    jax_root = tmp_path / "jax" / "images"
    port_root = tmp_path / "port" / "images"
    assert files(port_root) == files(jax_root)
    assert len(files(jax_root)) == 1 + len(subjects) * (2 + 2 * len(IDS))

    min_max_dir = os.path.join(values[f"{dataset.upper()}_EVAL_DIR"],
                               "minmax")
    maps = {run_id: _prepared_maps(dataset, run_id, entry, min_max_dir)
            for run_id, (entry, _) in ACTION_RUNS.items()}
    bitwise = 0
    for name in files(jax_root):
        with open(jax_root / name, "rb") as f:
            want = f.read()
        with open(port_root / name, "rb") as f:
            got = f.read()
        subject = os.path.dirname(name)
        run_id = next((r for r in IDS if os.path.basename(name) ==
                       f"{r}_uncert.png"), None)
        if run_id is None:
            assert got == want, name
            continue
        a, b = maps[run_id][subject]
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32
        if np.array_equal(a.view(np.int32), b.view(np.int32)):
            bitwise += 1
            assert got == want, name
        else:
            diff = np.abs(_colormap_index(_decoded(jax_root / name))
                          - _colormap_index(_decoded(port_root / name)))
            assert diff.max() <= 1, name
    assert bitwise >= 1


@pytest.mark.parametrize("seed", range(12))
def test_slice_and_bbox_equal_jax(seed):
    """Random volumes and images: the same slice, box and crops, or the same
    failure (the box leaving the image; an all-zero image)."""
    jax_tool = load_bin("save_images")
    rng = np.random.default_rng(seed)
    shape = (4, int(rng.integers(8, 40)), int(rng.integers(8, 40)))
    target = (rng.random(shape) < rng.uniform(0.0, 0.05)).astype(np.uint8)
    img = np.zeros(shape, np.float32)
    h0, w0 = rng.integers(0, shape[1] // 2), rng.integers(0, shape[2] // 2)
    img[:, h0:h0 + int(rng.integers(1, shape[1] - h0 + 1)),
        w0:w0 + int(rng.integers(1, shape[2] - w0 + 1))] = 1.0
    d = {"target": target}
    assert port_tool.select_slice(d, "brats") == \
        jax_tool.select_slice(d, "brats")
    assert port_tool.select_slice(d, "isic") == jax_tool.select_slice(d, "isic")
    rgb = np.repeat(img[0][..., None], 3, axis=-1)
    for args, kwargs in (((img[0],), {"squared": "max"}),
                         ((rgb,), {"squared": "min", "dims": 2}),
                         ((np.zeros(shape[1:]),), {})):
        try:
            want = jax_tool.get_bbox(*args, **kwargs)
        except (AssertionError, IndexError) as e:
            with pytest.raises(type(e)):
                port_tool.get_bbox(*args, **kwargs)
            continue
        got = port_tool.get_bbox(*args, **kwargs)
        assert got == want
        assert np.array_equal(port_tool.apply_bbox(args[0], got),
                              jax_tool.apply_bbox(args[0], want))


def test_device_defaults_to_the_card_and_cli_takes_cpu(trees, tmp_path,
                                                       monkeypatch):
    """No device asks for cuda, which this machine lacks; ``--device cpu``
    runs on the CPU."""
    values = trees["brats"]
    point(monkeypatch, BRATS_PLOT_DIR=str(tmp_path / "plots"), **values)
    monkeypatch.setattr(port_tool, "BRATS_SUBJECTS", BRATS_SUBJECTS[:1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_tool.main("brats", ["baseline"])
    monkeypatch.setattr(sys, "argv", ["save_images", "--ds", "brats", "--ids",
                                      "aleatoric", "--device", "cpu"])
    port_tool.cli()
    assert sorted(os.listdir(tmp_path / "plots" / "images" /
                             BRATS_SUBJECTS[0]))[0] == \
        "aleatoric_flair_pred_overlay.png"
    with pytest.raises(ValueError, match="Invalid dataset"):
        port_tool.main("other", ["baseline"], device="cpu")
