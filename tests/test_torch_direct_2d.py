"""The port's native-2D (ISIC) direct eval against ``rcu_tpu.eval.direct``:
the softmax protocols (deterministic, ensemble, mc) on a synthetic ISIC
image-folder tree through the ``rescale`` transform of
``config/test_isic_*.yaml``, and on a native-2D H5 store that holds the
same images already rescaled; K = 4 images a chunk over 6 images, so the
last chunk is a ragged tail of 2.

Deterministic protocols write the same CSVs as the JAX package (integer
and boolean cells exactly, floats at rtol 1e-4), on weights whose planes
keep a margin from every bin edge, threshold and argmax tie. MC masks
cannot equal flax's: the mc run is held to the file set and row keys, and
at 200 samples the run's mean MC probability to within 0.02 of the JAX
package's (ROADMAP's distributional bar on MC means). The port's own invariants:
the native-2D path equals its volume path on the same images stored as
Z = 1 volumes, a deterministic run does not depend on K, a chunk's MC
stream is named by its first image's offset, a chunk of mixed image sizes
splits into same-shape parts, and labels with a channel axis on a 2-D
store drop to it.

The helpers here also build the confidence families' data
(``tests/test_torch_direct_2d_conf.py``).
"""
import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from rcu_tpu.data import h5, nifti
from rcu_tpu.data.nifti import ImageProperties
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu_torch.cli import eval_direct as port_cli
from rcu_tpu_torch.data.transforms import Rescale
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import device as eval_device
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_direct import _cell_equal, read_dir
from tests.test_torch_strategies import (EDGES, THRESHOLDS, apply,
                                         bins_hit, gap, search, softmax,
                                         spread_head, write_model)
from tests.test_torch_unet import flax_net

HW = (16, 20)
N_IMAGES = 6
K = 4  # images a chunk: one full chunk and a ragged tail of 2
NAMES = [f"ISIC_{i:07d}" for i in range(N_IMAGES)]
UNET3 = dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
             dropout=0.2)
RESCALE = [{"rescale": {"entries": ["images", "labels"], "lower": 0,
                        "upper": 1}}]
MC_MEAN_ATOL = 0.02  # MC means, tests/test_model_weight_parity.py:203
MC_SAMPLES = 200


def raw_images(seed=11, sizes=None):
    """{name: (RGB uint8 image, {0, 255} mask, 0/1 baseline prediction)}:
    a bright lesion on noise; the baseline misses a block of the lesion
    and adds a false one."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, name in enumerate(NAMES):
        h, w = (sizes or {}).get(name, HW)
        mask = np.zeros((h, w), np.uint8)
        mask[3 + i % 3:11 + i % 2, 4 + i % 4:13 + i % 3] = 255
        image = (rng.rand(h, w, 3) * 90).astype(np.uint8)
        image[..., 0] = np.where(mask > 0, 150 + 10 * i, image[..., 0])
        baseline = (mask > 0).astype(np.uint8)
        baseline[3:6, 4:7] = 0
        baseline[12:14, 14:17] = 1
        out[name] = (image, mask, baseline)
    return out


def make_tree(root, raw, task="ISIC-2017_Test_v2"):
    """The ISIC-2017 folder layout of ``raw`` under ``root``; returns the
    dataset path and the prediction dir of the baselines. The images are
    JPEGs, as the real ones are: both packages decode them with PIL."""
    path = os.path.join(str(root), task)
    os.makedirs(path + "_Data", exist_ok=True)
    os.makedirs(path + "_Part1_GroundTruth", exist_ok=True)
    pred_dir = os.path.join(str(root), "predictions")
    os.makedirs(pred_dir, exist_ok=True)
    for name, (image, mask, baseline) in raw.items():
        Image.fromarray(image).save(os.path.join(path + "_Data",
                                                 f"{name}.jpg"))
        Image.fromarray(mask).save(os.path.join(
            path + "_Part1_GroundTruth", f"{name}_segmentation.png"))
        nifti.write(baseline, os.path.join(pred_dir,
                                           f"{name}_prediction.nii.gz"))
    return path, pred_dir


def rescaled(path, raw):
    """{name: (images f32, labels 0/1 uint8, baseline 0/1 uint8)}: the
    decoded JPEGs and masks through the config's rescale, as the model
    reads them."""
    out = {}
    for name, (_, mask, baseline) in raw.items():
        image = np.asarray(Image.open(
            os.path.join(path + "_Data", f"{name}.jpg")).convert("RGB"))
        sample = Rescale(0, 1)({"images": image, "labels": mask})
        out[name] = (sample["images"], sample["labels"].astype(np.uint8),
                     baseline)
    return out


def write_store(path, arrays, volume=False, with_baseline=False,
                label_axis=False):
    """A native-2D H5 store of ``arrays`` (or with ``volume`` the Z = 1
    volume twin); labels [gt, baseline] with ``with_baseline``, (H, W, 1)
    with ``label_axis``."""
    with h5.DatasetWriter(path) as w:
        for name, (images, labels, baseline) in arrays.items():
            if with_baseline:
                labels = np.stack([labels, baseline], axis=-1)
            elif label_axis:
                labels = labels[..., None]
            if volume:
                images, labels = images[None], labels[None]
            w.add_subject(name, {"images": images, "labels": labels},
                          props=ImageProperties(size=images.shape[::-1][1:]))
    return path


def write_config(path, model_dir, dataset, others, batch_size=K,
                 transform=None):
    with open(path, "w") as f:
        yaml.safe_dump({"config": {
            "test_name": "isic_port", "model_dir": model_dir, "split": "",
            "seed": 20, "test_at": "best", "others": others,
            "test_data": {"batch_size": batch_size, "dataset": dataset,
                          "shuffle": False, "transform": transform}},
            "meta": {"type": "test-config", "version": 0}}, f)
    return str(path)


def image_inputs(arrays, with_baseline=False):
    """The model inputs, one (1, H, W, C) array an image."""
    return [np.concatenate([im, b[..., None].astype(np.float32)], -1)[None]
            if with_baseline else im[None] for im, _, b in arrays.values()]


def unet_weights(inputs, params=UNET3):
    """U-Net weights whose deterministic fg keeps MARGIN from every bin
    edge (0.5 among them) and spreads over the bins."""
    x = np.concatenate(inputs)

    def candidate(seed):
        fm, p, stats = flax_net("unet", params, HW, seed=600 + seed)
        p = spread_head(fm, p, stats, x, "Conv_2")
        fg = softmax(apply(fm, p, stats, x).logits)[..., 1]
        margin = gap(fg, EDGES) if bins_hit(fg) >= 4 else 0.0
        return margin, (params, p, stats)

    return search(candidate, "unet")


def ensemble_weights(inputs, n_members=3):
    x = np.concatenate(inputs)

    def candidate(seed):
        members, total = [], 0.0
        for k in range(n_members):
            fm, p, stats = flax_net("unet", UNET3, HW,
                                    seed=700 + 10 * seed + k)
            p = spread_head(fm, p, stats, x, "Conv_2")
            total = total + softmax(apply(fm, p, stats, x).logits)
            members.append((p, stats))
        probs = total / n_members
        ent = -(probs * np.log(probs)).sum(-1) / np.log(2.0)
        margin = min(gap(probs[..., 1], EDGES), gap(ent, THRESHOLDS))
        return margin if bins_hit(probs[..., 1]) >= 4 else 0.0, members

    return search(candidate, "ensemble")


class Env:
    """The data of the native-2D runs, built once a module; each family's
    checkpoints on first use."""

    def __init__(self, tmp, sizes=None):
        self.tmp = tmp
        self.raw = raw_images(sizes=sizes)
        self.tree, self.pred_dir = make_tree(tmp, self.raw)
        self.arrays = rescaled(self.tree, self.raw)
        self.flat = write_store(str(tmp / "flat.h5"), self.arrays)
        self.vol = write_store(str(tmp / "vol.h5"), self.arrays, volume=True)
        self._models = {}

    def stores(self, with_baseline=False):
        if not with_baseline:
            return self.flat, self.vol
        return (write_store(str(self.tmp / "flat_wpred.h5"), self.arrays,
                            with_baseline=True),
                write_store(str(self.tmp / "vol_wpred.h5"), self.arrays,
                            volume=True, with_baseline=True))

    def model(self, name, build):
        """The model dir (or dirs) of ``name``, written by ``build(self)``
        once."""
        if name not in self._models:
            self._models[name] = build(self)
        return self._models[name]

    def config(self, name, model_dir, others, dataset="folder",
               batch_size=K, transform=RESCALE):
        """A config over the folder tree (with ``transform``) or a store."""
        stores = {"folder": self.tree, "flat": self.flat, "vol": self.vol}
        if dataset != "folder":
            transform = None
        label = dataset if dataset in stores else os.path.basename(dataset)
        return write_config(self.tmp / f"{name}_{label}_{batch_size}.yaml",
                            model_dir, stores.get(dataset, dataset), others,
                            batch_size, transform)


def deterministic_dir(env):
    return write_model(env.tmp / "unet", "unet",
                       *unet_weights(image_inputs(env.arrays)))


def mc_dir(env):
    """A 16-filter U-Net at the flagship's dropout (0.05) with a head of
    logit spread 1: at 200 samples, two MC streams of it agree on the
    run's mean fg to a few 1e-3, where a 4-filter net at dropout 0.2 moves
    a pixel's mean by up to 0.1 from one stream to the next."""
    params = {**UNET3, "start_filters": 16, "dropout": 0.05}
    x = np.concatenate(image_inputs(env.arrays))
    fm, p, stats = flax_net("unet", params, HW, seed=5)
    p = spread_head(fm, p, stats, x, "Conv_2", std=1.0)
    return write_model(env.tmp / "unet_mc", "unet", params, p, stats)


def ensemble_dirs(env):
    return [write_model(env.tmp / f"member{k}", "unet", UNET3, p, stats)
            for k, (p, stats) in enumerate(ensemble_weights(
                image_inputs(env.arrays)))]


def assert_same_csvs(want_dir, got_dir, n=N_IMAGES):
    want, got = read_dir(want_dir), read_dir(got_dir)
    assert got.keys() == want.keys()
    assert len(want) == 14  # calibration, ece, minmax + 11 thresholds
    for name, rows in want.items():
        assert len(got[name]) == len(rows), name
        assert got[name][0] == rows[0], name  # header
        if "minmax" not in name:
            assert len(rows) == n + 1, name
        for want_row, got_row in zip(rows[1:], got[name][1:]):
            for col, a, b in zip(rows[0], got_row, want_row):
                assert _cell_equal(a, b), (name, col, a, b)
    return want


def run_jax(config_file, out_dir, **kw):
    return jax_evaluate_direct(jax_cfg.load(config_file, "test-config"),
                               str(out_dir), masked=False, **kw)


def run_port(config_file, out_dir, parts=None, **kw):
    """The port's run; ``parts``: the eval launches it must make, one a
    same-shape part of a chunk (CPU: plain calls)."""
    plain = evalstats.fused_eval_stats.plain_calls
    eces = port_direct.evaluate_direct(port_cfg.load(config_file),
                                       str(out_dir), masked=False,
                                       device="cpu", **kw)
    if parts is not None:
        assert evalstats.fused_eval_stats.plain_calls - plain == parts
    return eces


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return Env(tmp_path_factory.mktemp("torch_direct_2d"))


def family_config(env, family, dataset):
    """(config, strategy, run_id) of a softmax family on ``dataset``."""
    if family == "ensemble":
        dirs = env.model("ensemble", ensemble_dirs)
        return env.config("ensemble", dirs[0], {
            "model_dir": dirs[1:], "test_at": "best"}, dataset), "ensemble"
    return env.config(family, env.model(family, deterministic_dir),
                      {"mc": 0}, dataset), "deterministic"


@pytest.mark.parametrize("dataset", ["folder", "flat"])
@pytest.mark.parametrize("family", ["deterministic", "ensemble"])
def test_softmax_family_matches_jax(env, tmp_path, family, dataset):
    config, strategy = family_config(env, family, dataset)
    jax_eces = run_jax(config, tmp_path / "jax", run_id=family,
                       strategy=strategy)
    port_eces = run_port(config, tmp_path / "port", parts=2, run_id=family,
                         strategy=strategy)
    assert jax_eces.keys() == port_eces.keys() == set(NAMES)
    csvs = assert_same_csvs(tmp_path / "jax", tmp_path / "port")
    bins = csvs[f"eval_calibration_{family}.csv"]
    assert sum(int(c) > 0 for c in bins[1][2:12]) >= 3  # spread over bins


def mean_fg(rows):
    """The run's mean fg probability over every pixel of every image, from
    a calibration CSV's bin counts and mean confidences (unmasked: every
    pixel is binned)."""
    head = rows[0]
    count = [head.index(f"bins_count_{b:02d}") for b in range(10)]
    conf = [head.index(f"bins_avg_confidence_{b:02d}") for b in range(10)]
    return sum(int(r[c]) * float(r[a]) for r in rows[1:]
               for c, a in zip(count, conf)) \
        / sum(int(r[c]) for r in rows[1:] for c in count)


@pytest.mark.parametrize("dataset", ["folder", "flat"])
def test_mc_matches_jax_distributionally(env, tmp_path, dataset):
    """The same file set and row keys as the JAX package's MC run, and at
    200 samples the run's mean MC fg within 0.02 of JAX's (the MC-mean
    bar), where the samples move it further than half that from the
    deterministic mean. Per-image ECE is no parity measure here: it moves
    by ~0.02 between two streams at this size."""
    config = env.config("mc", env.model("mc", mc_dir), {"mc": MC_SAMPLES},
                        dataset)
    run_jax(config, tmp_path / "jax", run_id="mc")
    run_port(config, tmp_path / "port", parts=2, run_id="mc")
    want, got = read_dir(tmp_path / "jax"), read_dir(tmp_path / "port")
    assert got.keys() == want.keys() and len(want) == 14
    for name, rows in want.items():
        keys = 1 if "minmax" in name else 2  # entry / (test_id, subject)
        assert [r[:keys] for r in got[name]] == [r[:keys] for r in rows], name
    want_fg = mean_fg(want["eval_calibration_mc.csv"])
    got_fg = mean_fg(got["eval_calibration_mc.csv"])
    run_port(config, tmp_path / "det", run_id="mc", mc=0)
    det_fg = mean_fg(read_dir(tmp_path / "det")["eval_calibration_mc.csv"])
    assert abs(got_fg - want_fg) <= MC_MEAN_ATOL, (got_fg, want_fg)
    assert abs(got_fg - det_fg) > MC_MEAN_ATOL / 2, (got_fg, det_fg)


@pytest.mark.parametrize("family,k", [("deterministic", K), ("ensemble", K),
                                      ("mc", 1)])
def test_image_path_equals_volume_path(env, tmp_path, family, k):
    """The images as native-2D subjects and as Z = 1 volumes give the same
    CSVs (tests/test_direct_2d.py's invariant); the MC stream of a
    one-image chunk is the volume's, so mc agrees at K = 1 too."""
    if family == "mc":
        model_dir = env.model("deterministic", deterministic_dir)
        others, strategy = {"mc": 3}, "mc"
    else:
        config, strategy = family_config(env, family, "flat")
        cfg = port_cfg.load(config)
        model_dir, others = cfg.model_dir, cfg.others
    flat = env.config(family, model_dir, others, "flat", batch_size=k)
    vol = env.config(family, model_dir, others, "vol", batch_size=1)
    run_port(flat, tmp_path / "flat", parts=-(-N_IMAGES // k),
             run_id=family, strategy=strategy)
    run_port(vol, tmp_path / "vol", parts=N_IMAGES, run_id=family,
             strategy=strategy)
    assert_same_csvs(tmp_path / "vol", tmp_path / "flat")


def test_deterministic_run_is_invariant_to_k(env, tmp_path):
    model_dir = env.model("deterministic", deterministic_dir)
    runs = {}
    for k in (1, 4, 6):
        config = env.config("det", model_dir, {"mc": 0}, batch_size=k)
        runs[k] = tmp_path / f"k{k}"
        run_port(config, runs[k], parts=-(-N_IMAGES // k), run_id="det")
    assert_same_csvs(runs[1], runs[4])
    assert_same_csvs(runs[1], runs[6])


def test_mc_stream_is_named_by_the_chunk_offset(env, tmp_path):
    """A chunk's MC stream is ``(seed, offset of its first image)``: the
    run's rows equal ``pipeline.evaluate`` called on each chunk alone
    with that name, and another K (other chunks at other offsets) samples
    another stream."""
    model_dir = env.model("deterministic", deterministic_dir)
    config = env.config("mc_stream", model_dir, {"mc": 3}, "flat",
                        batch_size=2)
    run_port(config, tmp_path / "run", parts=3, run_id="mc")
    model = port_direct.load_model(model_dir, "best", "cpu")
    arrays = list(env.arrays.values())
    rows = read_dir(tmp_path / "run")["eval_ece_mc.csv"]
    ece = rows[0].index("ece")
    for offset in (0, 2, 4):
        chunk = arrays[offset:offset + 2]
        images = torch.from_numpy(np.stack([a[0] for a in chunk]))
        targets = torch.from_numpy(np.stack([a[1] for a in chunk]) > 0)
        with eval_device.full_float32():
            out = pipeline.evaluate(
                "mc", model, {"images": images, "target": targets,
                              "mask": torch.ones_like(targets)}, 2,
                port_direct.DEFAULT_THRESHOLDS, mc=3, rng=(20, offset),
                per_image=True)
        for i in range(2):
            assert float(rows[1 + offset + i][ece]) == float(out["ece"][i])
    other = env.config("mc_stream", model_dir, {"mc": 3}, "flat",
                       batch_size=3)
    run_port(other, tmp_path / "k3", run_id="mc")
    assert read_dir(tmp_path / "k3") != read_dir(tmp_path / "run")


def test_mixed_size_chunk_matches_jax(tmp_path):
    """Image 1 and 4 are 24x16: the first chunk splits into three
    same-shape parts, the tail into two; the JAX driver pads them, the
    port runs each at its own length."""
    sizes = {NAMES[1]: (24, 16), NAMES[4]: (24, 16)}
    env = Env(tmp_path, sizes=sizes)
    inputs = [a[None] for a, _, _ in env.arrays.values()
              if a.shape[:2] == HW]
    model_dir = write_model(tmp_path / "unet", "unet", *unet_weights(inputs))
    config = env.config("mixed", model_dir, {"mc": 0})
    run_jax(config, tmp_path / "jax", run_id="mixed", mc=0)
    run_port(config, tmp_path / "port", parts=5, run_id="mixed", mc=0)
    want, got = read_dir(tmp_path / "jax"), read_dir(tmp_path / "port")
    assert got.keys() == want.keys()
    for name, rows in want.items():
        keys = 1 if "minmax" in name else 2  # entry / (test_id, subject)
        assert [r[:keys] for r in got[name]] == [r[:keys] for r in rows], name
    # the 16x20 images hold the margin: their rows are equal
    same = [n for n in NAMES if n not in sizes]
    for name, rows in want.items():
        if "minmax" in name:
            continue
        for want_row, got_row in zip(rows[1:], got[name][1:]):
            if want_row[1] in same:
                for col, a, b in zip(rows[0], got_row, want_row):
                    assert _cell_equal(a, b), (name, col, a, b)


def test_labels_with_a_channel_axis(env, tmp_path):
    """(H, W, 1) labels on a native-2D store drop to the gt channel by the
    dataset's rank, as the JAX driver's do; a rank-3 test (Z, H, W) would
    keep them and fail on the target's shape."""
    path = write_store(str(tmp_path / "axis.h5"), env.arrays,
                       label_axis=True)
    config = env.config("axis", env.model("deterministic",
                                          deterministic_dir),
                        {"mc": 0}, path)
    run_jax(config, tmp_path / "jax", run_id="axis")
    run_port(config, tmp_path / "port", parts=2, run_id="axis")
    assert_same_csvs(tmp_path / "jax", tmp_path / "port")
    target, _ = port_direct._split_labels(np.zeros(HW + (1,)), False,
                                          is_2d=True)
    assert target.shape == HW


def test_cli_runs_the_isic_config(env, tmp_path):
    """``-unmasked`` is the ISIC convention; the CLI needs no other flag."""
    config = env.config("cli", env.model("deterministic", deterministic_dir),
                        {"mc": 0})
    out_dir = str(tmp_path / "cli")
    port_cli.main(config, run_id="cli", out_dir=out_dir, unmasked=True,
                  device="cpu")
    rows = read_dir(out_dir)["eval_ece_cli.csv"]
    assert [r[1] for r in rows[1:]] == NAMES
    with pytest.raises(ValueError, match="raw t2"):
        port_cli.main(config, run_id="masked", out_dir=str(tmp_path / "m"),
                      device="cpu")

