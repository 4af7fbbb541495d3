"""The host side of the port's native-2D (ISIC) slice against the JAX
package's, on the CPU:

- the transforms (``data.transforms``) and ``build_transform`` on seeded
  arrays: the same arrays, dtypes and errors;
- the ISIC folder dataset (``data.isic``) on a PIL-written tree: the same
  subjects, shapes, arrays, superpixels, ×255 prediction merge, files and
  errors; ``build_dataset``/``build_data`` and their zero-subject guard;
- the eval reduction with an image axis: the plain version and the row
  arithmetic of K images equal to K single calls bit for bit, and each
  image's row equal to the JAX package's vmapped ``_entropy_eval`` /
  ``_confidence_eval`` (counts exact, bin means and ECE at rtol 1e-4,
  correction floats at rtol 1e-5);
- the driver's pieces: labels by the dataset's rank, the transform per
  slice on a volume store (CSVs equal to the JAX driver's), the native-2D
  int8 calibration (scales at rtol 1e-5 of the JAX package's), the
  read-ahead loop's order and bounds, and the one-copy fetch of a result
  tree.
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from rcu_tpu.data import h5 as jax_h5
from rcu_tpu.data import isic as jax_isic
from rcu_tpu.data import transforms as jax_tfm
from rcu_tpu.engine import databuild as jax_databuild
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval import direct as jax_direct
from rcu_tpu.eval import pipeline as jax_pipeline
from rcu_tpu.parallel.ensemble import stack_states
from rcu_tpu_torch.data import h5, isic, transforms
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.engine import databuild
from rcu_tpu_torch.eval import device as eval_device
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.eval import pipeline
from rcu_tpu_torch.ops.cuda import evalstats
from tests.test_torch_cuda import THRESHOLDS, make_subject
from tests.test_torch_direct import make_store
from tests.test_torch_direct_2d import (HW, NAMES, UNET3, assert_same_csvs,
                                        make_tree, raw_images, run_jax,
                                        run_port, unet_weights, write_config)
from tests.test_torch_evalstats import (assert_bins_close,
                                        assert_correction_close)
from tests.test_torch_strategies import write_model
from tests.test_torch_unet import flax_net

RNG = np.random.RandomState(5)
IMAGE = (RNG.rand(7, 9, 3) * 255).astype(np.uint8)
MASK = np.where(RNG.rand(7, 9) > 0.6, 255, 0).astype(np.uint8)
LABELS = RNG.randint(0, 4, (7, 9)).astype(np.uint8)
FLOATS = RNG.randn(7, 9, 4).astype(np.float32)


def sample():
    return {"images": IMAGE.copy(), "labels": MASK.copy()}


def both(name, *args, **kwargs):
    return (getattr(jax_tfm, name)(*args, **kwargs),
            getattr(transforms, name)(*args, **kwargs))


def assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ---------------------------------------------------------------- transforms

@pytest.mark.parametrize("name,args,kwargs,data", [
    ("Rescale", (), {}, None),
    ("Rescale", (0.0, 1.0), {"entries": ["images"]}, None),
    ("Rescale", (-1.0, 2.0), {"old_min": 10, "old_max": 200}, None),
    ("Relabel", ({2: 1, 3: 2},), {}, {"labels": LABELS}),
    ("Relabel", ({1: 3, 0: 1},), {"entries": ("labels", "extra")},
     {"labels": LABELS, "extra": LABELS[::-1]}),
    ("Size", ((4, 12),), {}, None),  # crop H, pad W with the odd pixel after
    ("Size", ((10, 9),), {"entries": ["images"]}, None),
    ("IntensityNormalization", (), {}, {"images": FLOATS}),
    ("IntensityNormalization", (), {}, {"images": np.zeros((3, 4, 2))}),
    ("ToBinary", (), {}, {"labels": LABELS}),
    ("ToBinary", (), {}, {"labels": LABELS > 1}),
    ("Permute", ((2, 0, 1),), {"entries": ["images"]}, None),
    ("Squeeze", (), {}, {"labels": LABELS[None, ..., None]}),
    ("UnSqueeze", (), {"axis": 0}, None),
])
def test_transform_is_jax_s(name, args, kwargs, data):
    want_t, got_t = both(name, *args, **kwargs)
    data = data or sample()
    want = want_t({k: v.copy() for k, v in data.items()})
    got = got_t({k: v.copy() for k, v in data.items()})
    assert_samples_equal(got, want)


def test_rescale_refuses_a_constant_array_as_jax_does():
    """An all-background ISIC mask has no range."""
    for module in (jax_tfm, transforms):
        with pytest.raises(ValueError, match="constant value"):
            module.Rescale()({"images": IMAGE,
                              "labels": np.zeros((7, 9), np.uint8)})


def test_compose_skips_none_and_chains():
    nodes = [(transforms.Size((5, 5)), jax_tfm.Size((5, 5))), (None, None),
             (transforms.Rescale(), jax_tfm.Rescale())]
    got = transforms.Compose([n[0] for n in nodes])(sample())
    want = jax_tfm.Compose([n[1] for n in nodes])(sample())
    assert_samples_equal(got, want)


@pytest.mark.parametrize("nodes", [
    None, [], ["squeeze", {"permute": {"permutation": [2, 0, 1]}},
               {"unsqueeze": {}}],
    [{"rescale": {"entries": ["images", "labels"], "lower": 0, "upper": 1}}],
    [{"size": {"size": [5, 12]}}, {"relabel": {"label_changes": {1: 255}}},
     {"rescale": {"old_min": 0, "old_max": 255}}, "permute"],
])
def test_build_transform_is_jax_s(nodes):
    want_t = jax_databuild.build_transform(
        jax_cfg.ParametricNode.parse_list(nodes))
    got_t = databuild.build_transform(port_cfg.ParametricNode.parse_list(nodes))
    assert (got_t is None) == (want_t is None)
    if got_t is not None:
        assert_samples_equal(got_t(sample()), want_t(sample()))


@pytest.mark.parametrize("name", sorted(
    n for n in os.listdir(os.path.join(os.path.dirname(__file__), "..",
                                       "config"))
    if n.startswith("test_isic_")))
def test_shipped_isic_configs_transform_as_jax(name):
    """Every config/test_isic_*.yaml loads, and its transform rescales the
    images and the {0, 255} masks as the JAX package's does."""
    path = os.path.join(os.path.dirname(__file__), "..", "config", name)
    want_t = jax_databuild.build_transform(
        jax_cfg.load(path, "test-config").test_data.transform)
    got_t = databuild.build_transform(port_cfg.load(path).test_data.transform)
    got = got_t(sample())
    assert_samples_equal(got, want_t(sample()))
    assert set(np.unique(got["labels"])) == {0.0, 1.0}


@pytest.mark.parametrize("node,message", [
    ({"rescale": {"lowr": 0}}, "unknown rescale params"),
    ({"size": {"entries": ["images"]}}, 'needs a "size" param'),
    ({"size": {"size": [4, 4], "pad": 1}}, "unknown size params"),
    ({"relabel": {}}, 'needs a "label_changes" param'),
    ({"relabel": {"label_changes": {1: 2}, "x": 1}}, "unknown relabel params"),
    ({"flip": {}}, 'unknown transform "flip"'),
])
def test_build_transform_refuses_as_jax_does(node, message):
    errors = []
    for cfg, build in ((jax_cfg, jax_databuild.build_transform),
                       (port_cfg, databuild.build_transform)):
        with pytest.raises(ValueError, match=message) as err:
            build(cfg.ParametricNode.parse_list([node]))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------------ folder dataset

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("isic_tree")
    raw = raw_images(sizes={NAMES[2]: (12, 18)})
    path, pred_dir = make_tree(tmp, raw)
    rng = np.random.RandomState(3)
    for name in NAMES:
        h, w = raw[name][0].shape[:2]
        Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(
            os.path.join(path + "_Data", f"{name}_superpixels.png"))
    return path, pred_dir


def datasets(path, **kwargs):
    return (jax_isic.IsicFolderDataset(path, **kwargs),
            isic.IsicFolderDataset(path, **kwargs))


@pytest.mark.parametrize("kwargs", [
    {}, {"with_superpixels": True}, {"prediction": True},
    {"subject_subset": NAMES[4:0:-2]}])
def test_folder_dataset_is_jax_s(tree, kwargs):
    path, pred_dir = tree
    if kwargs.pop("prediction", False):
        kwargs["prediction_dir"] = pred_dir
    want, got = datasets(path, **kwargs)
    assert got.subjects == want.subjects
    assert got.categories() == want.categories()
    for subject in want.subjects:
        assert got.files(subject) == want.files(subject)
        assert got.properties(subject).size == want.properties(subject).size
        for category in want.categories():
            assert got.shape(subject, category) == \
                want.shape(subject, category), category
            a = got.read_volume(subject, category)
            b = want.read_volume(subject, category)
            assert a.dtype == b.dtype and a.shape == b.shape, category
            np.testing.assert_array_equal(a, b, err_msg=category)
    if "prediction_dir" in kwargs:  # the x255 quirk
        labels = got.read_volume(NAMES[0], "labels")
        assert set(np.unique(labels[..., 1])) == {0, 255}
    got.close()


def test_folder_dataset_refuses_as_jax_does(tree, tmp_path):
    """An unknown subject, a missing ground truth, missing superpixels."""
    path, _ = tree
    raw = raw_images()
    no_gt, _ = make_tree(tmp_path / "no_gt", {n: raw[n] for n in NAMES[:2]})
    os.remove(os.path.join(no_gt + "_Part1_GroundTruth",
                           f"{NAMES[1]}_segmentation.png"))
    no_sp, _ = make_tree(tmp_path / "no_sp", {NAMES[0]: raw[NAMES[0]]})
    for module in (jax_isic, isic):
        with pytest.raises(ValueError, match="subjects not in dataset"):
            module.IsicFolderDataset(path, subject_subset=["ISIC_9999999"])
        with pytest.raises(ValueError, match="missing ground truth"):
            module.IsicFolderDataset(no_gt)
        with pytest.raises(ValueError, match="missing superpixels"):
            module.IsicFolderDataset(no_sp, with_superpixels=True)


def test_build_data_opens_the_store_or_the_tree(tree, tmp_path):
    path, pred_dir = tree
    config = port_cfg.DataConfiguration.from_dict(
        {"dataset": path, "with_superpixels": True})
    dataset = databuild.build_data(config, prediction_dir=pred_dir).dataset
    assert isinstance(dataset, isic.IsicFolderDataset)
    assert dataset.with_superpixels and dataset.prediction_dir == pred_dir
    store = make_store(tmp_path)
    dataset = databuild.build_data(
        port_cfg.DataConfiguration.from_dict({"dataset": store})).dataset
    assert isinstance(dataset, h5.SubjectDataset)
    dataset.close()
    messages = []
    for cfg, build in ((jax_cfg, jax_databuild.build_data),
                       (port_cfg, databuild.build_data)):
        with pytest.raises(ValueError, match="no subjects") as err:
            build(cfg.DataConfiguration.from_dict({"dataset": path}),
                  subjects=[])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# -------------------------------------------------- the eval's image axis

def image_planes(k, shape=(9, 13), nan=False):
    """K images' planes (fg, target, prediction, uncertainty, mask) with
    exact bin-edge and threshold values; ``nan``: a constant-confidence
    image, whose rescale gives NaN."""
    planes = [make_subject(20 + i, shape) for i in range(k)]
    fg, target, prediction, unc, mask = (np.stack(p) for p in zip(*planes))
    if nan:
        fg[1] = np.nan
        unc[1] = np.nan
    return fg, target, prediction, unc, mask


def as_torch(fg, target, prediction, unc, mask):
    u8 = lambda x: torch.from_numpy(x.astype(np.uint8))  # noqa: E731
    return (torch.from_numpy(fg), u8(target), u8(prediction),
            torch.from_numpy(unc), u8(mask))


@pytest.mark.parametrize("k,nan", [(1, False), (3, False), (4, True)])
def test_image_axis_equals_single_calls(k, nan):
    """The plain version and the row arithmetic of K images are K single
    calls bit for bit, in one call (one launch on a card)."""
    planes = as_torch(*image_planes(k, nan=nan))
    plain = evalstats.fused_eval_stats.plain_calls
    batched = evalstats.fused_subject_eval(*planes, THRESHOLDS,
                                           per_image=True)
    assert evalstats.fused_eval_stats.plain_calls == plain + 1
    for i in range(k):
        single = evalstats.fused_subject_eval(*(p[i] for p in planes),
                                              THRESHOLDS)
        for part_b, part_s in zip(batched, single):
            assert part_b.keys() == part_s.keys()
            for key, value in part_s.items():
                got = part_b[key][i]
                assert got.shape == value.shape and got.dtype == value.dtype
                assert torch.equal(got, value) or (
                    got.is_floating_point() and torch.equal(
                        got.isnan(), value.isnan()) and torch.equal(
                        got[~got.isnan()], value[~value.isnan()])), key
    stats = evalstats.fused_eval_stats_reference(*planes, THRESHOLDS,
                                                 per_image=True)
    assert stats["thresh_counts"].shape == (k, len(THRESHOLDS), 4)
    assert stats["bins_conf_sum"].dtype == torch.float64


def jax_rows(fn, *planes):
    th = jnp.asarray(THRESHOLDS, jnp.float32)
    return jax.vmap(lambda *p: fn(*p, th))(*(jnp.asarray(p) for p in planes))


def assert_row_is_jax_s(got, want, i):
    bins = {k: got[k][i] for k in ("bins_count", "bins_non_zero", "ece",
                                   "bins_avg_confidence",
                                   "bins_positive_fraction")}
    assert_bins_close(bins, {k: np.asarray(want[k])[i] for k in bins})
    assert_correction_close({k: v[i] for k, v in got["correction"].items()},
                            {k: np.asarray(v)[i]
                             for k, v in want["correction"].items()})
    for key in ("tp", "tn", "fp", "fn", "n"):
        assert int(got[key][i]) == int(np.asarray(want[key])[i]), key
    np.testing.assert_allclose(float(got["dice"][i]),
                               float(np.asarray(want["dice"])[i]), rtol=1e-5)
    if "conf_min" in want:
        # XLA's CPU min flushes a denormal to zero; torch keeps it
        for key in ("conf_min", "conf_max"):
            np.testing.assert_allclose(float(got[key][i]),
                                       float(np.asarray(want[key])[i]),
                                       rtol=0, atol=1e-37, err_msg=key)


def test_entropy_rows_are_jax_vmapped_s():
    fg, target, _, unc, mask = image_planes(3)
    got = pipeline._entropy_eval(torch.from_numpy(fg), torch.from_numpy(unc),
                                 torch.from_numpy(target),
                                 torch.from_numpy(mask), THRESHOLDS,
                                 per_image=True)
    want = jax_rows(jax_pipeline._entropy_eval, fg, unc,
                    target.astype(np.float32), mask.astype(np.float32))
    for i in range(3):
        assert_row_is_jax_s(got, want, i)


def test_confidence_rows_are_jax_vmapped_s():
    """Each image rescaled by its own confidence range, as the JAX program
    vmaps the subject rescale."""
    rng = np.random.RandomState(4)
    conf = np.stack([rng.rand(9, 13).astype(np.float32) * (i + 1) + i
                     for i in range(3)])
    _, target, prediction, _, mask = image_planes(3)
    got = pipeline._confidence_eval(
        torch.from_numpy(conf), torch.from_numpy(prediction.astype(np.uint8)),
        torch.from_numpy(target), torch.from_numpy(mask), THRESHOLDS,
        per_image=True)
    want = jax_rows(jax_pipeline._confidence_eval, conf,
                    prediction.astype(np.uint8), target.astype(np.float32),
                    mask.astype(np.float32))
    for i in range(3):
        assert_row_is_jax_s(got, want, i)


# ------------------------------------------------------------ the driver

@pytest.mark.parametrize("shape,is_2d,baseline,want", [
    ((4, 5), True, False, (4, 5)),
    ((4, 5, 1), True, False, (4, 5)),
    ((3, 4, 5), False, False, (3, 4, 5)),  # a slice axis is no channel axis
    ((3, 4, 5, 1), False, False, (3, 4, 5)),
    ((4, 5, 2), True, True, (4, 5)),
])
def test_labels_drop_their_channel_by_the_dataset_rank(shape, is_2d,
                                                       baseline, want):
    labels = np.ones(shape, np.uint8)
    target, base = port_direct._split_labels(labels, baseline, is_2d)
    assert target.shape == want and target.dtype == np.bool_
    assert (base is not None) == baseline


def test_volume_store_transform_runs_per_slice_as_jax(tmp_path):
    """A ``size`` transform (crop H, pad W) applied to each slice of a
    volume store: the CSVs are the JAX driver's."""
    store = make_store(tmp_path)
    unet = {**UNET3, "in_channels": 4}
    size = {"size": {"size": [12, 24]}}
    reader = jax_h5.SubjectDataset(store)
    crop = jax_tfm.Size((12, 24))
    inputs = [crop({"images": reader.read_volume(s, "images")[z]})["images"]
              [None] for s in reader.subjects for z in range(3)]
    reader.close()
    model_dir = write_model(tmp_path / "unet", "unet",
                            *unet_weights(inputs, unet))
    config = write_config(tmp_path / "size.yaml", model_dir, store, {"mc": 0},
                          batch_size=2, transform=[size])
    run_jax(config, tmp_path / "jax", run_id="size")
    run_port(config, tmp_path / "port", parts=4, run_id="size")
    assert_same_csvs(tmp_path / "jax", tmp_path / "port", n=4)


def test_native_2d_int8_calibration_is_jax_s(tree):
    """int8 on a native-2D dataset calibrates on its first K images through
    the transform (not on centre slices): the union scales of two members
    at rtol 1e-5 of the JAX package's. The JAX package raises on a rescale
    of the labels there (it rescales zero labels); the port reads the
    images alone and calibrates the same under the shipped ISIC rescale."""
    path, _ = tree
    members = [flax_net("unet", UNET3, HW, seed=40 + k) for k in range(2)]
    images_only = [{"rescale": {"entries": ["images"]}}]
    jax_transform = jax_databuild.build_transform(
        jax_cfg.ParametricNode.parse_list(images_only))
    state = (stack_states([p for _, p, _ in members]),
             stack_states([s for _, _, s in members]))
    want = jax_direct._calibrated_quant_model(
        members[0][0], state, jax_isic.IsicFolderDataset(path),
        jax_transform, True, 2, np.float32, 20, ensemble=True).quant_scales
    for nodes in (images_only, [{"rescale": {"entries": ["images",
                                                         "labels"]}}]):
        models = [port_direct.model_from_flax("unet", UNET3, p, s, "cpu")
                  for _, p, s in members]
        port_direct._calibrated_quant_model(
            models, isic.IsicFolderDataset(path), 2, 20, ensemble=True,
            transform=databuild.build_transform(
                port_cfg.ParametricNode.parse_list(nodes)))
        got = models[0].quant_scales
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-5), key


def test_drive_reads_ahead_and_fetches_in_order():
    """The read-ahead loop: at most ``window`` items read ahead of the
    dispatch, loads on the pool's thread, at most ``window`` items in
    flight, fetches in item order, each item's loaded data held until its
    fetch."""
    import concurrent.futures
    events, lock = [], threading.Lock()
    main = threading.get_ident()

    def load(i, item):
        assert threading.get_ident() != main
        with lock:
            events.append(("load", i))
        return {"item": item}

    def dispatch(i, item, loaded):
        assert loaded == {"item": item}
        with lock:
            events.append(("dispatch", i))
        return i

    def fetch(item, out, t0):
        with lock:
            events.append(("fetch", out))

    items = list("abcdefg")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port_direct._drive(pool, items, load, dispatch, fetch, window=2)
    order = [e for e in events if e[0] != "load"]
    assert [e[1] for e in order if e[0] == "fetch"] == list(range(7))
    for n, event in enumerate(order):
        if event[0] == "dispatch":
            done = sum(e[0] == "fetch" for e in order[:n])
            assert event[1] - done <= 2  # in flight before this one
            loaded = max(e[1] for e in events[:events.index(event)]
                         if e[0] == "load")
            assert loaded <= event[1] + 2  # read ahead at most 2 items
    assert sorted(e[1] for e in events if e[0] == "load") == list(range(7))


def test_fetch_returns_the_tree_in_one_buffer():
    tree = {"ece": torch.tensor(0.25, dtype=torch.float64),
            "bins_count": torch.arange(30).view(3, 10),
            "bins_non_zero": torch.tensor([[True, False]] * 3),
            "dice": torch.tensor([0.5, float("nan"), 1.0]),
            "correction": {"tp": torch.arange(3)[:, None].expand(3, 11),
                           "dice_benefit": torch.zeros(3, 11, dtype=torch.bool)},
            "row": torch.arange(40, dtype=torch.int64).view(4, 10)[:, 3]}
    got = eval_device.Fetch(tree).result()
    for path, leaf in eval_device._flatten(tree):
        value = got
        for key in path:
            value = value[key]
        assert isinstance(value, np.ndarray)
        assert value.dtype == leaf.numpy().dtype and value.shape == leaf.shape
        np.testing.assert_array_equal(value, leaf.numpy())
