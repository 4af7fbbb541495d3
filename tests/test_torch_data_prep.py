"""Data preparation without jax: the port's ``data.h5.DatasetWriter``,
``data.split`` and the four data CLIs against the JAX package's writer and
``scripts/``, on seeded raw trees: the H5 stores equal dataset by dataset
(dtype, shape, chunks, values) and attribute by attribute, the split JSONs
byte for byte for every split type, the resized PNG and JPEG files byte
for byte, and the same ``ValueError``s. A store whose writer block raised
has no ``subjects`` index, so it does not open."""
import importlib.util
import json
import os
import random

import h5py
import numpy as np
import pytest
from PIL import Image

from rcu_tpu.data import h5 as jax_h5
from rcu_tpu.data import split as jax_split
from rcu_tpu_torch.cli import (create_brats18_dataset, create_brats18_split,
                               create_isic_subtrain_split, prepare_isic_data)
from rcu_tpu_torch.data import h5, nifti, split

SCRIPTS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts")


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(SCRIPTS_DIR, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same_h5(a_path, b_path):
    """Every group, dataset (dtype, shape, chunks, values) and attribute of
    two stores equal."""
    with h5py.File(a_path, "r") as a, h5py.File(b_path, "r") as b:
        names_a, names_b = [], []
        a.visit(names_a.append)
        b.visit(names_b.append)
        assert names_a == names_b
        for name in [""] + names_a:
            x, y = (a[name], b[name]) if name else (a, b)
            assert type(x) is type(y), name
            assert sorted(x.attrs) == sorted(y.attrs), name
            for key in x.attrs:
                u, v = x.attrs[key], y.attrs[key]
                assert type(u) is type(v), (name, key)
                assert np.array_equal(np.asarray(u), np.asarray(v)), (name, key)
            if isinstance(x, h5py.Dataset):
                assert (x.dtype, x.shape, x.chunks) == \
                    (y.dtype, y.shape, y.chunks), name
                assert np.array_equal(x[()], y[()]), name


@pytest.fixture(scope="module")
def brats_tree(tmp_path_factory):
    """10 BraTS-layout subjects (7 HGG, 3 LGG) of seeded 3x6x6 volumes
    written with the port's ``nifti.write``, and a prediction run."""
    tmp = tmp_path_factory.mktemp("brats_raw")
    rng = np.random.RandomState(1)
    subjects = []
    preds = tmp / "preds"
    preds.mkdir()
    for i in range(10):
        grade = "HGG" if i < 7 else "LGG"
        s = f"Brats18_TST_{i:02d}_1"
        d = tmp / grade / s
        d.mkdir(parents=True)
        props = nifti.ImageProperties(size=(6, 6, 3), spacing=(1.0, 1.5, 2.0),
                                      origin=(float(i), -2.0, 3.5))
        for e in ("flair", "t1", "t1ce", "t2"):
            nifti.write((rng.rand(3, 6, 6) * 100).astype(np.float32),
                        str(d / f"{s}_{e}.nii.gz"), props)
        nifti.write((rng.rand(3, 6, 6) < 0.3).astype(np.uint8) * 4,
                    str(d / f"{s}_seg.nii.gz"), props)
        nifti.write((rng.rand(3, 6, 6) < 0.5).astype(np.uint8),
                    str(preds / f"{s}_prediction.nii.gz"), props)
        subjects.append(s)
    return tmp, subjects


def write_store(writer_cls, path, tree, subjects):
    with writer_cls(path) as writer:
        for s in subjects:
            grade = "HGG" if os.path.isdir(tree / "HGG" / s) else "LGG"
            image, props = nifti.read(str(tree / grade / s / f"{s}_t1.nii.gz"))
            writer.add_subject(
                s, {"images": image[..., None].astype(np.float32),
                    "labels": (image > 50).astype(np.uint8),
                    "flat": np.arange(4, dtype=np.int64)},
                props=props, meta={"grade": grade, "index": 3},
                files={"images": {"t1": f"{s}_t1.nii.gz"}})


def test_writer_equals_jax_writer(brats_tree, tmp_path):
    tree, subjects = brats_tree
    write_store(jax_h5.DatasetWriter, str(tmp_path / "jax.h5"), tree,
                subjects[:4])
    write_store(h5.DatasetWriter, str(tmp_path / "port" / "port.h5"), tree,
                subjects[:4])
    assert_same_h5(str(tmp_path / "jax.h5"), str(tmp_path / "port" / "port.h5"))
    store = h5.SubjectDataset(str(tmp_path / "port" / "port.h5"))
    assert store.subjects == subjects[:4]
    assert store.meta(subjects[0])["grade"] == "HGG"
    assert store.files(subjects[0]) == {"images": {"t1": f"{subjects[0]}"
                                                   "_t1.nii.gz"}}
    assert store.properties(subjects[1]).origin == (1.0, -2.0, 3.5)
    store.close()


def test_writer_close_is_idempotent(tmp_path):
    path = str(tmp_path / "s.h5")
    writer = h5.DatasetWriter(path)
    writer.add_subject("a", {"images": np.zeros((2, 3, 3), np.float32)})
    writer.close()
    writer.close()
    assert h5.SubjectDataset(path).subjects == ["a"]


def test_store_of_a_failed_block_does_not_open(tmp_path):
    path = str(tmp_path / "partial.h5")
    with pytest.raises(RuntimeError, match="reader died"):
        with h5.DatasetWriter(path) as writer:
            writer.add_subject("a", {"images": np.zeros((2, 3, 3),
                                                        np.float32)})
            raise RuntimeError("reader died")
    with h5py.File(path, "r") as f:
        assert "subjects" not in f and "data/a/images" in f
    with pytest.raises(KeyError):
        h5.SubjectDataset(path)


@pytest.mark.parametrize("is_train,with_pred", [(True, False), (False, False),
                                                (True, True), (False, True)])
def test_brats_dataset_equals_script(brats_tree, tmp_path, is_train,
                                     with_pred):
    tree, subjects = brats_tree
    split_file = str(tmp_path / "split.json")
    split.save_split(split_file, subjects[:6], subjects[6:8], subjects[8:])
    preds = str(tree / "preds") if with_pred else None
    load_script("create_brats18_dataset").build_brats_dataset(
        str(tree), str(tmp_path / "jax.h5"), split_file, is_train, preds)
    create_brats18_dataset.build_brats_dataset(
        str(tree), str(tmp_path / "port.h5"), split_file, is_train, preds)
    assert_same_h5(str(tmp_path / "jax.h5"), str(tmp_path / "port.h5"))
    store = h5.SubjectDataset(str(tmp_path / "port.h5"))
    assert store.subjects == (subjects[:8] if is_train else subjects[8:])
    assert store.shape(store.subjects[0], "labels") == \
        ((3, 6, 6, 2) if with_pred else (3, 6, 6))
    store.close()


def test_brats_dataset_main_paths_and_errors(brats_tree, tmp_path,
                                             monkeypatch):
    tree, subjects = brats_tree
    split_file = str(tmp_path / "split.json")
    split.save_split(split_file, ["NotThere"], [], [])
    jax_script = load_script("create_brats18_dataset")
    for build in (jax_script.build_brats_dataset,
                  create_brats18_dataset.build_brats_dataset):
        with pytest.raises(ValueError, match=r"subjects in split but not on "
                                             r"disk: \['NotThere'\]"):
            build(str(tree), str(tmp_path / "x.h5"), split_file, True)
    for main in (jax_script.main, create_brats18_dataset.main):
        with pytest.raises(ValueError, match='invalid creation type "val"'):
            main("val")
    from rcu_tpu_torch import directories as dirs
    split.save_split(split_file, subjects[:2], subjects[2:3], subjects[3:4])
    monkeypatch.setattr(dirs, "DATASET_DIR", str(tmp_path / "datasets"))
    create_brats18_dataset.main("test", str(tree), split_file)
    assert os.listdir(tmp_path / "datasets") == \
        ["brats18_test_reduced_norm.h5"]


@pytest.fixture(scope="module")
def brats_names_tree(tmp_path_factory):
    """140 subjects in the BraTS layout, enough for the 100/25/rest split
    (the split CLIs read names and grades; the files may be empty)."""
    tmp = tmp_path_factory.mktemp("brats_names")
    rng = np.random.RandomState(7)
    for i in range(140):
        grade = "HGG" if rng.rand() < 0.75 else "LGG"
        s = f"Brats18_{grade}_{i:03d}_1"
        d = tmp / grade / s
        d.mkdir(parents=True)
        for e in ("flair", "t1", "t1ce", "t2", "seg"):
            (d / f"{s}_{e}.nii.gz").touch()
    return tmp


def assert_same_files(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for name in names:
        with open(os.path.join(a_dir, name), "rb") as a, \
                open(os.path.join(b_dir, name), "rb") as b:
            assert a.read() == b.read(), name
    return names


@pytest.mark.parametrize("split_type", ["default", "ensemble", "k-fold",
                                        "resplit-train"])
def test_brats_splits_equal_script(brats_names_tree, tmp_path, split_type):
    load_script("create_brats18_split").main(
        split_type, str(brats_names_tree), str(tmp_path / "jax"))
    create_brats18_split.main(split_type, str(brats_names_tree),
                              str(tmp_path / "port"))
    names = assert_same_files(tmp_path / "jax", tmp_path / "port")
    assert len(names) == 1
    train, valid, test = split.load_split(str(tmp_path / "port" / names[0]),
                                          0 if split_type in (
                                              "ensemble", "k-fold") else None)
    assert train and valid and test and not set(train) & set(valid)


@pytest.mark.parametrize("split_type", ["ensemble", "k-fold",
                                        "resplit-train"])
def test_isic_splits_equal_script(tmp_path, split_type):
    data = tmp_path / "ISIC-2017_Training_Data"
    gt = tmp_path / "ISIC-2017_Training_Part1_GroundTruth"
    data.mkdir()
    gt.mkdir()
    for i in range(30):
        s = f"ISIC_{i:07d}"
        for path in (data / f"{s}.jpg", data / f"{s}_superpixels.png",
                     gt / f"{s}_segmentation.png"):
            path.touch()
    state = random.getstate()
    load_script("create_isic_subtrain_split").main(
        split_type, str(tmp_path / "ISIC-2017_Training"), str(tmp_path / "jax"))
    create_isic_subtrain_split.main(
        split_type, str(tmp_path / "ISIC-2017_Training"),
        str(tmp_path / "port"))
    assert random.getstate() == state  # its own stream
    assert_same_files(tmp_path / "jax", tmp_path / "port")


def test_split_type_errors(tmp_path):
    for main in (load_script("create_brats18_split").main,
                 create_brats18_split.main):
        with pytest.raises(ValueError, match='invalid split type "x"'):
            main("x", str(tmp_path), str(tmp_path))
    for main in (load_script("create_isic_subtrain_split").main,
                 create_isic_subtrain_split.main):
        with pytest.raises(ValueError, match='invalid split type "x"'):
            main("x", str(tmp_path), str(tmp_path))


@pytest.mark.parametrize("fn,args", [
    ("split_subjects", ([f"s{i}" for i in range(10)], (6, 2, 2))),
    ("split_subjects", ([f"s{i}" for i in range(11)], (0.5, 0.3, 0.2))),
    ("split_subjects", ([f"s{i}" for i in range(11)], (0.5, 0.5))),
    ("split_subjects_k_fold", ([f"s{i}" for i in range(10)], 5)),
    ("split_subject_k_fold_stratified",
     ([f"s{i}" for i in range(12)], [0, 1] * 6, 3)),
    ("create_stratified_shuffled_split",
     ([f"s{i}" for i in range(20)], [0] * 14 + [1] * 6, (12, 4, 4))),
    ("create_stratified_shuffled_split",
     ([f"s{i}" for i in range(20)], [0] * 14 + [1] * 6, (14, 6))),
])
def test_split_functions_equal_jax(fn, args):
    assert getattr(split, fn)(*args) == getattr(jax_split, fn)(*args)


@pytest.mark.parametrize("fn,args,message", [
    ("split_subjects", (["a", "b"], (1, 2)), "must cover all 2 subjects"),
    ("split_subjects", (["a", "b"], (0.5, 0.6)), "must total 1.0"),
    ("split_subjects", (["a", "b"], (1, 0.5)), "all-int or all-float"),
    ("split_subjects_k_fold", (["a", "b", "c"], 2), "divisible by k"),
])
def test_split_errors_word_for_word(fn, args, message):
    with pytest.raises(ValueError) as port:
        getattr(split, fn)(*args)
    with pytest.raises(ValueError) as jax:
        getattr(jax_split, fn)(*args)
    assert message in str(port.value) and str(port.value) == str(jax.value)


def test_save_split_bytes_and_folds(tmp_path):
    args = ([["a", "b"], ["c"]], [["d"], ["e"]], None)
    jax_split.save_split(str(tmp_path / "jax.json"), *args)
    split.save_split(str(tmp_path / "port.json"), *args)
    assert (tmp_path / "jax.json").read_bytes() == \
        (tmp_path / "port.json").read_bytes()
    assert split.load_split(str(tmp_path / "port.json"), 1) == \
        jax_split.load_split(str(tmp_path / "jax.json"), 1) == (["c"], ["e"],
                                                                [])
    assert split.SubjectSplit.load(str(tmp_path / "port.json")) == \
        split.SubjectSplit(*args)


def test_isic_resize_equals_script(tmp_path):
    raw = tmp_path / "raw"
    (raw / "ISIC-2017_Training_Data").mkdir(parents=True)
    (raw / "ISIC-2017_Training_Part1_GroundTruth").mkdir()
    rng = np.random.RandomState(3)
    for i in range(3):
        s = f"ISIC_{i:07d}"
        Image.fromarray((rng.rand(60, 80, 3) * 255).astype(np.uint8)).save(
            raw / "ISIC-2017_Training_Data" / f"{s}.jpg")
        Image.fromarray(((rng.rand(60, 80) > 0.5) * 255).astype(np.uint8)) \
            .save(raw / "ISIC-2017_Training_Part1_GroundTruth"
                  / f"{s}_segmentation.png")
        if i < 2:  # a subject without superpixels is skipped for them
            Image.fromarray((rng.rand(60, 80) * 255).astype(np.uint8)).save(
                raw / "ISIC-2017_Training_Data" / f"{s}_superpixels.png")
    task = str(raw / "ISIC-2017_Training")
    script = load_script("prepare_isic_data")
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    # both collect with superpixels, which the third subject lacks: both
    # refuse alike; with them all present both write the same bytes
    for process in (script.process_data, prepare_isic_data.process_data):
        with pytest.raises(ValueError, match="missing superpixels"):
            process(str(tmp_path / "x"), task)
    Image.fromarray((rng.rand(60, 80) * 255).astype(np.uint8)).save(
        raw / "ISIC-2017_Training_Data" / "ISIC_0000002_superpixels.png")
    script.process_data(str(tmp_path / "jax"), task)
    prepare_isic_data.process_data(str(tmp_path / "port"), task)
    for sub in ("ISIC-2017_Training_Data",
                "ISIC-2017_Training_Part1_GroundTruth"):
        names = assert_same_files(tmp_path / "jax" / sub,
                                  tmp_path / "port" / sub)
        for name in names:
            image = Image.open(tmp_path / "port" / sub / name)
            assert image.size == (256, 192)
    gt = np.asarray(Image.open(tmp_path / "port"
                               / "ISIC-2017_Training_Part1_GroundTruth"
                               / "ISIC_0000000_segmentation.png"))
    assert set(np.unique(gt)) <= {0, 255}  # nearest keeps the mask binary


def test_cli_entry_points_run_as_modules(brats_names_tree, tmp_path):
    """``python -m rcu_tpu_torch.cli.create_brats18_split`` with the
    scripts' flags."""
    import subprocess
    import sys
    repo = os.path.dirname(SCRIPTS_DIR)
    out = subprocess.run(
        [sys.executable, "-m", "rcu_tpu_torch.cli.create_brats18_split",
         "--type", "default", "--data_dir", str(brats_names_tree),
         "--out_dir", str(tmp_path)], cwd=repo, capture_output=True,
        text=True, check=True)
    assert "split type: default" in out.stdout
    names = os.listdir(tmp_path)
    assert names == ["split_brats18_100-25-15.json"]
    with open(tmp_path / names[0]) as f:
        assert list(json.load(f)) == ["train", "valid", "test"]
