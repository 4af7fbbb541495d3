"""The port's loader stack against the JAX package's on one H5 store:
``SliceBatchLoader`` batches for two epochs (uniform and chunked shuffle,
a ragged tail, a transform, patches), the selection strategies and their
index cache file, the assemblers, and the read-ahead feed."""
import json
import os

import numpy as np
import pytest
import torch

from rcu_tpu.data import assembler as jax_asm
from rcu_tpu.data import h5 as jax_h5
from rcu_tpu.data import indexing as jax_idx
from rcu_tpu.data import loader as jax_loader
from rcu_tpu.data import transforms as jax_tfm
from rcu_tpu.data.nifti import ImageProperties
from rcu_tpu_torch.data import assembler, h5, indexing, loader, transforms


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """3 subjects of 7 slices, 12x10, 2 channels; some slices all black."""
    path = str(tmp_path_factory.mktemp("loader") / "ds.h5")
    rng = np.random.RandomState(0)
    with jax_h5.DatasetWriter(path) as w:
        for i in range(3):
            images = rng.rand(7, 12, 10, 2).astype(np.float32)
            images[[0, 6 - i]] = 0.0
            labels = (rng.rand(7, 12, 10) < 0.2).astype(np.uint8)
            labels[1 + i] = 0
            w.add_subject(f"s{i}", {"images": images, "labels": labels},
                          props=ImageProperties(size=(10, 12, 7)))
    return path


def both(path, subjects=None):
    return (jax_h5.SubjectDataset(path, subject_subset=subjects),
            h5.SubjectDataset(path, subject_subset=subjects))


def assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for key in x:
            assert x[key].dtype == y[key].dtype, key
            assert np.array_equal(x[key], y[key]), key


@pytest.mark.parametrize("kwargs", [
    dict(batch_size=4, shuffle=True),
    dict(batch_size=5, shuffle=True, shuffle_chunk=3),
    dict(batch_size=8, shuffle=False),
    dict(batch_size=4, shuffle=True, num_workers=2),
    dict(batch_size=6, shuffle=True, drop_remainder=True),
])
def test_batches_equal_jax_for_two_epochs(store, kwargs):
    jd, pd = both(store)
    ji = jax_idx.all_indices(jd, jax_idx.SliceIndexing())
    pi = indexing.all_indices(pd, indexing.SliceIndexing())
    assert ji == pi
    jl = jax_loader.SliceBatchLoader(jd, ji, categories=("images", "labels"),
                                     seed=20, indexing=jax_idx.SliceIndexing(),
                                     **kwargs)
    pl = loader.SliceBatchLoader(pd, pi, categories=("images", "labels"),
                                 seed=20, indexing=indexing.SliceIndexing(),
                                 **kwargs)
    assert len(jl) == len(pl)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        assert_same_batches(list(jl), list(pl))
    assert pl.peek_item_shapes() == jl.peek_item_shapes()


def test_transform_and_patch_batches_equal_jax(store):
    jd, pd = both(store)
    kwargs = dict(entries=("images",), lower=-1, upper=1, old_min=0,
                  old_max=1)
    jt = jax_tfm.Compose([jax_tfm.Rescale(**kwargs)])
    pt = transforms.Compose([transforms.Rescale(**kwargs)])
    for jx, px, jtr, ptr in ((jax_idx.SliceIndexing(), indexing.SliceIndexing(),
                              jt, pt),
                             (jax_idx.PatchWiseIndexing((8, 6), pad=(1, 1)),
                              indexing.PatchWiseIndexing((8, 6), pad=(1, 1)),
                              None, None),
                             (jax_idx.EmptyIndexing(), indexing.EmptyIndexing(),
                              None, None)):
        ji, pi = jax_idx.all_indices(jd, jx), indexing.all_indices(pd, px)
        assert ji == pi and repr(jx) == repr(px)
        jl = jax_loader.SliceBatchLoader(jd, ji, 3, shuffle=True, seed=1,
                                         transform=jtr, indexing=jx)
        pl = loader.SliceBatchLoader(pd, pi, 3, shuffle=True, seed=1,
                                     transform=ptr, indexing=px)
        assert_same_batches(list(jl), list(pl))


def test_ragged_tail_repeats_the_last_item(store):
    _, pd = both(store)
    pi = indexing.all_indices(pd, indexing.SliceIndexing())
    batches = list(loader.SliceBatchLoader(pd, pi, 8,
                                           indexing=indexing.SliceIndexing()))
    tail = batches[-1]
    n = len(pi) % 8
    assert tail["valid"].tolist() == [1.0] * n + [0.0] * (8 - n)
    for key in ("images", "labels", "subject_index", "slice_index"):
        assert all(np.array_equal(tail[key][k], tail[key][n - 1])
                   for k in range(n, 8))


@pytest.mark.parametrize("make", [
    lambda m: m.NoneBlackSelection(),
    lambda m: m.WithForegroundSelection(),
    lambda m: m.ComposeSelection([m.NoneBlackSelection(),
                                  m.WithForegroundSelection()]),
])
def test_selection_and_index_cache_equal_jax(store, tmp_path, make):
    """The same kept indices, the same crc32 cache file and content: each
    package reads the other's cache."""
    jd, pd = both(store, ["s2", "s0"])
    cats = ("images", "labels")
    want = jax_idx.select_indices(jd, jax_idx.SliceIndexing(), make(jax_idx),
                                  cats)
    got = indexing.select_indices(pd, indexing.SliceIndexing(), make(indexing),
                                  cats)
    assert got == want and 0 < len(got) < 21
    cache = os.path.join(os.path.dirname(store), "indices")
    before = set(os.listdir(cache)) if os.path.isdir(cache) else set()
    got = indexing.calculate_or_load_indices(pd, indexing.SliceIndexing(),
                                             make(indexing), cats)
    written = set(os.listdir(cache)) - before
    assert len(written) == 1 and got == want
    with open(os.path.join(cache, written.pop())) as f:
        content = json.load(f)
    assert content == {"indices": [list(i) for i in want]}
    # JAX finds the port's file (same key, no new file) and reads it
    assert jax_idx.calculate_or_load_indices(
        jd, jax_idx.SliceIndexing(), make(jax_idx), cats) == want
    assert len(set(os.listdir(cache)) - before) == 1


@pytest.mark.parametrize("kind", ["subject", "patch", "2d"])
def test_assemblers_equal_jax(store, kind):
    jd, pd = both(store)
    if kind == "patch":
        jx, px = jax_idx.PatchWiseIndexing((5, 4)), indexing.PatchWiseIndexing((5, 4))
        make = (lambda d: jax_asm.PatchAssembler(d, jx, ("p",)),
                lambda d: assembler.PatchAssembler(d, px, ("p",)))
    elif kind == "subject":
        jx, px = jax_idx.SliceIndexing(), indexing.SliceIndexing()
        make = (lambda d: jax_asm.SubjectAssembler(d, ("p",)),
                lambda d: assembler.SubjectAssembler(d, ("p",)))
    else:
        jx, px = jax_idx.EmptyIndexing(), indexing.EmptyIndexing()
        make = (lambda d: jax_asm.Subject2dAssembler(d, ("p",)),
                lambda d: assembler.Subject2dAssembler(d, ("p",)))
    ji = jax_idx.all_indices(jd, jx)
    ja, pa = make[0](jd), make[1](pd)
    rng = np.random.RandomState(2)
    order = rng.permutation(len(ji))
    done = ([], [])
    for start in range(0, len(order), 4):
        chunk = list(order[start:start + 4])
        valid = np.float32([1] * len(chunk) + [0] * (4 - len(chunk)))
        chunk += [chunk[-1]] * (4 - len(chunk))
        subj = np.int32([ji[i][0] for i in chunk])
        code = np.int32([ji[i][1] for i in chunk])
        out = {"p": rng.rand(4, *((5, 4) if kind == "patch" else
                                 (12, 10) if kind == "subject" else
                                 (7, 12, 10)), 2).astype(np.float32)}
        for asm, sink in zip((ja, pa), done):
            asm.add_batch(out, subj, code, valid)
            for s in asm.subjects_ready():
                sink.append((s, asm.get_assembled_subject(s)["p"]))
    assert [s for s, _ in done[0]] == [s for s, _ in done[1]]
    for (_, a), (_, b) in zip(*done):
        assert np.array_equal(a, b)
    assert ja.flush() == pa.flush()


def test_prefetch_yields_the_batches_and_raises_the_readers_error(store):
    _, pd = both(store)
    pi = indexing.all_indices(pd, indexing.SliceIndexing())
    pl = loader.SliceBatchLoader(pd, pi, 4, shuffle=True, seed=3,
                                 indexing=indexing.SliceIndexing())
    want = list(pl)
    got = list(loader.prefetch(iter(pl), "cpu"))
    assert len(got) == len(want)
    for x, y in zip(want, got):
        for key in x:
            assert isinstance(y[key], torch.Tensor)
            assert np.array_equal(x[key], y[key].numpy())

    def failing():
        yield want[0]
        raise OSError("read failed")

    feed = loader.prefetch(failing(), "cpu")
    next(feed)
    with pytest.raises(OSError, match="read failed"):
        next(feed)
    early = loader.prefetch(iter(pl), "cpu", size=1)
    next(early)
    early.close()  # leaving early stops and joins the reader


def test_loader_refuses_shards(store):
    """A shard outside ``0 <= id < n`` and a chunked shard with fewer full
    chunks than hosts raise JAX's ValueErrors, word for word (the shard
    orders themselves: ``tests/test_torch_parallel_train.py``)."""
    jd, pd = both(store)
    for bad in ((2, 2), (-1, 2)):
        with pytest.raises(ValueError) as want:
            jax_loader.SliceBatchLoader(jd, [], 4, shard=bad)
        with pytest.raises(ValueError) as got:
            loader.SliceBatchLoader(pd, [], 4, shard=bad)
        assert str(got.value) == str(want.value)
    indices = indexing.all_indices(pd, indexing.SliceIndexing())
    ji = jax_idx.all_indices(jd, jax_idx.SliceIndexing())
    kwargs = dict(batch_size=4, shuffle=True, shuffle_chunk=8, shard=(1, 3))
    with pytest.raises(ValueError) as want:
        len(jax_loader.SliceBatchLoader(jd, ji, **kwargs))
    with pytest.raises(ValueError) as got:
        len(loader.SliceBatchLoader(pd, indices, **kwargs))
    assert "needs at least 3 full chunks" in str(got.value)
    assert str(got.value) == str(want.value)
