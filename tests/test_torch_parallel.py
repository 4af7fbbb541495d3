"""The port's mesh layer (``rcu_tpu_torch.parallel``) on a virtual CPU mesh
(``make_mesh(n_devices=N, device="cpu")``: N entries of the CPU, each with
its split, its launch and its part of the cross-device add), against the
port's own single-device results and against ``rcu_tpu.parallel`` on the
JAX tests' virtual CPU devices.

- ``make_mesh`` refuses a mesh it cannot give; ``pad_batch_size_to_mesh``
  rounds to the data axis only; the splits are ``torch.tensor_split``'s.
- ``ShardedSubjectEval``: counts exact against one call over the whole
  subject on 1-, 2- and 3-entry meshes with a ragged voxel count, float64
  sums within 1e-12 relative, and JAX's sharded eval at the bar of
  ``tests/test_parallel.py``.
- A split MC batch draws the whole batch's masks, bitwise.
- The EP ensemble predict against JAX's ``shard_ensemble_predict_fn`` at
  rtol 1e-4, atol 2e-5 (``tests/test_parallel.py``'s bar).
"""
import threading

import jax
import numpy as np
import pytest
import torch

from rcu_tpu.parallel import ensemble as jax_ens
from rcu_tpu.parallel import mesh as jax_mesh
from rcu_tpu.parallel.inference import ShardedSubjectEval as JaxSharded
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.eval import device as eval_device
from rcu_tpu_torch.eval import kernels
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.models.unet import ChannelDropout
from rcu_tpu_torch.ops.cuda import evalstats
from rcu_tpu_torch.parallel import (Mesh, Sharded, Split, make_mesh,
                                    pad_batch_size_to_mesh, replicate,
                                    split_batch)
from rcu_tpu_torch.parallel.ensemble import (make_ensemble_mesh,
                                             shard_ensemble_predict_fn,
                                             shard_members)
from rcu_tpu_torch.parallel.inference import ShardedSubjectEval
from rcu_tpu_torch.parallel.mesh import split_bounds
from tests.test_torch_unet import flax_unet

PARAMS = dict(nb_classes=2, in_channels=2, depth=2, start_filters=4,
              dropout=0.2)
COUNT_KEYS = ("bins_count", "tp", "tn", "fp", "fn", "n", "tpu", "tnu", "fpu",
              "fnu")


def cpu_mesh(n):
    return make_mesh(n_devices=n, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread for these many small CPU ops: beside the other
    test workers, each worker's full-width thread pool oversubscribes the
    cores and runs them tens of times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ the mesh

def test_make_mesh_refuses_what_it_cannot_give(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2-device mesh but only 1 cuda"):
        make_mesh(n_devices=2)
    with pytest.raises(ValueError, match="cuda:1 does not exist"):
        make_mesh(devices=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="3-device mesh but only 2"):
        make_mesh(devices=["cuda:0"] * 2, n_devices=3)
    virtual = make_mesh(devices=["cuda:0"] * 2)
    assert virtual.devices == (torch.device("cuda", 0),) * 2
    assert virtual.shape == {"data": 2}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="only 0 cuda"):
        make_mesh()
    with pytest.raises(ValueError, match="cuda or cpu"):
        make_mesh(n_devices=2, device="meta")


def test_cpu_mesh_and_the_data_axis():
    mesh = cpu_mesh(3)
    assert mesh.devices == (torch.device("cpu"),) * 3
    assert mesh.data_devices == mesh.devices
    assert [pad_batch_size_to_mesh(b, mesh) for b in (1, 3, 4, 32)] == \
        [3, 3, 6, 33]
    ep = make_ensemble_mesh(2, ["cpu"] * 6)
    assert ep.shape == {"model": 2, "data": 3} and len(ep.rows()) == 2
    # the model axis does not split a batch (JAX's rule)
    assert pad_batch_size_to_mesh(4, ep) == 6
    with pytest.raises(ValueError, match="not divisible by 4"):
        make_ensemble_mesh(4, ["cpu"] * 6)
    with pytest.raises(ValueError, match="does not hold"):
        Mesh(["cpu"] * 3, ("model", "data"), (2, 2))


@pytest.mark.parametrize("n,parts", [(7, 3), (2, 3), (32, 2), (27, 2)])
def test_splits_are_tensor_split_s(n, parts):
    x = torch.arange(n)
    want = [t.tolist() for t in torch.tensor_split(x, parts)]
    assert [x[a:b].tolist() for a, b in split_bounds(n, parts)] == want
    got = split_batch({"images": x, "valid": x * 2}, cpu_mesh(parts))
    assert [g["images"].tolist() for g in got] == want
    assert [g["valid"].tolist() for g in got] == [[2 * v for v in w]
                                                   for w in want]


def test_split_of_a_volume_and_its_join():
    """A 7-row volume at batch 4 on 2 devices: batch 0 rows 0-1 | 2-3,
    batch 1 rows 4-5 | 6; each device's ranges merged; ``Sharded`` joins
    the parts in row order."""
    split = Split(7, 4, ("cpu", "cpu"))
    assert [parts for _, _, parts in split.batches] == \
        [[(0, 2), (2, 4)], [(4, 6), (6, 7)]]
    assert split.ranges == [((0, 2), (4, 6)), ((2, 4), (6, 7))]
    x = torch.arange(7 * 3).reshape(7, 3)
    shards = split.shards(x)
    assert shards[0].tolist() == x[[0, 1, 4, 5]].tolist()
    joined = split.joined(shards)
    assert isinstance(joined, Sharded)
    host = eval_device.Fetch({"a": {"map": joined}, "n": torch.tensor(3)})
    out = host.result()
    np.testing.assert_array_equal(out["a"]["map"], x.numpy())
    assert int(out["n"]) == 3
    one = Split(7, 4, ("cpu",))
    assert one.ranges == [((0, 7),)] and one.joined([x]) is x
    assert split.shards(None) == [None, None]


def test_replicate_shares_a_repeated_device():
    model = get_model("unet", PARAMS)
    copies = replicate(model, ["cpu"] * 3)
    assert all(c is model for c in copies) and not model.training


# ------------------------------------------------------- ShardedSubjectEval

def subject_arrays(seed=3, vol=(5, 9, 9)):
    """405 voxels: ragged over 2 and 3 devices (and JAX's 2)."""
    rng = np.random.RandomState(seed)
    fg = rng.rand(*vol).astype(np.float32)
    fg.flat[:4] = (0.1, 0.5, 0.9, 0.3)  # exact bin edges
    return {"probabilities": np.stack([1 - fg, fg], -1),
            "target": (rng.rand(*vol) > 0.6).astype(np.uint8),
            "prediction": (fg > 0.5).astype(np.uint8),
            "uncertainty": rng.rand(*vol).astype(np.float32),
            "mask": rng.rand(*vol) > 0.2, "fg": fg}


def assert_sums(got, want, rtol=1e-12):
    for key, value in want.items():
        if isinstance(value, dict):
            assert_sums(got[key], value, rtol)
            continue
        g, w = np.asarray(got[key]), np.asarray(value)
        if key in COUNT_KEYS or w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=key)


def port_calls(suite, a, thresholds):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return {
        "ece": suite.ece_dice_confusion(t["probabilities"], t["target"],
                                        t["prediction"], t["mask"]),
        "calib": suite.calibration_bins(t["probabilities"], t["target"],
                                        t["prediction"], None),
        "corr": suite.correction_eval(t["prediction"], t["target"],
                                      t["uncertainty"], thresholds),
        "minmax": suite.min_max(t["fg"])}


@pytest.mark.parametrize("n", [1, 2, 3])
def test_sharded_eval_is_one_call_over_the_subject(n):
    a = subject_arrays()
    thresholds = (0.05, 0.5, 0.95, 0.3)
    launches = evalstats.fused_eval_stats.plain_calls
    got = port_calls(ShardedSubjectEval(cpu_mesh(n)), a, thresholds)
    # one launch a device and call (min_max launches nothing)
    assert evalstats.fused_eval_stats.plain_calls - launches == 3 * n
    want = port_calls(kernels, a, thresholds)
    assert_sums(got, want)


def test_sharded_eval_matches_jax_s():
    """JAX pads to the mesh with weight 0; the port splits unequally: the
    same results at ``tests/test_parallel.py``'s bar."""
    a = subject_arrays()
    thresholds = np.asarray([0.05, 0.5, 0.95], np.float32)
    got = port_calls(ShardedSubjectEval(cpu_mesh(2)), a, tuple(thresholds))
    sh = JaxSharded(jax_mesh.make_mesh(n_devices=2))
    want = {
        "ece": sh.ece_dice_confusion(a["probabilities"], a["target"],
                                     a["prediction"], a["mask"]),
        "calib": sh.calibration_bins(a["probabilities"], a["target"],
                                     a["prediction"], None),
        "corr": sh.correction_eval(a["prediction"], a["target"],
                                   a["uncertainty"], thresholds),
        "minmax": sh.min_max(a["fg"])}
    for name, ref in want.items():
        for key, value in ref.items():
            np.testing.assert_allclose(np.asarray(got[name][key], np.float64),
                                       np.asarray(value, np.float64),
                                       rtol=1e-5, err_msg=f"{name} {key}")


def test_fewer_voxels_than_devices():
    a = subject_arrays(vol=(1, 1, 2))
    got = port_calls(ShardedSubjectEval(cpu_mesh(3)), a, (0.5,))
    assert_sums(got, port_calls(kernels, a, (0.5,)))


# ------------------------------------------------------------- MC on a split

def test_a_split_batch_draws_the_whole_batch_s_masks():
    """Each part's channel masks are the rows of the whole batch's: the
    part draws the whole (total, C) and keeps its rows."""
    drop = ChannelDropout(0.5)
    x = torch.ones(2 * 6, 8, 3, 3)  # T=2 samples of a 6-row batch
    whole = drop(x.clone(), steps.batch_generators((4, 1), 2, "cpu"))
    for a, b in split_bounds(6, 4):
        part = torch.cat([x[:b - a], x[:b - a]]).clone()
        got = drop(part, steps.batch_generators((4, 1), 2, "cpu", (a, b, 6)))
        want = torch.cat([whole[a:b], whole[6 + a:6 + b]])
        assert torch.equal(got, want), (a, b)
    with pytest.raises(ValueError, match="rows 0:2 of a batch"):
        drop(x[:6].clone(), steps.batch_generators((4, 1), 2, "cpu",
                                                   (0, 2, 6)))


@pytest.mark.parametrize("factory,rng,options", [
    (lambda mesh: steps.make_mc_predict_fn(3, mesh), ((20, 4),), {}),
    # the shared encoder prefix: its tail's dropout draws the rows too
    (lambda mesh: steps.make_mc_predict_fn(3, mesh), ((20, 4),),
     {"depth": 3, "dropout_center": 1}),
    (lambda mesh: steps.make_predict_fn(mesh), (), {})])
def test_mesh_predict_is_the_single_device_s(factory, rng, options):
    torch.manual_seed(0)
    model = get_model("unet", {**PARAMS, **options}).eval()
    assert model.mc_shared_blocks == (2 if options else 0)
    batch = {"images": torch.randn(5, 16, 16, 2)}
    with torch.inference_mode():
        want = factory(None)(model, batch, *rng)
        mesh = cpu_mesh(2)
        got = factory(mesh)(replicate(model, mesh.data_devices), batch, *rng)
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------ the ensemble

def flax_members(k, hw=(16, 16)):
    out = []
    for i in range(k):
        fm, params, stats = flax_unet(PARAMS, hw, seed=i)
        params = jax.tree_util.tree_map(lambda x: x * 3.0, params)
        out.append((fm, params, stats))
    return out


def port_member(params, stats):
    model = get_model("unet", PARAMS)
    model.load_state_dict(state_dict_from_flax(params, stats))
    return model.eval()


def test_ep_predict_matches_jax_s():
    """4 members over 2 model rows x 2 data columns against JAX's EP on its
    2 x 4 mesh, with the MI and variance identities."""
    members = flax_members(4)
    rng = np.random.RandomState(0)
    images = rng.rand(8, 16, 16, 2).astype(np.float32)
    stack = lambda *xs: np.stack(xs)  # noqa: E731
    stacked_params = jax.tree_util.tree_map(stack, *[m[1] for m in members])
    stacked_stats = jax.tree_util.tree_map(stack, *[m[2] for m in members])
    jax_fn = jax_ens.shard_ensemble_predict_fn(
        members[0][0], jax_ens.make_ensemble_mesh(2), do_mi=True, do_var=True)
    want = jax_fn(stacked_params, stacked_stats, {"images": images})
    port = [port_member(p, s) for _, p, s in members]
    fn = shard_ensemble_predict_fn(port, make_ensemble_mesh(2, ["cpu"] * 4),
                                   do_mi=True, do_var=True)
    with torch.inference_mode():
        got = fn(None, {"images": torch.from_numpy(images)})
        plain = steps.make_ensemble_predict_fn(port)(
            None, {"images": torch.from_numpy(images)})
    for key in ("probabilities", "entropy", "mutual_info", "variance"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=2e-5, err_msg=key)
    for key in ("probabilities", "entropy"):
        torch.testing.assert_close(got[key], plain[key], rtol=1e-6,
                                   atol=1e-7)


def test_members_must_divide_over_the_model_axis():
    members = [get_model("unet", PARAMS) for _ in range(3)]
    with pytest.raises(ValueError, match="3 members do not divide"):
        shard_members(members, make_ensemble_mesh(2, ["cpu"] * 2))
    placed = shard_members(members[:2], make_ensemble_mesh(2, ["cpu"] * 4))
    # 2 data columns, each with 2 rows of one member
    assert [[len(row) for row in col] for col in placed] == [[1, 1], [1, 1]]
    assert placed[1][1][0] is members[1]


# ------------------------------------------------------- the float32 policy

def test_tf32_stays_off_while_any_thread_is_inside():
    """Overlapping ``full_float32`` blocks of two threads: the flags stay
    off until the last one leaves, which restores the caller's."""
    holder, name, off = eval_device.fp32_switches()[0]
    saved = getattr(holder, name)
    setattr(holder, name, not off)
    entered, release = threading.Event(), threading.Event()

    def other():
        with eval_device.full_float32():
            entered.set()
            release.wait(5)

    thread = threading.Thread(target=other)
    try:
        thread.start()
        entered.wait(5)
        with eval_device.full_float32():
            assert getattr(holder, name) == off
        assert getattr(holder, name) == off  # the other block is open
        release.set()
        thread.join()
        assert getattr(holder, name) == (not off)
    finally:
        release.set()
        setattr(holder, name, saved)
