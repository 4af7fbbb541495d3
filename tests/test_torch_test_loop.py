"""The port's staged test loop (``rcu_tpu_torch.engine.test``) against
``rcu_tpu.engine.test`` on the same H5 store, split, yaml config and flax
checkpoint (written by the JAX checkpoint service), through
``strategies.test_default`` of both packages:

- the deterministic run writes the same artifact set; the probabilities
  agree at the f32 bar (rtol 1e-3 / atol 2e-4), the predictions equal
  except at argmax ties (voxels whose fg lies within that bar of 0.5,
  counted and shown), ``metrics.csv``'s Dice within 1e-4;
- ``mc=3``: the same schema and file set, byte-identical reruns; the MC
  protocol itself is held exactly on one batch whose dropout masks both
  packages are given (numpy-made; JAX's draw patched in the test only);
- the run-dir reservation, the raise for subjects left partly assembled,
  a failed background write surfacing at ``flush()``, ``test_at`` 0 and
  the ten test CLIs (config ids, ``-device cpu``, the card by default).

The helpers here also serve ``tests/test_torch_test_strategies.py``,
``test_torch_eval_engine*.py`` and ``test_torch_staged_vs_direct.py``.
"""
import csv
import importlib
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.linen import stochastic

from rcu_tpu import strategies as jax_strategies
from rcu_tpu.data.split import save_split
from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.engine.steps import multi_prediction_summary as jax_summary
from rcu_tpu_torch import directories as dirs
from rcu_tpu_torch import strategies
from rcu_tpu_torch.data import nifti
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.engine import steps
from rcu_tpu_torch.engine import test as test_lib
from rcu_tpu_torch.models import get_model
from rcu_tpu_torch.models.convert import state_dict_from_flax
from rcu_tpu_torch.models.unet import ChannelDropout
from rcu_tpu_torch.parallel import make_mesh
from tests.test_torch_direct import SHAPE, make_store
from tests.test_torch_unet import flax_net

UNET = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
            dropout=0.2)
TEST_SUBJECTS = ["s02", "s03"]
RTOL, ATOL = 1e-3, 2e-4  # tests/test_model_weight_parity.py:133-137
MC_MEAN_ATOL = 0.02  # MC means, tests/test_model_weight_parity.py:203
TEST_CLIS = [f"{ds}_test_{s}" for ds in ("brats", "isic")
             for s in ("default", "aleatoric", "ensemble", "auxiliary_feat",
                       "auxiliary_segm")]


def write_model(model_dir, model_type, record, checkpoints):
    """A model dir by the JAX checkpoint service: model.json of ``record``
    and ``checkpoints`` ``{(epoch, best): (params, batch_stats)}``."""
    mf = jax_ckpt.ModelFiles.from_model_dir(str(model_dir))
    jax_ckpt.backup_model_parameters(
        mf, jax_cfg.ParametricNode(model_type, record), None)
    for (epoch, best), (params, stats) in checkpoints.items():
        jax_ckpt.save_checkpoint(mf, {"params": params, "batch_stats": stats,
                                      "epoch": epoch, "best_score": 0.5},
                                 epoch=epoch, best=best)
    return str(model_dir)


def seeded_model(model_dir, model_type, record, seed, hw=SHAPE[1:],
                 head_scale=1.0):
    """A model dir holding flax weights of ``seed`` as its epoch-1 best
    checkpoint; ``head_scale`` scales the class head (sharper logits,
    whose probabilities spread over the bins)."""
    _, params, stats = flax_net(model_type, record, hw, seed=seed)
    head = "Conv_0" if model_type == "postnet" else "Conv_2"
    params[head] = {k: head_scale * v for k, v in params[head].items()}
    return write_model(model_dir, model_type, record,
                       {(1, True): (params, stats)})


def write_config(path, name, store, split, model_dir=None, others=None,
                 test_at="best", transform=None, indexing=True, batch_size=2):
    data = {"batch_size": batch_size, "dataset": store, "shuffle": False,
            "num_workers": 0}
    if indexing:
        data["indexing"] = {"slice": {}}
    if transform:
        data["transform"] = transform
    with open(path, "w") as f:
        yaml.safe_dump({"config": {
            "test_name": name, "model_dir": model_dir, "split": split,
            "seed": 20, "test_at": test_at, "others": others or {},
            "test_data": data},
            "meta": {"type": "test-config", "version": 0}}, f)
    return str(path)


def run_both(config_file, tmp_path, jax_run, port_run, **kwargs):
    """The JAX and the port's test runner on ``config_file``, each with a
    test dir of its own; -> (JAX loop, port loop)."""
    jax_config = jax_cfg.load(config_file, "test-config")
    jax_config.test_dir = str(tmp_path / "jax")
    port_config = port_cfg.load(config_file, "test-config")
    port_config.test_dir = str(tmp_path / "port")
    return (jax_run(jax_config, **kwargs),
            port_run(port_config, device="cpu", **kwargs))


def run_files(run_dir):
    return sorted(os.listdir(run_dir))


def read_nifti(run_dir, subject, postfix):
    return nifti.read(os.path.join(run_dir, f"{subject}_{postfix}.nii.gz"))[0]


def read_metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.csv")) as f:
        return list(csv.reader(f))


def assert_artifacts_close(want_dir, got_dir, subjects, planes=(),
                           prediction_fg="probabilities"):
    """The same files; each float artifact of ``planes`` at the f32 bar;
    the predictions equal except at argmax ties, where the fg artifact
    ``prediction_fg`` lies within the bar of 0.5 (a plane that follows the
    predicted class, ``sigma``, is held off those voxels). Returns the
    ties."""
    assert run_files(got_dir) == run_files(want_dir)
    ties = 0
    for subject in subjects:
        want_pred = read_nifti(want_dir, subject, "prediction")
        got_pred = read_nifti(got_dir, subject, "prediction")
        assert got_pred.dtype == want_pred.dtype == np.uint8
        fg = read_nifti(want_dir, subject, prediction_fg)
        near = np.abs(fg - 0.5) <= ATOL + RTOL * 0.5
        differ = got_pred != want_pred
        assert not (differ & ~near).any(), subject
        ties += int(differ.sum())
        for postfix in planes:
            want = read_nifti(want_dir, subject, postfix)
            got = read_nifti(got_dir, subject, postfix)
            assert got.dtype == np.float32 and got.shape == want.shape
            keep = ~differ if postfix == "sigma" else np.ones(want.shape, bool)
            np.testing.assert_allclose(got[keep], want[keep], rtol=RTOL,
                                       atol=ATOL, err_msg=postfix)
    print(f"argmax ties that differ: {ties}")
    return ties


def assert_metrics_close(want_dir, got_dir):
    want, got = read_metrics(want_dir), read_metrics(got_dir)
    assert got[0] == want[0] and len(got) == len(want) > 1
    for w, g in zip(want[1:], got[1:]):
        assert g[0] == w[0]
        np.testing.assert_allclose(np.float64(g[1:]), np.float64(w[1:]),
                                   atol=1e-4)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """An H5 store (raw-t2 NIfTIs beside it), the split, and a U-Net model
    dir with two checkpoints: epoch 1 best and epoch 0 (other weights)."""
    tmp = tmp_path_factory.mktemp("torch_test_loop")
    store = make_store(tmp)
    split = str(tmp / "split.json")
    save_split(split, ["s00"], ["s01"], TEST_SUBJECTS)
    _, best, best_stats = flax_net("unet", UNET, SHAPE[1:], seed=1)
    _, first, first_stats = flax_net("unet", UNET, SHAPE[1:], seed=2)
    model_dir = write_model(tmp / "model_x", "unet", UNET, {
        (1, True): (best, best_stats), (0, False): (first, first_stats)})
    return tmp, store, split, model_dir


def test_default_run_matches_jax(env, tmp_path):
    tmp, store, split, model_dir = env
    config = write_config(tmp_path / "t.yaml", "det", store, split, model_dir)
    jax_loop, port_loop = run_both(config, tmp_path,
                                   jax_strategies.test_default,
                                   strategies.test_default)
    files = run_files(port_loop.run_dir)
    assert files == sorted(["config.yaml", "log.txt", "metrics.csv"] + [
        f"{s}_{p}.nii.gz" for s in TEST_SUBJECTS
        for p in ("prediction", "probabilities")])
    assert port_loop.run_dir.startswith(str(tmp_path / "port"))
    assert os.path.basename(port_loop.run_dir).endswith("_det")
    assert_artifacts_close(jax_loop.run_dir, port_loop.run_dir, TEST_SUBJECTS,
                           ("probabilities",))
    probs = read_nifti(port_loop.run_dir, "s02", "probabilities")
    assert probs.shape == SHAPE and 0.0 < probs.min() < probs.max() < 1.0
    assert read_metrics(port_loop.run_dir)[0] == ["subject", "dice"]
    assert_metrics_close(jax_loop.run_dir, port_loop.run_dir)
    saved = port_cfg.load(os.path.join(port_loop.run_dir, "config.yaml"),
                          "test-config")
    assert saved.to_dict() == port_loop.config.to_dict()


def test_mc_schema_and_reruns(env, tmp_path):
    tmp, store, split, model_dir = env
    config = write_config(tmp_path / "t.yaml", "mc", store, split, model_dir,
                          {"mc": 3})
    jax_loop, port_loop = run_both(config, tmp_path,
                                   jax_strategies.test_default,
                                   strategies.test_default)
    assert run_files(port_loop.run_dir) == run_files(jax_loop.run_dir)
    assert read_metrics(port_loop.run_dir)[0] == \
        read_metrics(jax_loop.run_dir)[0]
    means = [np.mean([read_nifti(loop.run_dir, s, "probabilities")
                      for s in TEST_SUBJECTS]) for loop in (jax_loop, port_loop)]
    print("MC run means", means)
    assert abs(means[0] - means[1]) <= MC_MEAN_ATOL
    again = strategies.test_default(port_cfg.load(config), device="cpu")
    for name in run_files(port_loop.run_dir):
        if name.endswith((".nii.gz", ".csv")):
            with open(os.path.join(port_loop.run_dir, name), "rb") as a, \
                    open(os.path.join(again.run_dir, name), "rb") as b:
                assert a.read() == b.read(), name
    det = strategies.test_default(port_cfg.load(write_config(
        tmp_path / "d.yaml", "d", store, split, model_dir)), device="cpu")
    assert not np.array_equal(read_nifti(det.run_dir, "s02", "probabilities"),
                              read_nifti(port_loop.run_dir, "s02",
                                         "probabilities"))


class InjectedMasks:
    """Dropout masks made with numpy, one (batch, channels) mask for each
    dropout site and sample, the same for both packages: sample ``t`` of
    site ``k`` keeps a channel where ``RandomState(1000 k + t)``'s uniform
    draw is below the keep probability."""

    def __init__(self, keep, samples):
        self.keep, self.samples = keep, samples
        self.calls = 0

    def mask(self, site, t, shape):
        return np.random.RandomState(1000 * site + t).rand(*shape) < self.keep

    def flax_draw(self, order):
        """A stand-in for ``jax.random.bernoulli`` in flax's Dropout: the
        ``order``-th call of a forward is sample ``t``'s site ``k``."""
        def bernoulli(key, p, shape):
            site, t = order(self.calls)
            self.calls += 1
            b, _, _, c = shape  # (B, 1, 1, C): broadcast over H and W
            return jax.numpy.asarray(self.mask(site, t, (b, c))
                                     .reshape(shape))
        return bernoulli

    def torch_rand(self, real):
        """A stand-in for ``torch.rand`` in the port's ChannelDropout: the
        port draws sample after sample of one site; a uniform 0 keeps a
        channel, a 1 drops it."""
        def rand(*size, generator=None, device=None, **kwargs):
            site, t = divmod(self.calls, self.samples)
            self.calls += 1
            shape = size[0] if len(size) == 1 else size
            return torch.from_numpy(np.where(self.mask(site, t, shape), 0.0,
                                             1.0).astype(np.float32))
        return rand


def test_mc_batch_with_injected_masks_matches_jax(env, monkeypatch):
    """The MC predict function of a test batch with the same masks in both
    packages: the mean probabilities and the entropy at the f32 bar."""
    _, store, _, _ = env
    fm, params, stats = flax_net("unet", UNET, SHAPE[1:], seed=1)
    # sharper logits, so that the masks move the mean well past the bar
    params["Conv_2"] = {k: 8 * v for k, v in params["Conv_2"].items()}
    from rcu_tpu.data import h5
    reader = h5.SubjectDataset(store)
    x = np.asarray(reader.read_volume("s02", "images"))[:2]
    reader.close()
    samples = 3
    masks = InjectedMasks(1.0 - UNET["dropout"], samples)
    # flax, one sample a forward: call k of the run is sample k // sites
    probs = []
    sites = None
    for t in range(samples):
        start = masks.calls
        monkeypatch.setattr(stochastic.random, "bernoulli", masks.flax_draw(
            lambda k, t=t, start=start: (k - start, t)))
        out = fm.apply({"params": params, "batch_stats": stats}, x,
                       train=False, mc_dropout=True,
                       rngs={"dropout": jax.random.PRNGKey(t)})
        probs.append(jax.nn.softmax(out.logits, -1))
        sites = masks.calls - start
    monkeypatch.undo()
    want = jax_summary(jax.numpy.stack(probs))
    model = get_model("unet", UNET)
    # a mask for every dropout site of the model, in both packages
    assert sites == sum(isinstance(m, ChannelDropout) for m in model.modules())
    model.load_state_dict(state_dict_from_flax(params, stats))
    model.eval()
    port_masks = InjectedMasks(1.0 - UNET["dropout"], samples)
    monkeypatch.setattr(torch, "rand", port_masks.torch_rand(torch.rand))
    with torch.inference_mode():
        got = steps.make_mc_predict_fn(samples)(
            model, {"images": torch.from_numpy(x)}, (20, 0))
    monkeypatch.undo()
    assert port_masks.calls == sites * samples
    deterministic = jax.nn.softmax(fm.apply(
        {"params": params, "batch_stats": stats}, x).logits, -1)
    # the masks move the mean: the bar below holds the dropout arithmetic
    assert np.abs(np.asarray(want["probabilities"])
                  - np.asarray(deterministic)).max() > 0.05
    for key in ("probabilities", "entropy"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(got["ws_probabilities"].numpy(),
                               np.asarray(deterministic), rtol=RTOL, atol=ATOL)


def test_run_dir_reservation(env, tmp_path, monkeypatch):
    """Runs in the same second take the next id; five taken ids raise."""
    tmp, store, split, model_dir = env
    config = port_cfg.load(write_config(tmp_path / "t.yaml", "r", store,
                                        split, model_dir))
    config.test_dir = str(tmp_path / "runs")
    ids = iter(["000001-000001", "000001-000001", "000001-000002",
                "000001-000003"])
    monkeypatch.setattr(test_lib.ids_lib, "unique_identifier",
                        lambda: next(ids))
    monkeypatch.setattr(test_lib.time, "sleep", lambda s: None)
    first = test_lib.TestLoop(config, device="cpu")
    second = test_lib.TestLoop(config, device="cpu")
    assert os.path.basename(first.run_dir) == "000001-000001_r"
    assert os.path.basename(second.run_dir) == "000001-000002_r"
    # a loop on a mesh reserves its own run dir too, on the mesh's first
    # device (the mode itself: tests/test_torch_parallel_serve.py)
    mesh = make_mesh(n_devices=2, device="cpu")
    on_mesh = test_lib.TestLoop(config, mesh=mesh)
    assert os.path.basename(on_mesh.run_dir) == "000001-000003_r"
    assert on_mesh.mesh is mesh and on_mesh.device == torch.device("cpu")
    monkeypatch.setattr(test_lib.ids_lib, "unique_identifier",
                        lambda: "000001-000001")
    with pytest.raises(RuntimeError, match="after 5 attempts"):
        test_lib.TestLoop(config, device="cpu")
    with pytest.raises(ValueError, match="model_dir or an explicit model"):
        test_lib.TestLoop(port_cfg.TestConfiguration(test_dir=str(tmp_path)),
                          device="cpu")


class _FirstBatches:
    """The loader's batches but the last: its subject stays partial."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader) - 1

    def __iter__(self):
        batches = list(self.loader)
        return iter(batches[:-1])


def test_partly_assembled_subjects_raise(env, tmp_path, monkeypatch):
    tmp, store, split, model_dir = env
    build = test_lib.databuild.build_data

    def short_data(*args, **kwargs):
        data = build(*args, **kwargs)
        data.loader = _FirstBatches(data.loader)
        return data

    monkeypatch.setattr(test_lib.databuild, "build_data", short_data)
    loop = test_lib.TestLoop(port_cfg.load(write_config(
        tmp_path / "t.yaml", "short", store, split, model_dir)), device="cpu")
    with pytest.raises(RuntimeError, match=r"partially assembled.*'s03'"):
        loop.run()
    # the complete subject's artifacts were written before the raise
    assert "s02_probabilities.nii.gz" in run_files(loop.run_dir)
    assert not any(n.startswith("s03") for n in run_files(loop.run_dir))


def test_failed_write_surfaces_at_flush(env, tmp_path, monkeypatch):
    tmp, store, split, model_dir = env
    write = test_lib.nifti.write

    def failing(array, path, props=None):
        if path.endswith("s02_prediction.nii.gz"):
            raise OSError("disk full")
        return write(array, path, props)

    monkeypatch.setattr(test_lib.nifti, "write", failing)
    loop = test_lib.TestLoop(port_cfg.load(write_config(
        tmp_path / "t.yaml", "fail", store, split, model_dir)), device="cpu")
    with pytest.raises(OSError, match="disk full"):
        loop.run()
    # the pool waited for every other write before it raised
    files = run_files(loop.run_dir)
    assert {"s02_probabilities.nii.gz", "s03_probabilities.nii.gz",
            "s03_prediction.nii.gz"} <= set(files)
    assert "metrics.csv" not in files


def test_test_at_epoch_0(env, tmp_path):
    """Epoch 0 is an epoch, not 'unset': both packages load checkpoint
    ep000, whose weights differ from the best's."""
    tmp, store, split, model_dir = env
    config = write_config(tmp_path / "t.yaml", "ep0", store, split, model_dir,
                          test_at=0)
    jax_loop, port_loop = run_both(config, tmp_path,
                                   jax_strategies.test_default,
                                   strategies.test_default)
    assert_artifacts_close(jax_loop.run_dir, port_loop.run_dir, TEST_SUBJECTS,
                           ("probabilities",))
    best = strategies.test_default(port_cfg.load(write_config(
        tmp_path / "b.yaml", "best", store, split, model_dir)), device="cpu")
    assert np.abs(read_nifti(best.run_dir, "s02", "probabilities")
                  - read_nifti(port_loop.run_dir, "s02", "probabilities")
                  ).max() > 1e-2


def test_cli_runs_on_the_cpu_when_asked(env, tmp_path):
    from rcu_tpu_torch.cli import brats_test_default
    tmp, store, split, model_dir = env
    config = port_cfg.load(write_config(tmp_path / "t.yaml", "cli", store,
                                        split, model_dir))
    config.test_dir = str(tmp_path / "out")
    path = str(tmp_path / "cli.yaml")
    port_cfg.save(config, path)
    loop = brats_test_default.main(path, device="cpu")
    assert len([n for n in run_files(loop.run_dir) if n.endswith(".nii.gz")]) == 4
    if torch.cuda.is_available():
        return  # a card is present: the default device runs
    with pytest.raises(RuntimeError, match="device='cpu'"):
        brats_test_default.main(path)


@pytest.mark.parametrize("name", TEST_CLIS)
def test_cli_config_ids_are_the_jax_clis(name, monkeypatch):
    port = importlib.import_module(f"rcu_tpu_torch.cli.{name}")
    jax_module = importlib.import_module(f"bin.{name}")
    assert port.DEFAULT_CONFIGS == jax_module.DEFAULT_CONFIGS
    for rel in port.DEFAULT_CONFIGS.values():
        assert os.path.exists(os.path.join(dirs.CONFIG_DIR, rel)), rel
    seen = {}

    def fake(config, **kwargs):
        seen.update(config=config, **kwargs)
        return "ran"

    strategy = name.split("_test_")[1]
    monkeypatch.setattr(strategies, f"test_{strategy}", fake)
    assert strategies.TEST_STRATEGIES[strategy].__name__ == f"test_{strategy}"
    cid = next(iter(port.DEFAULT_CONFIGS))
    assert port.main(None, cid, device="cpu") == "ran"
    assert seen["device"] == "cpu" and seen["mesh"] is None
    assert isinstance(seen["config"], port_cfg.TestConfiguration)
    assert seen.get("symlink_inputs", False) == name.startswith("isic")
    # -devices 2 -device cpu: the virtual CPU mesh; on cuda a mesh of two
    # cards, which raises where there are fewer
    assert port.main(None, cid, device="cpu", devices=2) == "ran"
    assert seen["mesh"].devices == (torch.device("cpu"),) * 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="cuda device"):
            port.main(None, cid, devices=2)
    with pytest.raises(ValueError, match="unknown config id"):
        port.main(None, "nope")
