"""The direct eval on a mesh (``evaluate_subjects`` / ``evaluate_direct``
with ``mesh=`` and ``subject_parallel=``) on virtual CPU meshes, against
the port's own single-device run of the same models and data, and against
``rcu_tpu.eval.direct`` on its virtual CPU mesh.

Every family (mc=3, deterministic, aleatoric, the ensemble, auxiliary_feat,
auxiliary_segm) on volumes (5 slices at batch 4: a ragged last batch) and
on native-2D images (7 images, chunks of 4 and 3):
- throughput mode (a subject, or a chunk's part, a device) writes the
  single device's CSVs byte for byte;
- latency mode (each batch split over the data devices, one eval kernel
  launch a device and item) at the JAX package's bar
  (``tests/test_direct_eval.py``: rtol 1e-4, atol 1e-6, strings equal;
  integers exact). A 3-entry mesh rounds batch 4 up to 6: the MC stream
  then names 6-slice batches, so mc is held against the single device at
  batch 6 and the single-forward families at batch 4.
The ensemble also on a 2 x 1 model x data mesh (a member a row), and the
fast decoder and int8 (mc, ensemble) on a latency mesh.
"""
import csv
import os

import numpy as np
import pytest
import torch

from rcu_tpu.engine import config as jax_cfg
from rcu_tpu.eval.direct import evaluate_direct as jax_evaluate_direct
from rcu_tpu.parallel import mesh as jax_mesh
from rcu_tpu_torch.cli import eval_direct as port_cli
from rcu_tpu_torch.engine import config as port_cfg
from rcu_tpu_torch.eval import direct as port_direct
from rcu_tpu_torch.eval.direct import (_calibrated_quant_model,
                                       evaluate_subjects)
from rcu_tpu_torch.models import FAST_DECODER_KWARGS, get_model
from rcu_tpu_torch.ops.cuda import evalstats
from rcu_tpu_torch.parallel import make_mesh
from rcu_tpu_torch.parallel.ensemble import make_ensemble_mesh
from tests.test_torch_parallel import one_thread  # noqa: F401
from tests.test_torch_direct import env  # noqa: F401

UNET = dict(nb_classes=2, in_channels=4, depth=2, start_filters=4,
            dropout=0.2)
HW = (16, 16)


class Volumes:
    """Three subjects of (5, 16, 16, 4) in memory; with ``baseline`` the
    labels carry [gt, baseline prediction]."""

    def __init__(self, baseline=False, n=3, slices=5, seed=0):
        rng = np.random.RandomState(seed)
        self.subjects = [f"s{i}" for i in range(n)]
        self.data = {}
        for s in self.subjects:
            gt = np.zeros((slices,) + HW, np.uint8)
            gt[:, 4:11, 5:12] = 1
            images = rng.randn(slices, *HW, 4).astype(np.float32) * 0.5
            images[..., 0] += gt
            labels = gt
            if baseline:
                labels = np.stack([gt, (rng.rand(slices, *HW) > 0.5)
                                   .astype(np.uint8)], -1)
            self.data[s] = {"images": images, "labels": labels}

    def read_volume(self, subject, category):
        return self.data[subject][category]

    def shape(self, subject, category="images"):
        return self.data[subject][category].shape

    def files(self, subject):
        return {}


class Images(Volumes):
    """Seven native-2D images (16, 16, 4) with their (16, 16) labels."""

    def __init__(self, baseline=False):
        super().__init__(baseline, n=7, slices=1, seed=1)
        for item in self.data.values():
            item["images"] = item["images"][0]
            item["labels"] = item["labels"][0]


def unet(seed, **options):
    torch.manual_seed(seed)
    return get_model("unet", {**UNET, **options}).eval()


def family_models(family):
    if family in ("mc", "deterministic"):
        return unet(1)
    if family == "aleatoric":
        return unet(2, sigma_out=True)
    if family == "ensemble":
        return [unet(3), unet(4)]
    if family == "auxiliary_feat":
        torch.manual_seed(5)
        return (unet(6, provide_features=True),
                get_model("postnet", {"nb_classes": 2, "in_channels": 4})
                .eval())
    return unet(7, in_channels=5)


FAMILIES = ("mc", "deterministic", "aleatoric", "ensemble", "auxiliary_feat",
            "auxiliary_segm")


def run(tmp_path, name, family, dataset, mesh=None, batch_size=4, **kw):
    out = str(tmp_path / name)
    models = kw.pop("models", None) or family_models(family)
    evaluate_subjects(models, dataset, out, strategy=family,
                      mc=3 if family == "mc" else 0, batch_size=batch_size,
                      masked=False, device="cpu", mesh=mesh, **kw)
    return out


def read_dir(out_dir):
    return {name: open(os.path.join(out_dir, name)).read()
            for name in sorted(os.listdir(out_dir))}


def assert_csvs_close(want_dir, got_dir):
    """JAX's mesh bar: every cell within rtol 1e-4 / atol 1e-6, integers
    exact, other strings equal."""
    want, got = read_dir(want_dir), read_dir(got_dir)
    assert sorted(got) == sorted(want)
    for name in want:
        rows_w = list(csv.reader(want[name].splitlines()))
        rows_g = list(csv.reader(got[name].splitlines()))
        assert len(rows_w) == len(rows_g) > 1, name
        for rw, rg in zip(rows_w, rows_g):
            assert len(rw) == len(rg), name
            for a, b in zip(rg, rw):
                try:
                    int(a), int(b)
                    assert a == b, (name, a, b)
                    continue
                except ValueError:
                    pass
                try:
                    np.testing.assert_allclose(float(a), float(b), rtol=1e-4,
                                               atol=1e-6, err_msg=name)
                except ValueError:
                    assert a == b, (name, a, b)


def cpu_mesh(n):
    return make_mesh(n_devices=n, device="cpu")


@pytest.mark.parametrize("data", ["volumes", "images"])
@pytest.mark.parametrize("family", FAMILIES)
def test_both_modes_write_the_single_device_csvs(tmp_path, family, data):
    make = Volumes if data == "volumes" else Images
    dataset = make(baseline=family == "auxiliary_segm")
    single = run(tmp_path, "single", family, dataset)
    plain = evalstats.fused_eval_stats.plain_calls
    throughput = run(tmp_path, "throughput", family, dataset,
                     cpu_mesh(2), subject_parallel=True)
    assert read_dir(throughput) == read_dir(single)
    launched = evalstats.fused_eval_stats.plain_calls - plain
    plain = evalstats.fused_eval_stats.plain_calls
    latency = run(tmp_path, "latency", family, dataset, cpu_mesh(2))
    assert_csvs_close(single, latency)
    # latency: one launch a data device where one launch served the item
    assert evalstats.fused_eval_stats.plain_calls - plain == 2 * launched


@pytest.mark.parametrize("family", ["mc", "deterministic", "aleatoric",
                                    "auxiliary_segm"])
def test_three_devices_round_the_batch_up(tmp_path, family):
    """batch 4 -> 6 on a 3-entry mesh (JAX's ``pad_batch_size_to_mesh``);
    the ragged parts (6 slices: 2, 2, 2; 5 slices: 2, 2, 1) still give
    the single device's rows."""
    dataset = Volumes(baseline=family == "auxiliary_segm")
    single = run(tmp_path, "single", family, dataset,
                 batch_size=6 if family == "mc" else 4)
    latency = run(tmp_path, "latency", family, dataset, cpu_mesh(3))
    assert_csvs_close(single, latency)
    images = Images(baseline=family == "auxiliary_segm")
    single = run(tmp_path, "single_2d", family, images,
                 batch_size=6 if family == "mc" else 4)
    latency = run(tmp_path, "latency_2d", family, images, cpu_mesh(3))
    assert_csvs_close(single, latency)


@pytest.mark.parametrize("data", ["volumes", "images"])
def test_ensemble_members_over_the_model_axis(tmp_path, data):
    dataset = Volumes() if data == "volumes" else Images()
    members = [unet(3), unet(4), unet(8), unet(9)]
    single = run(tmp_path, "single", "ensemble", dataset, models=members)
    mesh = make_ensemble_mesh(2, ["cpu"] * 2)  # 2 model rows x 1 data
    assert mesh.shape == {"model": 2, "data": 1}
    plain = evalstats.fused_eval_stats.plain_calls
    ep = run(tmp_path, "ep", "ensemble", dataset, mesh, models=members)
    # one data device: one launch an item
    assert evalstats.fused_eval_stats.plain_calls - plain == \
        (3 if data == "volumes" else 2)
    assert_csvs_close(single, ep)
    grid = run(tmp_path, "grid", "ensemble", dataset,
               make_ensemble_mesh(2, ["cpu"] * 4), models=members)
    assert_csvs_close(single, grid)


@pytest.mark.parametrize("family", ["mc", "ensemble"])
def test_fast_decoder_and_int8_on_a_latency_mesh(tmp_path, family):
    """The fast decoder's split and fused convs, and the int8 sites, on a
    split batch: the single device's CSVs (int8 calibrated once on the
    first device, then copied)."""
    dataset = Volumes()

    def models(quantize):
        fast = [unet(s, **FAST_DECODER_KWARGS) for s in (3, 4)]
        chosen = fast if family == "ensemble" else fast[0]
        if quantize:
            chosen = _calibrated_quant_model(chosen, dataset, 4, 20,
                                             ensemble=family == "ensemble",
                                             skip_levels=0)
        return chosen

    for quantize in (False, True):
        single = run(tmp_path, f"single{quantize}", family, dataset,
                     models=models(quantize))
        latency = run(tmp_path, f"latency{quantize}", family, dataset,
                      cpu_mesh(2), models=models(quantize))
        assert_csvs_close(single, latency)


def test_evaluate_direct_on_jax_s_mesh(env, tmp_path):  # noqa: F811
    """The config entry point against ``rcu_tpu.eval.direct`` on its
    2-device mesh (``mc=0``, margin-searched weights); the throughput run
    byte for byte the port's single-device run; ``mc=3`` on a latency
    mesh the single device's stream."""
    _, config_file = env
    jax_evaluate_direct(jax_cfg.load(config_file, "test-config"),
                        str(tmp_path / "jax"), run_id="mesh", mc=0,
                        mesh=jax_mesh.make_mesh(n_devices=2))
    config = port_cfg.load(config_file)
    out = {}
    for name, kw in (("one", {}), ("latency", {"mesh": cpu_mesh(2)}),
                     ("throughput", {"mesh": cpu_mesh(2),
                                     "subject_parallel": True})):
        for mc in (0, 3):
            out[name, mc] = str(tmp_path / f"{name}{mc}")
            port_direct.evaluate_direct(config, out[name, mc], run_id="mesh",
                                        mc=mc, device="cpu", **kw)
    assert_csvs_close(str(tmp_path / "jax"), out["latency", 0])
    for mc in (0, 3):
        assert read_dir(out["throughput", mc]) == read_dir(out["one", mc])
        assert_csvs_close(out["one", mc], out["latency", mc])
    with pytest.raises(ValueError, match="not the mesh's first device"):
        port_direct.evaluate_direct(config, str(tmp_path / "x"), mc=0,
                                    device="meta", mesh=cpu_mesh(2))


@pytest.mark.parametrize("flags", [["-devices", "2"],
                                   ["-devices", "2", "-throughput"]])
def test_cli_devices_on_the_cpu(env, tmp_path, flags):  # noqa: F811
    _, config_file = env
    single = str(tmp_path / "single")
    port_cli.main(config_file, "cli", single, 0, device="cpu")
    mesh_dir = str(tmp_path / "mesh")
    args = dict(devices=int(flags[1]), throughput="-throughput" in flags)
    port_cli.main(config_file, "cli", mesh_dir, 0, device="cpu", **args)
    assert_csvs_close(single, mesh_dir)
    with pytest.raises(ValueError, match="-throughput needs -devices"):
        port_cli.main(config_file, "cli", mesh_dir, 0, device="cpu",
                      throughput=True)
