"""Checkpoint import without jax: ``rcu_tpu_torch.cli.import_torch_checkpoint``
against ``scripts/import_torch_checkpoint.py`` on reference-layout model
dirs (state_dicts built from seeded numpy arrays under the reference
implementation's key names, saved with ``torch.save``): plain,
sigma-head, residual, BatchNorm-free and residual BN-free U-Nets, a
PostNet, and a multi-model dir with a postfixed PostNet. The two
importers write the same file names and model.json bytes, and their
checkpoints restore in ``rcu_tpu`` to equal trees (params, batch_stats,
the fresh optax state, epoch, best_score); the port's
``eval.direct.load_model`` loads the imported dir with flax's logits. The
port loads payloads weights-only with numpy scalars allowed, and refuses
other payloads; the errors are the JAX script's."""
import importlib.util
import json
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from rcu_tpu.engine import checkpoint as jax_ckpt
from rcu_tpu.models import get_model as flax_get_model
from rcu_tpu_torch.cli import import_torch_checkpoint as port_tool
from rcu_tpu_torch.eval.direct import load_model

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = dict(nb_classes=2, in_channels=3, depth=2, start_filters=4,
            dropout=None)
POSTNET = dict(nb_classes=2, in_channels=4, nb_convs=2)


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "import_torch_checkpoint",
        os.path.join(REPO_ROOT, "scripts", "import_torch_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(rng, *shape, offset=0.0):
    return torch.from_numpy((offset + rng.randn(*shape) * 0.3)
                            .astype(np.float32))


def ref_cbr(sd, prefix, cin, cout, kernel, rng, bn=True):
    """A reference Conv2dBnRelu's entries."""
    conv = f"{prefix}.conv2d_batch_relu.conv"
    sd[f"{conv}.weight"] = _t(rng, cout, cin, kernel, kernel)
    sd[f"{conv}.bias"] = _t(rng, cout)
    if bn:
        norm = f"{prefix}.conv2d_batch_relu.bn"
        sd[f"{norm}.weight"] = _t(rng, cout, offset=1.0)
        sd[f"{norm}.bias"] = _t(rng, cout)
        sd[f"{norm}.running_mean"] = _t(rng, cout)
        sd[f"{norm}.running_var"] = torch.from_numpy(
            (0.5 + rng.rand(cout)).astype(np.float32))
        sd[f"{norm}.num_batches_tracked"] = torch.tensor(7)


def ref_block(sd, prefix, cin, cout, rng, residual, bn):
    for j in range(2):
        ref_cbr(sd, f"{prefix}.block.{j}", cin if j == 0 else cout, cout, 3,
                rng, bn)
    if residual:
        sd[f"{prefix}.residual.weight"] = _t(rng, cout, cin, 1, 1)
        sd[f"{prefix}.residual.bias"] = _t(rng, cout)


def reference_unet(seed, depth=2, start=4, cin=3, nb_classes=2,
                   residual=False, bn=True, sigma=False) -> dict:
    """A reference U-Net state_dict of seeded arrays."""
    rng = np.random.RandomState(seed)
    sd = {}
    ch_in, ch = cin, start
    for i in range(depth):
        ref_block(sd, f"down_convs.{i}.block", ch_in, ch, rng, residual, bn)
        ch_in, ch = ch, ch * 2
    ref_block(sd, "bottom_convs", ch_in, ch, rng, residual, bn)
    for k in range(depth):
        sd[f"up_convs.{k}.upconv.1.weight"] = _t(rng, ch // 2, ch, 3, 3)
        sd[f"up_convs.{k}.upconv.1.bias"] = _t(rng, ch // 2)
        ref_block(sd, f"up_convs.{k}.block", ch, ch // 2, rng, residual, bn)
        ch //= 2
    ref_cbr(sd, "conv_cls.0", ch, ch, 3, rng, bn)
    sd["conv_cls.1.weight"] = _t(rng, nb_classes, ch, 1, 1)
    sd["conv_cls.1.bias"] = _t(rng, nb_classes)
    if sigma:
        ref_cbr(sd, "conv_sigma.0", ch, ch, 3, rng, bn)
        sd["conv_sigma.1.weight"] = _t(rng, nb_classes, ch, 1, 1)
        sd["conv_sigma.1.bias"] = _t(rng, nb_classes)
    return sd


def reference_postnet(seed, cin=4, nb_convs=2, nb_classes=2) -> dict:
    rng = np.random.RandomState(seed)
    sd = {}
    for j in range(nb_convs):
        ref_cbr(sd, f"convs.{j}", cin, cin, 1, rng)
    sd["conv_logits.weight"] = _t(rng, nb_classes, cin, 1, 1)
    sd["conv_logits.bias"] = _t(rng, nb_classes)
    return sd


def make_ref_dir(tmp_path, sd, model_type, params, epochs=((0, False),
                                                            (1, True)),
                 best_score=0.5, optimizer=("adam", {"lr": 1e-4})):
    ref = tmp_path / "model_ref"
    (ref / "checkpoints").mkdir(parents=True)
    doc = {"model": {"type": model_type, "params": params}}
    if optimizer:
        doc["optimizer"] = {"type": optimizer[0], "params": optimizer[1]}
    with open(ref / "model.json", "w") as f:
        json.dump(doc, f)
    for epoch, best in epochs:
        torch.save({"state_dict": sd, "epoch": epoch, "optimizer": {},
                    "best_score": best_score},
                   str(ref / "checkpoints" /
                       f"checkpoint_ep{epoch:03d}{'-best' if best else ''}"
                       ".pth"))
    return ref


def import_both(ref, tmp_path):
    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_written = jax_tool().import_model_dir(str(ref), jax_out)
    port_written = port_tool.import_model_dir(str(ref), port_out)
    assert [os.path.basename(p) for p in port_written] == \
        [os.path.basename(p) for p in jax_written]
    return jax_out, port_out, port_written


def assert_same_dirs(jax_out, port_out):
    """The same files; JSON bytes equal; each checkpoint restored by
    ``rcu_tpu`` to equal trees."""
    names = sorted(os.listdir(jax_out))
    assert names == sorted(os.listdir(port_out))
    for name in names:
        if name.endswith(".json"):
            with open(os.path.join(jax_out, name), "rb") as a, \
                    open(os.path.join(port_out, name), "rb") as b:
                assert a.read() == b.read(), name
    ckpts = sorted(os.listdir(os.path.join(jax_out, "checkpoints")))
    assert ckpts == sorted(os.listdir(os.path.join(port_out, "checkpoints")))
    for name in ckpts:
        want = jax_ckpt.load_checkpoint(os.path.join(jax_out, "checkpoints",
                                                     name))
        got = jax_ckpt.load_checkpoint(os.path.join(port_out, "checkpoints",
                                                    name))
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want), name
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert int(got["epoch"]) == int(want["epoch"])
    return ckpts


UNET_CASES = {
    "plain": ({}, {}),
    "sigma": ({"sigma": True}, {"sigma_out": True}),
    "residual": ({"residual": True}, {"residual": True}),
    "bn_free": ({"bn": False}, {"bn": False}),
    "residual_bn_free": ({"residual": True, "bn": False},
                         {"residual": True, "bn": False}),
}


@pytest.mark.parametrize("case", list(UNET_CASES))
def test_unet_import_equals_jax_importer(case, tmp_path):
    sd_kwargs, params = UNET_CASES[case]
    record = {**UNET, **params}
    ref = make_ref_dir(tmp_path, reference_unet(3, **sd_kwargs), "unet",
                       record)
    jax_out, port_out, written = import_both(ref, tmp_path)
    assert assert_same_dirs(jax_out, port_out) == \
        ["checkpoint_ep000.ckpt", "checkpoint_ep001-best.ckpt"]
    raw = jax_ckpt.load_checkpoint(written[-1])
    assert raw["opt_state"] is not None and float(raw["best_score"]) == 0.5
    if params.get("residual"):
        assert "ConvResidualBlock_0" in raw["params"]
    # the port's loader on the imported dir: flax's logits on its tree
    x = np.random.RandomState(4).rand(2, 16, 16, 3).astype(np.float32)
    want = flax_get_model("unet", record).apply(
        {"params": raw["params"], "batch_stats": raw["batch_stats"]}, x)
    model = load_model(port_out, "best", "cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(out.logits.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.logits), rtol=1e-3, atol=2e-4)
    if params.get("sigma_out"):
        np.testing.assert_allclose(out.sigma.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want.sigma), rtol=1e-3,
                                   atol=2e-4)


@pytest.mark.parametrize("optimizer", [("adam", {"lr": 1e-4}),
                                       ("sgd", {"lr": 1e-2, "momentum": 0.9}),
                                       None])
def test_postnet_import_equals_jax_importer(optimizer, tmp_path):
    ref = make_ref_dir(tmp_path, reference_postnet(5), "postnet", POSTNET,
                       epochs=((2, True),), optimizer=optimizer)
    jax_out, port_out, written = import_both(ref, tmp_path)
    assert_same_dirs(jax_out, port_out)
    raw = jax_ckpt.load_checkpoint(written[0])
    assert (raw["opt_state"] is None) == (optimizer is None)
    x = np.random.RandomState(6).rand(2, 8, 8, 4).astype(np.float32)
    want = flax_get_model("postnet", POSTNET).apply(
        {"params": raw["params"], "batch_stats": raw["batch_stats"]}, x)
    model = load_model(port_out, "best", "cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(got.logits.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want.logits), rtol=1e-3, atol=2e-4)


def test_postfixed_multi_model_dir(tmp_path):
    """``checkpoint-<postfix>_ep*.pth`` converts with its own
    model-<postfix>.json (an underscore in the postfix parses), whose
    record is carried over; a None best_score becomes -inf."""
    ref = make_ref_dir(tmp_path, reference_unet(7), "unet", UNET,
                       epochs=((0, False),))
    with open(ref / "model-post_net.json", "w") as f:
        json.dump({"model": {"type": "postnet", "params": POSTNET},
                   "optimizer": {"type": "adam", "params": {"lr": 1e-4}}}, f)
    torch.save({"state_dict": reference_postnet(8), "epoch": 0,
                "optimizer": {}, "best_score": None},
               str(ref / "checkpoints" / "checkpoint-post_net_ep000.pth"))
    jax_out, port_out, written = import_both(ref, tmp_path)
    assert sorted(os.path.basename(p) for p in written) == \
        ["checkpoint-post_net_ep000.ckpt", "checkpoint_ep000.ckpt"]
    assert_same_dirs(jax_out, port_out)
    raw = jax_ckpt.load_checkpoint(os.path.join(
        port_out, "checkpoints", "checkpoint-post_net_ep000.ckpt"))
    assert "ConvBnRelu_1" in raw["params"]
    assert np.isneginf(float(raw["best_score"]))


def test_numpy_scalar_payload_imports_like_python_numbers(tmp_path):
    """A best_score kept as ``np.float64`` and an epoch as ``np.int64`` load
    under ``weights_only`` (their pickle globals are allowlisted) and
    import as the Python numbers do."""
    sd = reference_unet(9)
    plain = make_ref_dir(tmp_path / "a", sd, "unet", UNET,
                         epochs=((4, True),), best_score=0.75)
    scalar = make_ref_dir(tmp_path / "b", sd, "unet", UNET, epochs=())
    torch.save({"state_dict": sd, "epoch": np.int64(4), "optimizer": {},
                "best_score": np.float64(0.75)},
               str(scalar / "checkpoints" / "checkpoint_ep004-best.pth"))
    port_tool.import_model_dir(str(plain), str(tmp_path / "plain"))
    port_tool.import_model_dir(str(scalar), str(tmp_path / "scalar"))
    assert_same_dirs(str(tmp_path / "plain"), str(tmp_path / "scalar"))


def test_other_payloads_are_refused(tmp_path):
    """A numpy array in the payload is no weight: the weights-only load
    refuses it, and nothing is written or retried."""
    ref = make_ref_dir(tmp_path, reference_unet(10), "unet", UNET, epochs=())
    torch.save({"state_dict": reference_unet(10), "epoch": 0,
                "best_score": np.array([0.5])},
               str(ref / "checkpoints" / "checkpoint_ep000.pth"))
    with pytest.raises(pickle.UnpicklingError, match="Weights only load"):
        port_tool.import_model_dir(str(ref), str(tmp_path / "out"))
    assert not os.path.exists(tmp_path / "out" / "checkpoints")


def test_errors_are_the_jax_scripts(tmp_path):
    ref = tmp_path / "model_ref"
    (ref / "checkpoints").mkdir(parents=True)
    with open(ref / "model.json", "w") as f:
        json.dump({"model": {"type": "resnet", "params": {}}}, f)
    for tool in (jax_tool(), port_tool):
        with pytest.raises(ValueError, match='cannot convert model type '
                                             '"resnet"'):
            tool.import_model_dir(str(ref), str(tmp_path / "out"))
    with open(ref / "model.json", "w") as f:
        json.dump({"model": {"type": "unet", "params": UNET}}, f)
    messages = []
    for tool in (jax_tool(), port_tool):
        with pytest.raises(FileNotFoundError) as err:
            tool.import_model_dir(str(ref), str(tmp_path / "out"))
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "no checkpoints matched" in \
        messages[0]
    torch.save({"state_dict": reference_postnet(1)},
               str(ref / "checkpoints" / "checkpoint-aux_ep000.pth"))
    messages = []
    for tool in (jax_tool(), port_tool):
        with pytest.raises(FileNotFoundError) as err:
            tool.import_model_dir(str(ref), str(tmp_path / "out"))
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "model-aux.json" in messages[0]


def test_cli_runs_as_a_module(tmp_path):
    ref = make_ref_dir(tmp_path, reference_unet(11, residual=True), "unet",
                       {**UNET, "residual": True}, epochs=((0, True),))
    out = subprocess.run(
        [sys.executable, "-m", "rcu_tpu_torch.cli.import_torch_checkpoint",
         "-ref_model_dir", str(ref), "-out_model_dir", str(tmp_path / "out")],
        cwd=REPO_ROOT, capture_output=True, text=True, check=True)
    assert "converted 1 checkpoint(s)" in out.stdout
    model = load_model(str(tmp_path / "out"), "best", "cpu")
    assert model.residual
