"""Import a reference model dir (the PyTorch implementation this project
was modelled on) as a model dir of the flax schema
(``scripts/import_torch_checkpoint.py`` counterpart; same flags, file
names and errors).

  python -m rcu_tpu_torch.cli.import_torch_checkpoint \
      -ref_model_dir <.../model_xxx> -out_model_dir <.../model_xxx_imported>

Every ``checkpoints/checkpoint[-<postfix>]_ep###[-best].pth`` becomes a
``checkpoint[-<postfix>]_ep###[-best].ckpt`` (``engine.checkpoint``'s
msgpack, which ``eval.direct.load_model``, the train loop's resume and the
JAX package all read), and ``model.json`` (and each postfix's
``model-<postfix>.json``) is carried over. The reference's module paths
map onto the flax tree: ``down_convs.i.block`` / ``bottom_convs`` /
``up_convs.k.block`` -> ``ConvBlock_j`` (``ConvResidualBlock_j`` where the
block has a ``residual`` 1x1, flax's ``Conv_0``), ``up_convs.k.upconv.1``
-> ``Conv_k``, ``conv_cls`` / ``conv_sigma`` -> the heads, a PostNet's
``convs.j`` / ``conv_logits`` -> ``ConvBnRelu_j`` / ``Conv_0``; conv
kernels OIHW -> HWIO, BatchNorm weight / bias / running statistics ->
scale / bias / mean / var (a Conv2dBnRelu without ``bn``: a BN-free
site).

The reference's Adam moments do not map onto optax's; each checkpoint
gets the optimizer's fresh state instead (``models.optim``), so an
imported run resumes with cold moments. ``best_score`` absent or None
becomes -inf, the train loop's "no best yet".

Payloads load with ``torch.load(weights_only=True)``: tensors, containers
and Python numbers, and numpy scalars (a ``best_score`` or ``epoch`` kept
as ``np.float64`` or ``np.int64``), whose pickle globals (the scalar's
reconstructor and its dtype) are allowlisted. Anything else (a numpy
array, a pickled object) is refused with torch's error; nothing retries
without ``weights_only``.
"""
import argparse
import glob
import json
import os
import re

import numpy as np

from rcu_tpu_torch.engine import checkpoint as ckpt_lib
from rcu_tpu_torch.engine.config import ParametricNode


def _np(tensor):
    return np.asarray(tensor.detach().cpu().numpy() if hasattr(tensor, "detach")
                      else tensor)


def _conv(sd, prefix):
    # Conv2d OIHW -> flax HWIO
    return {"kernel": _np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0),
            "bias": _np(sd[f"{prefix}.bias"])}


def _cbr(sd, prefix):
    """A reference Conv2dBnRelu -> flax ConvBnRelu (params, batch_stats)."""
    params = {"Conv_0": _conv(sd, f"{prefix}.conv2d_batch_relu.conv")}
    stats = {}
    bn = f"{prefix}.conv2d_batch_relu.bn"
    if f"{bn}.weight" in sd:
        params["BatchNorm_0"] = {"scale": _np(sd[f"{bn}.weight"]),
                                 "bias": _np(sd[f"{bn}.bias"])}
        stats["BatchNorm_0"] = {"mean": _np(sd[f"{bn}.running_mean"]),
                                "var": _np(sd[f"{bn}.running_var"])}
    return params, stats


def _block(sd, prefix):
    """A reference ConvBlock or ConvResidualBlock -> (flax class name,
    params, batch_stats); a residual block's ``<prefix>.residual`` 1x1 is
    flax's ``Conv_0``."""
    params, stats = {}, {}
    name = "ConvBlock"
    if f"{prefix}.residual.weight" in sd:
        name = "ConvResidualBlock"
        params["Conv_0"] = _conv(sd, f"{prefix}.residual")
    j = 0
    while f"{prefix}.block.{j}.conv2d_batch_relu.conv.weight" in sd:
        p, s = _cbr(sd, f"{prefix}.block.{j}")
        params[f"ConvBnRelu_{j}"] = p
        if s:
            stats[f"ConvBnRelu_{j}"] = s
        j += 1
    if j == 0:
        raise ValueError(f"no Conv2dBnRelu children under '{prefix}.block' — "
                         "not a reference ConvBlock state_dict")
    return name, params, stats


def unet_state_dict_to_trees(sd):
    """A reference U-Net state_dict -> (params, batch_stats) flax trees,
    from the keys alone."""
    params, stats = {}, {}
    counters = {}

    def add_block(prefix):
        name, p, s = _block(sd, prefix)
        n = counters.get(name, 0)
        counters[name] = n + 1
        params[f"{name}_{n}"] = p
        stats[f"{name}_{n}"] = s

    i = 0
    while f"down_convs.{i}.block.block.0.conv2d_batch_relu.conv.weight" in sd:
        add_block(f"down_convs.{i}.block")
        i += 1
    add_block("bottom_convs")
    k = 0
    while f"up_convs.{k}.upconv.1.weight" in sd:
        params[f"Conv_{k}"] = _conv(sd, f"up_convs.{k}.upconv.1")
        add_block(f"up_convs.{k}.block")
        k += 1
    depth = k  # the class conv takes the index after the k up-convs
    p, s = _cbr(sd, "conv_cls.0")
    params["ConvBnRelu_0"] = p
    stats["ConvBnRelu_0"] = s
    params[f"Conv_{depth}"] = _conv(sd, "conv_cls.1")
    if "conv_sigma.0.conv2d_batch_relu.conv.weight" in sd:
        p, s = _cbr(sd, "conv_sigma.0")
        params["ConvBnRelu_1"] = p
        stats["ConvBnRelu_1"] = s
        params[f"Conv_{depth + 1}"] = _conv(sd, "conv_sigma.1")
    return params, stats


def postnet_state_dict_to_trees(sd):
    """A reference PostNet state_dict -> (params, batch_stats) flax trees."""
    params, stats = {}, {}
    j = 0
    while f"convs.{j}.conv2d_batch_relu.conv.weight" in sd:
        p, s = _cbr(sd, f"convs.{j}")
        params[f"ConvBnRelu_{j}"] = p
        if s:
            stats[f"ConvBnRelu_{j}"] = s
        j += 1
    params["Conv_0"] = _conv(sd, "conv_logits")
    return params, stats


_CONVERTERS = {"unet": unet_state_dict_to_trees,
               "postnet": postnet_state_dict_to_trees}

# the reference's checkpoint[-postfix]_ep###[-best].pth
_CKPT_RE = re.compile(
    r"checkpoint(?:-(?P<postfix>.+?))?_ep(?P<epoch>\d+)(?P<best>-best)?\.pth$")


def _load_model_doc(ref_model_dir: str, postfix: str) -> dict:
    """model.json of the main model, model-<postfix>.json of another model
    of a multi-model run."""
    name = f"model-{postfix}.json" if postfix else "model.json"
    path = os.path.join(ref_model_dir, name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"checkpoint postfix '{postfix}' has no matching {name} in "
            f"{ref_model_dir} — cannot determine its architecture")
    with open(path) as f:
        return json.load(f)


def _converter_for(doc: dict):
    model_type = doc["model"]["type"]
    if model_type not in _CONVERTERS:
        raise ValueError(f'cannot convert model type "{model_type}" '
                         f"(supported: {sorted(_CONVERTERS)})")
    return _CONVERTERS[model_type]


def _numpy_scalar_globals() -> list:
    """The pickle globals of a numpy scalar: its reconstructor (under the
    module name of numpy 1 as well, which pickled it as
    ``numpy.core.multiarray.scalar``) and dtypes."""
    core = np._core if hasattr(np, "_core") else np.core
    return [core.multiarray.scalar,
            (core.multiarray.scalar, "numpy.core.multiarray.scalar"),
            np.dtype] + [
        type(np.dtype(name)) for name in
        ("float64", "float32", "float16", "int64", "int32", "int16", "int8",
         "uint8", "bool")]


def load_payload(path: str) -> dict:
    """A reference checkpoint's payload, weights only (see the module
    doc)."""
    import torch
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def _fresh_opt_state(doc: dict, params: dict) -> dict:
    """The optimizer's initial state in optax's checkpoint layout, for the
    flax tree ``params``."""
    from rcu_tpu_torch.models import get_optimizer
    from rcu_tpu_torch.models.convert import state_dict_from_flax
    optimizer = get_optimizer(doc["type"], doc.get("params", {}))
    named = state_dict_from_flax(params, {})
    return optimizer.to_flax(optimizer.init(named), named)


def import_model_dir(ref_model_dir: str, out_model_dir: str) -> list:
    """Convert model.json(s) and every checkpoint; -> the written paths. A
    postfixed checkpoint (a multi-model run) converts with the
    architecture of its own model-<postfix>.json."""
    main_doc = _load_model_doc(ref_model_dir, "")
    _converter_for(main_doc)  # the main type is checked first

    out_files = ckpt_lib.ModelFiles.from_model_dir(out_model_dir)
    ckpt_lib.backup_model_parameters(
        out_files,
        ParametricNode(main_doc["model"]["type"],
                       main_doc["model"].get("params", {})),
        ParametricNode(main_doc["optimizer"]["type"],
                       main_doc["optimizer"].get("params", {}))
        if main_doc.get("optimizer") else None)

    written = []
    docs = {"": main_doc}
    pattern = os.path.join(ref_model_dir, "checkpoints", "checkpoint*.pth")
    for path in sorted(glob.glob(pattern)):
        m = _CKPT_RE.search(os.path.basename(path))
        if not m:
            print(f"skipping unrecognized checkpoint name: {path}")
            continue
        postfix = m["postfix"] or ""
        if postfix not in docs:
            docs[postfix] = _load_model_doc(ref_model_dir, postfix)
            # the other model's architecture record, so that the imported
            # dir stands alone
            with open(os.path.join(out_model_dir,
                                   f"model-{postfix}.json"), "w") as f:
                json.dump({"model": docs[postfix]["model"],
                           "optimizer": docs[postfix].get("optimizer")},
                          f, indent=2)
        doc = docs[postfix]
        convert = _converter_for(doc)
        payload = load_payload(path)
        params, batch_stats = convert(payload["state_dict"])
        opt_state = _fresh_opt_state(doc["optimizer"], params) \
            if doc.get("optimizer") else None
        best_score = payload.get("best_score")  # None before a validation
        state = {"params": params, "batch_stats": batch_stats,
                 "opt_state": opt_state,
                 "epoch": np.int32(payload.get("epoch", int(m["epoch"]))),
                 # -inf is the train loop's "no best yet"; 0.0 would beat
                 # a first validation scoring exactly 0
                 "best_score": np.float32(
                     -np.inf if best_score is None else best_score)}
        written.append(ckpt_lib.save_checkpoint(
            out_files, state, int(m["epoch"]), best=bool(m["best"]),
            postfix=postfix))
    if not written:
        raise FileNotFoundError(f"no checkpoints matched {pattern}")
    return written


def main():
    parser = argparse.ArgumentParser(
        description="Import a reference (torch) model dir as a flax-schema "
                    "model dir")
    parser.add_argument("-ref_model_dir", type=str, required=True,
                        help="reference model_<id> dir (model.json + "
                             "checkpoints/)")
    parser.add_argument("-out_model_dir", type=str, required=True,
                        help="destination model dir")
    args = parser.parse_args()
    written = import_model_dir(args.ref_model_dir, args.out_model_dir)
    for path in written:
        print(f"wrote {path}")
    print(f"converted {len(written)} checkpoint(s); point test configs' "
          f"model_dir at {args.out_model_dir}")


def cli():
    main()


if __name__ == "__main__":
    cli()
