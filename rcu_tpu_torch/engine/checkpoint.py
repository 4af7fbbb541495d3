"""Read side of ``rcu_tpu``'s checkpoint directories.

Layout::

    <model_dir>/model.json                         # arch + optimizer record
    <model_dir>/checkpoints/checkpoint_ep{:03d}.ckpt
    <model_dir>/checkpoints/checkpoint_ep{:03d}-best.ckpt
    <model_dir>/checkpoints/checkpoint-<postfix>_ep{:03d}.ckpt

The payload is flax's msgpack of ``{params, batch_stats, opt_state, epoch,
best_score}``. :func:`load_checkpoint` decodes it with ``msgpack`` alone: an
ndarray is ExtType 1 (a scalar ExtType 3) holding the msgpack tuple
``(shape, dtype name, C-order bytes)``, and an array above flax's chunk size
is a dict ``{"__msgpack_chunked_array__": True, "shape": ..., "chunks": ...}``
whose tuples are dicts keyed ``"0", "1", ...``.
"""
from __future__ import annotations

import glob
import json
import os
import re

import numpy as np

from rcu_tpu_torch.engine.config import ParametricNode

CHECKPOINT_PLACEHOLDER = "checkpoint{postfix}_ep{epoch:03d}{best}.ckpt"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_EPOCH_RE = re.compile(r"_ep(\d+)(-best)?\.ckpt$")


class ModelFiles:
    """Path schema around one model dir."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "ModelFiles":
        return cls(model_dir)

    @property
    def weight_checkpoint_dir(self) -> str:
        return os.path.join(self.model_dir, "checkpoints")

    def model_path_for(self, postfix: str = "") -> str:
        name = f"model-{postfix}.json" if postfix else "model.json"
        return os.path.join(self.model_dir, name)

    def build_checkpoint_path(self, epoch: int, best: bool = False,
                              postfix: str = "") -> str:
        name = CHECKPOINT_PLACEHOLDER.format(
            postfix=f"-{postfix}" if postfix else "", epoch=epoch,
            best="-best" if best else "")
        return os.path.join(self.weight_checkpoint_dir, name)


def load_model_parameters(model_files: ModelFiles, postfix: str = ""):
    """-> (model node, optimizer node or None) from model.json."""
    with open(model_files.model_path_for(postfix), "r") as f:
        d = json.load(f)
    model = ParametricNode(d["model"]["type"], d["model"]["params"])
    optimizer = None
    if d.get("optimizer"):
        optimizer = ParametricNode(d["optimizer"]["type"], d["optimizer"]["params"])
    return model, optimizer


def _checkpoint_epochs(model_files: ModelFiles, postfix: str, best: bool):
    prefix = f"checkpoint-{postfix}_" if postfix else "checkpoint_"
    epochs = []
    for path in glob.glob(os.path.join(model_files.weight_checkpoint_dir,
                                       prefix + "ep*.ckpt")):
        m = _EPOCH_RE.search(path)
        if m and bool(m.group(2)) == best:
            epochs.append(int(m.group(1)))
    return sorted(epochs)


def find_checkpoint_file(model_files: ModelFiles, at, postfix: str = ""):
    """``at``: 'best' | 'last' | int epoch -> existing checkpoint path or None.

    'best' takes the highest epoch among several ``-best`` files (a crash
    between saving a new best and deleting the old one leaves two)."""
    if at in ("best", "last"):
        epochs = _checkpoint_epochs(model_files, postfix, best=at == "best")
        if not epochs:
            return None
        return model_files.build_checkpoint_path(epochs[-1], best=at == "best",
                                                 postfix=postfix)
    path = model_files.build_checkpoint_path(int(at), best=False, postfix=postfix)
    return path if os.path.exists(path) else None


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        raise NotImplementedError("bfloat16 checkpoint leaves are not ported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())) \
        .reshape(shape, order="C").copy()


def _ext_hook(code, data):
    import msgpack
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = tree["chunks"]
        flat = np.concatenate([chunks[str(i)] for i in range(len(chunks))])
        return flat.reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def load_checkpoint(path: str) -> dict:
    """Decode a checkpoint into nested dicts of numpy arrays."""
    import msgpack
    with open(path, "rb") as f:
        raw = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    return _unchunk(raw)
