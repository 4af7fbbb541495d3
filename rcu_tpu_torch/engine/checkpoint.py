"""``rcu_tpu``'s checkpoint directories, read and written.

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
whose tuples are dicts keyed ``"0", "1", ...``. :func:`save_checkpoint`
writes that encoding (flax's ``msgpack_serialize``): the JAX package's
``load_checkpoint`` restores a port checkpoint, and the port resumes from
a JAX one.
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
_MAX_CHUNK_SIZE = 2 ** 30  # bytes; flax chunks larger arrays
_EPOCH_RE = re.compile(r"_ep(\d+)(-best)?\.ckpt$")


class ModelFiles:
    """Path schema around one model dir."""

    def __init__(self, model_dir: str):
        self.model_dir = model_dir

    @classmethod
    def from_model_dir(cls, model_dir: str) -> "ModelFiles":
        return cls(model_dir)

    @classmethod
    def create(cls, train_run_dir: str, run_id: str) -> "ModelFiles":
        return cls(os.path.join(train_run_dir, f"model_{run_id}"))

    @property
    def weight_checkpoint_dir(self) -> str:
        return os.path.join(self.model_dir, "checkpoints")

    @property
    def model_path(self) -> str:
        return self.model_path_for()

    def model_path_for(self, postfix: str = "") -> str:
        name = f"model-{postfix}.json" if postfix else "model.json"
        return os.path.join(self.model_dir, name)

    def build_checkpoint_path(self, epoch: int, best: bool = False,
                              postfix: str = "") -> str:
        name = CHECKPOINT_PLACEHOLDER.format(
            postfix=f"-{postfix}" if postfix else "", epoch=epoch,
            best="-best" if best else "")
        return os.path.join(self.weight_checkpoint_dir, name)


def backup_model_parameters(model_files: ModelFiles, model_node, optimizer_node):
    """Write model.json once: a resumed run with an edited config keeps the
    record of the architecture it was started with."""
    os.makedirs(model_files.model_dir, exist_ok=True)
    if os.path.exists(model_files.model_path):
        return
    with open(model_files.model_path, "w") as f:
        json.dump({"model": {"type": model_node.type,
                             "params": model_node.params},
                   "optimizer": {"type": optimizer_node.type,
                                 "params": optimizer_node.params}
                   if optimizer_node is not None else None}, f, indent=2)


def load_model_parameters(model_files: ModelFiles, postfix: str = ""):
    """-> (model node, optimizer node or None) from model.json."""
    with open(model_files.model_path_for(postfix), "r") as f:
        d = json.load(f)
    model = ParametricNode(d["model"]["type"], d["model"]["params"])
    optimizer = None
    if d.get("optimizer"):
        optimizer = ParametricNode(d["optimizer"]["type"], d["optimizer"]["params"])
    return model, optimizer


def find_checkpoint_files(model_files: ModelFiles, postfix: str = ""):
    prefix = f"checkpoint-{postfix}_" if postfix else "checkpoint_"
    return sorted(glob.glob(os.path.join(model_files.weight_checkpoint_dir,
                                         prefix + "ep*.ckpt")))


def _checkpoint_epochs(model_files: ModelFiles, postfix: str, best: bool):
    epochs = []
    for path in find_checkpoint_files(model_files, postfix):
        m = _EPOCH_RE.search(path)
        if m and bool(m.group(2)) == best:
            epochs.append(int(m.group(1)))
    return sorted(epochs)


def find_epoch_checkpoints(model_files: ModelFiles, postfix: str = ""):
    """Sorted epochs with a plain (not -best) checkpoint on disk."""
    return _checkpoint_epochs(model_files, postfix, best=False)


def find_last_checkpoint_epoch(model_files: ModelFiles, postfix: str = ""):
    epochs = find_epoch_checkpoints(model_files, postfix)
    return epochs[-1] if epochs else None


def find_best_checkpoint_epoch(model_files: ModelFiles, postfix: str = ""):
    """The -best checkpoint's epoch; the highest where a crash between
    saving a new best and deleting the old one left two."""
    epochs = _checkpoint_epochs(model_files, postfix, best=True)
    return epochs[-1] if epochs else None


def find_checkpoint_file(model_files: ModelFiles, at, postfix: str = ""):
    """``at``: 'best' | 'last' | int epoch -> existing checkpoint path or
    None."""
    if at in ("best", "last"):
        epoch = find_best_checkpoint_epoch(model_files, postfix) \
            if at == "best" else find_last_checkpoint_epoch(model_files,
                                                            postfix)
        if epoch is None:
            return None
        return model_files.build_checkpoint_path(epoch, best=at == "best",
                                                 postfix=postfix)
    path = model_files.build_checkpoint_path(int(at), best=False, postfix=postfix)
    return path if os.path.exists(path) else None


def delete_checkpoint(model_files: ModelFiles, epoch: int, best: bool = False,
                      postfix: str = ""):
    path = model_files.build_checkpoint_path(epoch, best, postfix)
    if os.path.exists(path):
        os.remove(path)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    import msgpack
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")),
                         use_bin_type=True)


def _ext_pack(x):
    import msgpack
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _ndarray_to_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
    return x


def _chunked(tree):
    """A copy of ``tree`` with its dict keys sorted (flax writes a pytree,
    whose dicts jax sorts), its arrays above flax's chunk size as chunk
    dicts, and tuples and lists as ``{"0": ..., "1": ...}``, as flax's
    state dicts hold them."""
    if isinstance(tree, dict):
        return {str(k): _chunked(tree[k]) for k in sorted(tree, key=str)}
    if isinstance(tree, (tuple, list)):
        return {str(i): _chunked(v) for i, v in enumerate(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > _MAX_CHUNK_SIZE:
        size = max(1, _MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): n for i, n in enumerate(tree.shape)},
                "chunks": {str(i): flat[k:k + size] for i, k in
                           enumerate(range(0, flat.size, size))}}
    return tree


def save_checkpoint(model_files: ModelFiles, state: dict, epoch: int,
                    best: bool = False, postfix: str = "") -> str:
    """Write ``state`` (nested dicts of numpy arrays, numpy scalars and
    Python numbers: ``{params, batch_stats, opt_state, epoch,
    best_score}``) in flax's msgpack encoding; a temporary file renamed
    into place, so that a crash never leaves a truncated checkpoint."""
    import msgpack
    os.makedirs(model_files.weight_checkpoint_dir, exist_ok=True)
    path = model_files.build_checkpoint_path(epoch, best, postfix)
    tmp_path = path + ".tmp"
    with open(tmp_path, "wb") as f:
        f.write(msgpack.packb(_chunked(state), default=_ext_pack,
                              strict_types=True))
    os.replace(tmp_path, path)
    return path


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
