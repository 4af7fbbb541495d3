"""A device mesh in one process (``rcu_tpu.parallel.mesh`` counterpart,
inference side).

The JAX package's mesh is single-controller: one process drives every
local device, and the same ``mesh=`` object goes to the direct eval, the
test loop, the eval passes and the service. The port keeps that design
with an explicit device list: a :class:`Mesh` is a tuple of
``torch.device`` laid row-major over its axis names, ``("data",)`` or
``("model", "data")``. Modules go one copy per device (:func:`replicate`),
a batch is split into contiguous parts over the data axis
(:func:`split_batch`, :class:`Split`), and per-device results are added
or joined on the mesh's first device.

A device may repeat: ``make_mesh(devices=["cuda:0"] * 2)`` is a virtual
mesh on one card, and ``make_mesh(n_devices=4, device="cpu")`` one on the
CPU (the counterpart of the JAX tests' forced host devices). A virtual
mesh runs every split, per-device launch and cross-device add, but its
entries share one device and one stream: it measures the split's
overhead, not scaling. ``torch.distributed`` is left for several hosts.
"""
from __future__ import annotations

import copy
import typing

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


def canonical_device(device) -> torch.device:
    """``device`` with its index: ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """``devices`` (a tuple of ``torch.device``, row-major over
    ``axis_names``) and ``shape`` (axis name -> size, in axis order)."""

    def __init__(self, devices, axis_names=(DATA_AXIS,), shape=None):
        self.devices = tuple(canonical_device(d) for d in devices)
        self.axis_names = tuple(axis_names)
        shape = tuple(shape) if shape is not None else (len(self.devices),)
        if len(shape) != len(self.axis_names) \
                or int(np.prod(shape)) != len(self.devices):
            raise ValueError(f"mesh shape {shape} over {self.axis_names} "
                             f"does not hold {len(self.devices)} devices")
        self.shape = dict(zip(self.axis_names, shape))

    @property
    def size(self) -> int:
        return len(self.devices)

    def rows(self) -> list:
        """The devices of each model-axis row (one row on a 1-D mesh)."""
        width = self.shape.get(DATA_AXIS, self.size)
        return [self.devices[r:r + width] for r in range(0, self.size, width)]

    @property
    def data_devices(self) -> tuple:
        """The data axis of the first row: where a batch's parts go and
        where the results stay."""
        return self.rows()[0]

    def __repr__(self):
        return (f"Mesh({', '.join(map(str, self.devices))}; "
                f"{self.shape})")


def _check_cuda(devices):
    count = torch.cuda.device_count()
    for d in devices:
        if d.type == "cuda" and not (d.index or 0) < count:
            raise ValueError(f"mesh device {d} does not exist: "
                             f"{count} cuda device(s) are available")


def make_mesh(devices=None, n_devices: int = None, device="cuda") -> Mesh:
    """A 1-D data mesh.

    ``devices`` names the devices (and may repeat one: a virtual mesh);
    by default ``device="cuda"`` takes ``cuda:0..N-1`` (every card, or
    ``n_devices`` of them) and ``device="cpu"`` ``n_devices`` entries of
    the CPU. Asking for more devices than there are raises; a mesh is
    never silently shorter than asked."""
    if devices is None:
        kind = torch.device(device).type
        if kind == "cpu":
            devices = [torch.device("cpu")] * (n_devices or 1)
        elif kind == "cuda":
            available = torch.cuda.device_count()
            n = available if n_devices is None else n_devices
            if n > available or n < 1:
                raise ValueError(
                    f"requested a {n}-device mesh but only {available} "
                    "cuda device(s) are available (for a virtual mesh on "
                    "one card pass devices=['cuda:0'] * N; for a CPU mesh "
                    "device='cpu')")
            devices = [torch.device("cuda", i) for i in range(n)]
        else:
            raise ValueError(f"make_mesh takes cuda or cpu, not {device}")
    else:
        devices = [canonical_device(d) for d in devices]
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"requested a {n_devices}-device mesh but "
                                 f"only {len(devices)} device(s) were given")
            devices = devices[:n_devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    _check_cuda(devices)
    return Mesh(devices)


def pad_batch_size_to_mesh(batch_size: int, mesh: Mesh) -> int:
    """Round ``batch_size`` up to the mesh's data-axis extent (the model
    axis of a 2-D mesh does not split batches)."""
    n = mesh.shape.get(DATA_AXIS, mesh.size)
    return -(-batch_size // n) * n


def split_bounds(n: int, parts: int) -> list:
    """``torch.tensor_split``'s (start, stop) of ``n`` rows in ``parts``
    contiguous parts: the first ``n % parts`` one row longer."""
    q, r = divmod(n, parts)
    bounds, start = [], 0
    for i in range(parts):
        stop = start + q + (i < r)
        bounds.append((start, stop))
        start = stop
    return bounds


def split_batch(batch: dict, mesh: Mesh) -> list:
    """One dict per data-axis device, on that device: every tensor's
    leading axis split into contiguous parts (equal where the batch was
    padded to the mesh). The copies do not block."""
    devices = mesh.data_devices
    n = len(next(iter(batch.values())))
    return [{k: v[a:b].to(d, non_blocking=True) for k, v in batch.items()}
            for d, (a, b) in zip(devices, split_bounds(n, len(devices)))]


def mesh_predict(fn, mesh):
    """``predict(model, batch[, rng])`` of ``fn(model, batch, rows[,
    rng])``. Without a mesh ``rows`` is None. With a ``mesh``, ``model``
    is one entry per data device (its replica, or its ensemble column):
    the batch splits over them (:func:`split_batch`), each part runs on
    its device with ``rows=(start, stop, total)``, and the parts' entries
    are joined in batch order on the first device."""
    if mesh is None:
        return lambda model, batch, *rng: fn(model, batch, None, *rng)
    home = mesh.data_devices[0]

    def predict_fn(models, batch, *rng):
        n = len(batch["images"])
        bounds = split_bounds(n, len(mesh.data_devices))
        outs = [fn(model, part, (a, b, n), *rng) for model, part, (a, b)
                in zip(models, split_batch(batch, mesh), bounds) if b > a]
        return {k: torch.cat([o[k].to(home) for o in outs]) for k in outs[0]}
    return predict_fn


def replicate(module, devices) -> list:
    """One eval-mode copy of ``module`` per distinct device of ``devices``,
    as a list aligned with ``devices`` (a repeated device shares its
    copy; the module's own device keeps the module). Buffers outside the
    state_dict (the int8 weights) and the precast weights come along."""
    home = next(module.parameters()).device
    copies, out = {}, []
    for d in map(canonical_device, devices):
        if d not in copies:
            copies[d] = module if d == canonical_device(home) \
                else copy.deepcopy(module).to(d)
            copies[d].eval()
        out.append(copies[d])
    return out


def _merged(ranges):
    out = []
    for a, b in ranges:
        if b <= a:
            continue
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return tuple(out)


class Split:
    """How ``n`` rows, run ``batch_size`` a batch, lie on ``devices``:
    each batch's rows split into contiguous parts, one per device
    (:func:`split_bounds`). ``batches[b]`` is ``(lo, hi, parts)`` with
    ``parts[d]`` the absolute (start, stop) of device ``d``; ``ranges[d]``
    every row range device ``d`` holds, merged, in order."""

    def __init__(self, n: int, batch_size: int, devices):
        self.devices = tuple(devices)
        self.n = n
        self.batches = []
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            self.batches.append((lo, hi, [
                (lo + a, lo + b)
                for a, b in split_bounds(hi - lo, len(self.devices))]))
        self.ranges = [_merged(parts[d] for _, _, parts in self.batches)
                       for d in range(len(self.devices))]

    def take(self, x, d):
        """Device ``d``'s rows of ``x`` (a tensor on any device), on that
        device; None where it holds none."""
        ranges = self.ranges[d]
        if not ranges:
            return None
        device = self.devices[d]
        pieces = [x[a:b].to(device, non_blocking=True) for a, b in ranges]
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces)

    def shards(self, x) -> list:
        """:meth:`take` of every device (None for every device where ``x``
        is None)."""
        return [None if x is None else self.take(x, d)
                for d in range(len(self.devices))]

    def joined(self, parts):
        """``parts`` (per device: its rows' tensor, or None) as one value:
        the tensor itself where one device holds every row in order, else
        a :class:`Sharded` that ``eval.device.Fetch`` joins on the host."""
        if len(self.devices) == 1:
            return parts[0]
        return Sharded(tuple(parts), tuple(self.ranges), self.n)


class Sharded(typing.NamedTuple):
    """A per-row map held on several devices: ``parts[d]`` the rows
    ``ranges[d]`` of a map of ``rows`` rows. ``eval.device.Fetch`` copies
    each device's part to the host once and joins them in row order."""
    parts: tuple
    ranges: tuple
    rows: int

    def join(self, host_parts) -> np.ndarray:
        """The host parts (numpy, per device, None where empty) in row
        order."""
        first = next(p for p in host_parts if p is not None)
        out = np.empty((self.rows,) + first.shape[1:], first.dtype)
        for part, ranges in zip(host_parts, self.ranges):
            offset = 0
            for a, b in ranges:
                out[a:b] = part[offset:offset + b - a]
                offset += b - a
        return out
