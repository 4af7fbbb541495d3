"""A device mesh in one process (``rcu_tpu.parallel.mesh`` counterpart).

The JAX package's mesh is single-controller: one process drives every
local device, and the same ``mesh=`` object goes to the direct eval, the
test loop, the eval passes, the service and the train loop. The port
keeps that design with an explicit device list: a :class:`Mesh` is a
tuple of ``torch.device`` laid row-major over its axis names,
``("data",)`` or ``("model", "data")``. Modules go one copy per device
(:func:`replicate`), a batch is split into contiguous parts over the
data axis (:func:`split_batch`, :class:`Split`), and per-device results
are added or joined on the mesh's first device.

A device may repeat: ``make_mesh(devices=["cuda:0"] * 2)`` is a virtual
mesh on one card, and ``make_mesh(n_devices=4, device="cpu")`` one on the
CPU (the counterpart of the JAX tests' forced host devices). A virtual
mesh runs every split, per-device launch and cross-device add, but its
entries share one device and one stream: it measures the split's
overhead, not scaling.

Training (:func:`shard_train_step`) keeps GSPMD's meaning, not DDP's: a
step on the mesh computes what one device computes on the whole batch.
Each data device runs its part of the batch in a thread of its own
(:func:`run_parts`) on a train-mode copy of the model
(:func:`train_replicas`); BatchNorm's sums meet in :func:`all_sum`, so
that every part normalizes with the whole batch's moments; the parts'
gradients are added in data-axis order on the first device
(:func:`reduce_gradients`), where the optimizer updates once. Several
hosts join through ``torch.distributed`` (:func:`initialize_distributed`):
a process is then a block of rows of one global batch, and the sums and
the gradients are also all-reduced across the processes.
"""
from __future__ import annotations

import contextlib
import copy
import threading
import typing
import weakref

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


# ------------------------------------------------------------------ training

def initialize_distributed(coordinator_address: str = None,
                           num_processes: int = None, process_id: int = None,
                           init_method: str = None, device="cuda"):
    """Several hosts: join this process to ``torch.distributed``'s group
    (the counterpart of ``jax.distributed.initialize``). Call it once per
    process before the first train step; a single host does not call it.
    ``coordinator_address`` (``host:port``) is the first process's TCP
    rendezvous, ``init_method`` any other (``file://...``); with neither,
    torch reads ``MASTER_ADDR`` and its siblings from the environment.
    The backend is ``nccl`` for cards and ``gloo`` for CPU tensors
    (``device``). Each host then feeds its own rows
    (``data.loader.SliceBatchLoader(shard=(process_id, num_processes))``)
    and a mesh of its local devices."""
    import torch.distributed as dist
    if coordinator_address is not None:
        if init_method is not None:
            raise ValueError("give coordinator_address or init_method, "
                             "not both")
        init_method = f"tcp://{coordinator_address}"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if num_processes is None
                            else num_processes,
                            rank=-1 if process_id is None else process_id)


def distributed() -> bool:
    """Whether this process belongs to an initialized process group."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def process_rows(n: int) -> tuple:
    """(first row, total rows) of this process's ``n`` rows in the global
    batch: the processes hold equal blocks in rank order."""
    if not distributed():
        return 0, n
    import torch.distributed as dist
    return dist.get_rank() * n, dist.get_world_size() * n


def all_reduce_sum(tensor):
    """The sum of ``tensor`` over the processes, differentiable (its
    backward is the same sum of the gradients); ``tensor`` itself outside
    a process group."""
    if not distributed():
        return tensor
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(tensor)


def shard_batch(batch: dict, mesh: Mesh) -> list:
    """Place a host batch on the mesh, split over the data axis: one dict
    a data device (:func:`split_batch`)."""
    return split_batch(batch, mesh)


class PartGroup:
    """The meeting point of one train step's parts, one thread each:
    :meth:`all_sum` adds every part's tensor in data-axis order on the
    first part's device (all-reduced across the processes where a process
    group is up) and hands each part the total on its device. The sum is
    an autograd op: each part's use of the total sends its gradient back
    to every part's tensor. A part that fails calls :meth:`abort`, which
    breaks the barrier that the others wait at."""

    def __init__(self, devices, distributed_sum: bool):
        self.devices = tuple(devices)
        self.distributed = distributed_sum
        self._slots = [None] * len(self.devices)
        self._total = None
        self._barrier = threading.Barrier(len(self.devices))

    def all_sum(self, index: int, tensor):
        self._slots[index] = tensor
        self._barrier.wait()  # every part's tensor is in
        if index == 0:  # always the first part's thread: a fixed order of
            # the collectives, so that every process makes them alike
            total = self._slots[0]
            for t in self._slots[1:]:
                total = total + t.to(total.device)
            self._total = all_reduce_sum(total) if self.distributed \
                else total
        self._barrier.wait()  # the total is out
        return self._total.to(self.devices[index])

    def abort(self):
        self._barrier.abort()


class Part(typing.NamedTuple):
    """A part of a train step's batch: its group, its index on the data
    axis and its rows ``(start, stop, total)`` of the global batch."""
    group: PartGroup
    index: int
    rows: tuple

    def global_count(self, n: int) -> int:
        """A per-channel count ``n`` over this part's rows, over the
        global batch's."""
        start, stop, total = self.rows
        return n * total // (stop - start)


_PART = threading.local()


def current_part():
    """The :class:`Part` this thread runs, None outside a mesh train
    step."""
    return getattr(_PART, "part", None)


def all_sum(tensor):
    """The sum of ``tensor`` over the parts of the train step this thread
    runs (and over the processes), on this part's device; ``tensor``
    itself outside a mesh train step."""
    part = current_part()
    return tensor if part is None else part.group.all_sum(part.index,
                                                          tensor)


def _device_context(device):
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def run_parts(fn, devices, rows, distributed_sum: bool = False) -> list:
    """``fn(i)`` for every part ``i``, each in a thread of its own (the
    first in the caller's) with its :class:`Part` current and its device
    the current one, as ``torch.nn.parallel.parallel_apply`` runs them;
    -> the results in part order. A part that raises breaks the group's
    barrier, so the others stop at their next :func:`all_sum`, and its
    exception is raised here."""
    group = PartGroup(devices, distributed_sum)
    results, errors = [None] * len(devices), [None] * len(devices)
    grad = torch.is_grad_enabled()

    def work(i):
        _PART.part = Part(group, i, rows[i])
        try:
            with torch.set_grad_enabled(grad), _device_context(devices[i]):
                results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            errors[i] = e
            group.abort()
        finally:
            _PART.part = None

    threads = [threading.Thread(target=work, args=(i,), daemon=True)
               for i in range(1, len(devices))]
    for t in threads:
        t.start()
    work(0)
    for t in threads:
        t.join()
    failed = [e for e in errors if e is not None]
    if failed:
        raise next((e for e in failed
                    if not isinstance(e, threading.BrokenBarrierError)),
                   failed[0])
    return results


class TrainReplicas:
    """Train-mode copies of a model for a train step's parts on
    ``devices``: called with the model (on ``devices[0]``), -> a list
    aligned with ``devices`` whose first entry is the model itself and
    every other a copy of its own, also where a device repeats, so that
    no two parts run through one module object (each copy updates its
    BatchNorm statistics once a step, from the global moments). The
    copies are kept between steps and take the model's parameters and
    buffers at each call: after every update, and after a checkpoint
    load."""

    def __init__(self, devices):
        self.devices = [canonical_device(d) for d in devices]
        self._copies = weakref.WeakKeyDictionary()

    def __call__(self, model) -> list:
        home = canonical_device(next(model.parameters()).device)
        if self.devices[0] != home:
            raise ValueError(f"the model is on {home}, but the mesh's "
                             f"first data device is {self.devices[0]}")
        copies = self._copies.get(model)
        if copies is None:
            copies = []
            for d in self.devices[1:]:
                replica = copy.deepcopy(model).to(d)
                for p in replica.parameters():
                    p.grad = None
                copies.append(replica)
            self._copies[model] = copies
        with torch.no_grad():
            for replica in copies:
                for dst, src in zip(replica.parameters(),
                                    model.parameters()):
                    dst.copy_(src, non_blocking=True)
                for dst, src in zip(replica.buffers(), model.buffers()):
                    dst.copy_(src, non_blocking=True)
        return [model.train()] + [c.train() for c in copies]


def reduce_gradients(replicas, distributed_sum: bool = False):
    """Add each replica's gradients into the first's, in data-axis order
    on its device (a parameter no part reached keeps no gradient), then
    all-reduce them across the processes where a process group is up;
    the other replicas' gradients are dropped."""
    home = replicas[0]
    named = [list(r.parameters()) for r in replicas]
    for k, p in enumerate(named[0]):
        grads = [ps[k].grad for ps in named]
        if all(g is None for g in grads):
            continue
        total = None
        for g in grads:
            if g is None:
                continue
            g = g.to(p.device)
            total = g if total is None else total + g
        p.grad = total
        for ps in named[1:]:
            ps[k].grad = None
    if distributed_sum:
        import torch.distributed as dist
        params = [p for p in home.parameters()]
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros_like(p)).reshape(-1)
                          for p in params])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()


def shard_train_step(train_step, mesh: Mesh):
    """A train step of ``engine.steps`` (``make_*train_step()``) on the
    mesh's data axis, with the single step's signature ``(state, batch,
    generator[, noise]) -> metrics`` (``engine.steps.MeshTrainStep``):
    it computes what the single step computes on the whole batch."""
    from rcu_tpu_torch.engine.steps import MeshTrainStep, TrainStep
    if not isinstance(train_step, TrainStep):
        raise TypeError("shard_train_step takes a step of "
                        "engine.steps.make_*train_step, not "
                        f"{type(train_step).__name__}")
    return MeshTrainStep(train_step, mesh)
