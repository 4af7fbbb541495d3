"""Host batch loader with static shapes, and the read-ahead feed to the card
(``rcu_tpu.data.loader`` counterparts).

- :class:`SliceBatchLoader` yields dicts of numpy arrays, the batches of
  the JAX package's loader for the same dataset, indices, seed and epoch:
  the epoch order is ``np.random.RandomState(seed + epoch)``, uniform or
  in chunks (``shuffle_chunk``), and with ``shard=(host, n)`` this host's
  rows of it (a stride, or whole chunks); the ragged last batch is padded to
  ``batch_size`` by repeating its last item and carries ``valid`` (1 for a
  real item), ``subject_index`` and ``slice_index``. Items are read row by
  row (the JAX package's ranged HDF5 reads give the same arrays); with
  ``num_workers`` > 1 a thread pool reads a batch's items, in order.
- :func:`prefetch` reads ahead on a thread, which stacks a batch into
  torch tensors pinned for the card; the consuming thread copies each
  batch to the device without blocking, and keeps the host batches of the
  copies in flight alive. It is not the direct eval's ``_drive`` and
  ``_Reader``: ``_drive`` walks a list of items and calls back to dispatch
  each item's device work and later to fetch its results in order, and
  ``_Reader`` decodes, transforms and masks whole subjects. A train loop
  pulls batches that this loader has already assembled, from an iterator,
  and each is done when its step is queued, so a generator over the
  iterator fits it. The two share the rules, not code: pin on the reader
  thread, copy on the consuming one, keep a host batch referenced while
  its copy may be in flight.
"""
from __future__ import annotations

import collections
import concurrent.futures
import itertools
import queue
import threading

import numpy as np
import torch

from rcu_tpu_torch.utils import profiling


class SliceBatchLoader:
    """Yields ``{<categories>, 'subject_index', 'slice_index', 'valid'}``."""

    def __init__(self, dataset, indices: list, batch_size: int,
                 categories=("images", "labels"), shuffle: bool = False,
                 seed: int = 0, drop_remainder: bool = False,
                 transform=None, indexing=None, num_workers: int = 0,
                 shard=None, shuffle_chunk: int = 0):
        if shuffle_chunk < 0:
            raise ValueError(f"shuffle_chunk must be >= 0, got {shuffle_chunk}")
        self.dataset = dataset
        self.indexing = indexing  # owns index -> array extraction when given
        self.indices = list(indices)
        self.batch_size = batch_size
        self.categories = tuple(categories)
        self.shuffle = shuffle
        self.shuffle_chunk = int(shuffle_chunk)
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.transform = transform
        self.num_workers = int(num_workers or 0)
        if shard is not None:
            shard_id, n_shards = shard
            if not 0 <= shard_id < n_shards:
                raise ValueError(f"shard {shard} must satisfy "
                                 "0 <= shard_id < n_shards")
        self.shard = shard
        self._pool = None  # created on first use, shared across epochs
        self._epoch = 0

    def peek_item_shapes(self) -> dict:
        """Per-category shapes of one decoded (transformed) item."""
        probe = SliceBatchLoader(self.dataset, self.indices[:1], batch_size=1,
                                 categories=self.categories,
                                 transform=self.transform,
                                 indexing=self.indexing)
        batch = next(iter(probe))
        return {c: batch[c].shape[1:] for c in self.categories}

    def _reader_pool(self):
        """Threads that read a batch's items, for ``num_workers`` >= 2 (one
        worker is the read-ahead thread of :func:`prefetch`)."""
        if self._pool is None and self.num_workers > 1:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                self.num_workers, thread_name_prefix="loader")
        return self._pool

    def __len__(self):
        n = len(self._epoch_order())
        if self.drop_remainder:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        """Reseed the shuffle for ``epoch`` (seed + epoch)."""
        self._epoch = epoch

    def _shard(self, order):
        """This host's rows of the epoch order (``shard=(host, n)``): a
        stride through it, so that a global shuffle still mixes subjects
        across hosts, cut to the common length, so that every host runs
        the same number of batches (lockstep collectives)."""
        if self.shard is None:
            return order
        shard_id, n_shards = self.shard
        return order[shard_id::n_shards][:len(order) // n_shards]

    def _epoch_order(self):
        """This epoch's item order, uniform or chunked shuffle, then this
        host's shard."""
        order = np.arange(len(self.indices))
        c = self.shuffle_chunk
        if self.shuffle and c > 1:
            rng = np.random.RandomState(self.seed + self._epoch)
            # a random chunk origin each epoch, so that the partial chunks
            # at either end hold other items every epoch
            off = int(rng.randint(c))
            head, body = order[:off], order[off:]
            n_full = len(body) // c
            chunks = [body[k * c:(k + 1) * c] for k in range(n_full)]
            tail = body[n_full * c:]
            if self.shard is None:
                chunks.extend(p for p in (head, tail) if len(p))
                if not chunks:
                    return order
                perm = rng.permutation(len(chunks))
                return np.concatenate([chunks[k] for k in perm])
            # a shard takes whole chunks (a stride through rows would break
            # the runs that the chunks keep) of the same shuffled chunk
            # order, as many as the worst chunk origin leaves every shard,
            # so that each epoch has the same length
            shard_id, n_shards = self.shard
            n_min_full = max(0, len(order) - (c - 1)) // c
            n_per = n_min_full // n_shards
            if n_per == 0 and len(order):
                raise ValueError(
                    f"chunked shuffle with shard={self.shard} needs at least "
                    f"{n_shards} full chunks at any epoch offset, got "
                    f"{n_min_full} ({len(order)} items / shuffle_chunk={c}); "
                    "reduce shuffle_chunk or disable chunked shuffle")
            perm = rng.permutation(n_full)
            mine = perm[shard_id::n_shards][:n_per]
            if n_per == 0:
                return order[:0]
            return np.concatenate([chunks[k] for k in mine])
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(order)
        return self._shard(order)

    def _read(self, subject_idx: int, slice_idx: int) -> dict:
        subject = self.dataset.subjects[subject_idx]
        out = {}
        for c in self.categories:
            if self.indexing is not None:
                out[c] = self.indexing.extract(self.dataset, subject,
                                               slice_idx, c)
            elif slice_idx < 0:
                out[c] = self.dataset.read_volume(subject, c)
            else:
                out[c] = self.dataset.read_slice(subject, slice_idx, c)
        if self.transform is not None:
            out = self.transform(out)
        return out

    def __iter__(self):
        order = self._epoch_order()
        bs = self.batch_size
        for start in range(0, len(order), bs):
            chunk = order[start:start + bs]
            if len(chunk) < bs and self.drop_remainder:
                return
            pool = self._reader_pool()
            if pool is not None:
                items = list(pool.map(lambda i: self._read(*self.indices[i]),
                                      chunk))
            else:
                items = [self._read(*self.indices[i]) for i in chunk]
            batch = {c: np.stack([it[c] for it in items])
                     for c in self.categories}
            nb_valid = len(chunk)
            if nb_valid < bs:  # pad the ragged tail to the static shape
                pad = bs - nb_valid
                for c in batch:
                    batch[c] = np.concatenate(
                        [batch[c], np.repeat(batch[c][-1:], pad, axis=0)])
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad)])
            batch["subject_index"] = np.asarray(
                [self.indices[i][0] for i in chunk], np.int32)
            batch["slice_index"] = np.asarray(
                [self.indices[i][1] for i in chunk], np.int32)
            batch["valid"] = (np.arange(bs) < nb_valid).astype(np.float32)
            yield batch


def _host_tensors(batch: dict, pin: bool) -> dict:
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        out[key] = t.pin_memory() if pin else t
    return out


def prefetch(iterator, device, size: int = 2, pin: bool = None,
             stage: str = "train"):
    """Yield the batches of ``iterator`` as tensors on ``device``.

    A thread reads ahead up to ``size`` batches and turns each into torch
    tensors, pinned when ``device`` is a card or ``pin`` asks for it (host
    batches that a mesh's devices copy their parts of; it touches no CUDA
    stream);
    this thread copies each batch with ``non_blocking`` and keeps the last
    ``size`` host batches referenced, so that no pinned buffer is freed
    under a copy in flight. An exception of the reader is raised here;
    leaving the loop early stops the reader.

    Spans of batch ``k`` (``utils.profiling``, while a profiler runs):
    ``loader.read`` on the reader thread (the batch and its tensors),
    ``<stage>.feed_wait`` and ``<stage>.copy_in`` on this one; the read
    and the wait that find the iterator's end are batch ``len`` 's."""
    device = torch.device(device)
    pin = device.type == "cuda" if pin is None else pin
    wait_span, copy_span = f"{stage}.feed_wait", f"{stage}.copy_in"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    end = object()
    stop = threading.Event()

    def offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            batches = iter(iterator)
            for k in itertools.count():
                with profiling.span("loader.read", k):
                    batch = next(batches, end)
                    if batch is not end:
                        batch = _host_tensors(batch, pin)
                if batch is end:
                    break
                if stop.is_set() or not offer(batch):
                    return
            offer(end)
        except BaseException as e:  # noqa: BLE001 — raised in the consumer
            offer(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    in_flight = collections.deque(maxlen=size)
    try:
        for k in itertools.count():
            with profiling.span(wait_span, k):
                item = q.get()
            if item is end:
                return
            if isinstance(item, BaseException):
                raise item
            in_flight.append(item)
            with profiling.span(copy_span, k):
                batch = {key: v.to(device, non_blocking=True)
                         for key, v in item.items()}
            yield batch
    finally:
        stop.set()
        thread.join()
