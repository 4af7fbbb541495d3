"""Slice -> volume reassembly of batch outputs (``rcu_tpu.data.assembler``,
copied: numpy only).

Per-batch outputs are scattered back into per-subject volumes; a subject
is "ready" when all of its slices (grid patches) have arrived. Padded batch
entries (valid == 0) are ignored.
"""
from __future__ import annotations

import numpy as np


class _BaseAssembler:
    """Shared ready-queue/drain protocol: subclasses fill ``self._buffers``
    (subject_idx -> {entry: array}) and append completed indices to
    ``self._ready``; the drain contract (``subjects_ready`` /
    ``get_assembled_subject`` / ``flush``) lives here ONCE so the engine
    loops' leftover handling cannot drift between assembler kinds."""

    def __init__(self, dataset, entries=("probabilities",)):
        self.dataset = dataset
        self.entries = tuple(entries)
        self._buffers = {}   # subject_idx -> {entry: array}
        self._filled = {}    # subject_idx -> set of filled item ids
        self._ready = []

    def subjects_ready(self):
        ready, self._ready = self._ready, []
        return ready

    def get_assembled_subject(self, subject_idx: int) -> dict:
        bufs = self._buffers.pop(subject_idx)
        self._filled.pop(subject_idx, None)
        return bufs

    def flush(self):
        """Report and DROP partially-filled subjects (end-of-loop safety);
        the assembler is empty afterwards."""
        remaining = list(self._buffers.keys())
        self._buffers.clear()
        self._filled.clear()
        self._ready = []
        return remaining


class SubjectAssembler(_BaseAssembler):
    """Assembles per-slice model outputs into (Z, Y, X, ...) subject volumes."""

    def _ensure_buffers(self, subject_idx: int, outputs: dict, item_shape_fn):
        if subject_idx in self._buffers:
            return
        subject = self.dataset.subjects[subject_idx]
        nb_slices = self.dataset.shape(subject)[0]
        bufs = {}
        for entry in self.entries:
            slice_shape = item_shape_fn(entry)
            bufs[entry] = np.zeros((nb_slices,) + tuple(slice_shape),
                                   np.asarray(outputs[entry]).dtype)
        self._buffers[subject_idx] = bufs
        self._filled[subject_idx] = set()

    def add_batch(self, outputs: dict, subject_indices, slice_indices, valid=None):
        """outputs[entry] has shape (B, ...) with slice payload after axis 0."""
        outputs = {e: np.asarray(outputs[e]) for e in self.entries}
        subject_indices = np.asarray(subject_indices)
        slice_indices = np.asarray(slice_indices)
        nb = subject_indices.shape[0]
        for b in range(nb):
            if valid is not None and not valid[b]:
                continue
            si = int(subject_indices[b])
            z = int(slice_indices[b])
            self._ensure_buffers(si, outputs, lambda e: outputs[e].shape[1:])
            if z in self._filled[si]:
                continue
            for entry in self.entries:
                self._buffers[si][entry][z] = outputs[entry][b]
            self._filled[si].add(z)
            subject = self.dataset.subjects[si]
            if len(self._filled[si]) == self.dataset.shape(subject)[0]:
                self._ready.append(si)


class PatchAssembler(_BaseAssembler):
    """Grid-patch -> volume reassembly for :class:`PatchWiseIndexing`.

    Model outputs are bare ``patch_shape`` windows (any extraction halo is
    consumed by the model — see PatchWiseIndexing); each is scattered into
    its (z, gy, gx) grid cell, cropped to the volume extent at edges. A
    subject is ready when every grid cell has arrived.
    """

    def __init__(self, dataset, indexing, entries=("probabilities",)):
        super().__init__(dataset, entries)
        self.indexing = indexing

    def _ensure_buffers(self, subject_idx: int, outputs: dict):
        if subject_idx in self._buffers:
            return
        subject = self.dataset.subjects[subject_idx]
        z, y, x = self.dataset.shape(subject)[:3]
        bufs = {}
        for entry in self.entries:
            tail = np.asarray(outputs[entry]).shape[3:]  # beyond (B, py, px)
            bufs[entry] = np.zeros((z, y, x) + tail,
                                   np.asarray(outputs[entry]).dtype)
        self._buffers[subject_idx] = bufs
        self._filled[subject_idx] = set()

    def add_batch(self, outputs: dict, subject_indices, patch_indices,
                  valid=None):
        outputs = {e: np.asarray(outputs[e]) for e in self.entries}
        subject_indices = np.asarray(subject_indices)
        patch_indices = np.asarray(patch_indices)
        py, px = self.indexing.patch_shape
        for b in range(subject_indices.shape[0]):
            if valid is not None and not valid[b]:
                continue
            si = int(subject_indices[b])
            code = int(patch_indices[b])
            self._ensure_buffers(si, outputs)
            if code in self._filled[si]:
                continue
            subject = self.dataset.subjects[si]
            z, grid_y, grid_x = self.indexing._grid(self.dataset, subject)
            zi, rest = divmod(code, grid_y * grid_x)
            gy, gx = divmod(rest, grid_x)
            _, y_max, x_max = self.dataset.shape(subject)[:3]
            ny = min(py, y_max - gy * py)
            nx = min(px, x_max - gx * px)
            hy, hx = getattr(self.indexing, "pad", (0, 0))
            for entry in self.entries:
                out_b = outputs[entry][b]
                oy, ox = out_b.shape[:2]
                if (oy, ox) == (py + 2 * hy, px + 2 * hx) and (hy or hx):
                    # model kept the halo (same-padding nets): the grid cell
                    # is the centered (py, px) window of the haloed output
                    out_b = out_b[hy:hy + py, hx:hx + px]
                elif (oy, ox) != (py, px):
                    raise ValueError(
                        f"patch output for '{entry}' is {(oy, ox)} but the "
                        f"grid expects {(py, px)} (or the haloed "
                        f"{(py + 2 * hy, px + 2 * hx)}); assembling it would "
                        "silently misalign the volume")
                self._buffers[si][entry][zi, gy * py:gy * py + ny,
                                         gx * px:gx * px + nx] = \
                    out_b[:ny, :nx]
            self._filled[si].add(code)
            if len(self._filled[si]) == z * grid_y * grid_x:
                self._ready.append(si)


class Subject2dAssembler(_BaseAssembler):
    """Trivial passthrough for native-2D datasets (one index == one subject):
    each batch row IS a whole subject, so it goes straight into the shared
    buffers and is immediately ready."""

    def add_batch(self, outputs: dict, subject_indices, slice_indices=None, valid=None):
        outputs = {e: np.asarray(outputs[e]) for e in self.entries}
        subject_indices = np.asarray(subject_indices)
        for b in range(subject_indices.shape[0]):
            if valid is not None and not valid[b]:
                continue
            si = int(subject_indices[b])
            self._buffers[si] = {e: outputs[e][b] for e in self.entries}
            self._ready.append(si)
