"""Indexing and selection strategies over a subject store, with cached
indices (``rcu_tpu.data.indexing``, copied: numpy only).

The selection cache is the JAX package's crc32-keyed JSON file: key =
dataset basename + sorted subjects + repr(indexing) + repr(selection),
under ``<dataset_dir>/indices/<crc32>.json``, so both packages share it.

An index is a pair ``(subject_index, slice_index)`` (slice_index -1 for whole
-subject/empty indexing). Selection strategies prefilter non-informative
slices on the host once; training then samples uniformly from the cached list.
"""
from __future__ import annotations

import json
import logging
import os
import zlib

import numpy as np



class SliceIndexing:
    """One index per (subject, z-slice)."""

    def indices_for(self, dataset, subject_idx: int):
        subject = dataset.subjects[subject_idx]
        nb_slices = dataset.shape(subject)[0]
        return [(subject_idx, z) for z in range(nb_slices)]

    def extract(self, dataset, subject: str, index: int, category: str):
        return dataset.read_slice(subject, index, category)

    def extract_cached(self, vols: dict, index: int, category: str):
        """Same as extract, cropping from pre-read whole volumes (one read
        per subject instead of one per index — the select_indices path)."""
        return vols[category][index]

    def __repr__(self):
        return "SliceIndexing()"


class EmptyIndexing:
    """One index per subject (whole-volume extraction)."""

    def indices_for(self, dataset, subject_idx: int):
        return [(subject_idx, -1)]

    def extract(self, dataset, subject: str, index: int, category: str):
        return dataset.read_volume(subject, category)

    def extract_cached(self, vols: dict, index: int, category: str):
        return vols[category]

    def __repr__(self):
        return "EmptyIndexing()"


class PatchWiseIndexing:
    """One index per (subject, slice, grid-patch) over a 2D patch grid.

    The flat per-subject index encodes (z, gy, gx) row-major over the grid;
    :meth:`extract` decodes it and crops (padding edge cells to the full
    patch shape so batches stay static).

    ``pad`` adds a symmetric context halo around each patch (the equivalent
    of pymia's pad-recursion ``PadDataExtractor``, reference
    common/trainloop/factory.py:51-57): extraction returns
    ``(py + 2*pad_y, px + 2*pad_x)`` windows whose out-of-volume regions are
    zero-filled, while the patch *grid* (and thus the index count and the
    assembly layout) is unchanged — overlap lives only in the extracted data.
    Like pymia (which wraps only the data extractor), the halo applies to the
    ``pad_categories`` only — labels keep the bare ``patch_shape``, so the
    consuming model must map the haloed input window back to the grid cell
    (e.g. valid convolutions), exactly as with pymia's PadDataExtractor.
    """

    def __init__(self, patch_shape, pad=(0, 0), pad_categories=("images",)):
        self.patch_shape = tuple(patch_shape)
        self.pad = tuple(pad)
        self.pad_categories = tuple(pad_categories)

    def _grid(self, dataset, subject):
        z, y, x = dataset.shape(subject)[:3]
        py, px = self.patch_shape
        return z, -(-y // py), -(-x // px)

    def indices_for(self, dataset, subject_idx: int):
        subject = dataset.subjects[subject_idx]
        z, gy, gx = self._grid(dataset, subject)
        return [(subject_idx, i) for i in range(z * gy * gx)]

    def extract(self, dataset, subject: str, index: int, category: str):
        _, grid_y, grid_x = self._grid(dataset, subject)
        zi, gy, gx = self._decode(index, grid_y, grid_x)
        plane = dataset.read_slice(subject, zi, category)
        return self._crop_plane(plane, gy, gx, category)

    def extract_cached(self, vols: dict, index: int, category: str):
        """extract() from pre-read whole volumes: ONE read per subject per
        category instead of one full slice decode per grid patch (a
        grid-size-x redundant I/O pass during index selection)."""
        vol = vols[category]
        py, px = self.patch_shape
        grid_y, grid_x = -(-vol.shape[1] // py), -(-vol.shape[2] // px)
        zi, gy, gx = self._decode(index, grid_y, grid_x)
        return self._crop_plane(vol[zi], gy, gx, category)

    def _decode(self, index: int, grid_y: int, grid_x: int):
        zi, rest = divmod(index, grid_y * grid_x)
        gy, gx = divmod(rest, grid_x)
        return zi, gy, gx

    def _crop_plane(self, plane, gy: int, gx: int, category: str):
        py, px = self.patch_shape
        hy, hx = self.pad if category in self.pad_categories else (0, 0)
        # desired window incl. halo, clipped to the plane
        y0, y1 = gy * py - hy, (gy + 1) * py + hy
        x0, x1 = gx * px - hx, (gx + 1) * px + hx
        cy0, cx0 = max(y0, 0), max(x0, 0)
        patch = plane[cy0:y1, cx0:x1]
        want_y, want_x = py + 2 * hy, px + 2 * hx
        lead_y, lead_x = cy0 - y0, cx0 - x0
        if (lead_y, lead_x) != (0, 0) or patch.shape[:2] != (want_y, want_x):
            pad = [(lead_y, want_y - lead_y - patch.shape[0]),
                   (lead_x, want_x - lead_x - patch.shape[1])]
            pad += [(0, 0)] * (patch.ndim - 2)
            patch = np.pad(patch, pad)
        return patch

    def __repr__(self):
        return (f"PatchWiseIndexing(patch_shape={self.patch_shape}, "
                f"pad={self.pad}, pad_categories={self.pad_categories})")


class NoneBlackSelection:
    """Keep slices whose selected category has any non-minimum voxel
    (pymia NonBlackSelection parity: drops all-black slices)."""

    def __init__(self, category: str = "images", black: float = 0.0):
        self.category = category
        self.black = black

    def keep(self, arrays: dict) -> bool:
        return bool(np.any(arrays[self.category] > self.black))

    def __repr__(self):
        return f"NoneBlackSelection(category={self.category!r}, black={self.black})"


class WithForegroundSelection:
    """Keep slices whose labels contain foreground."""

    def __init__(self, category: str = "labels"):
        self.category = category

    def keep(self, arrays: dict) -> bool:
        return bool(np.any(arrays[self.category]))

    def __repr__(self):
        return f"WithForegroundSelection(category={self.category!r})"


class ComposeSelection:
    def __init__(self, selections):
        self.selections = list(selections)

    def keep(self, arrays: dict) -> bool:
        return all(s.keep(arrays) for s in self.selections)

    def __repr__(self):
        return "ComposeSelection({})".format(", ".join(repr(s) for s in self.selections))


def all_indices(dataset, indexing) -> list:
    out = []
    for si in range(len(dataset.subjects)):
        out.extend(indexing.indices_for(dataset, si))
    return out


def select_indices(dataset, indexing, selection,
                   categories=("images",)) -> list:
    """Filter indices by a selection strategy (host-side, one pass).

    Every built-in indexing exposes ``extract_cached`` so each subject's
    volumes are read ONCE per category (a per-index ``extract`` would decode
    the same slice grid-size times for patch indexing); custom indexings
    without it fall back to their own ``extract``."""
    out = []
    cached = hasattr(indexing, "extract_cached")
    for si, subject in enumerate(dataset.subjects):
        vols = {c: dataset.read_volume(subject, c) for c in categories} \
            if cached else None
        for _, code in indexing.indices_for(dataset, si):
            if cached:
                arrays = {c: indexing.extract_cached(vols, code, c)
                          for c in categories}
            else:
                arrays = {c: indexing.extract(dataset, subject, code, c)
                          for c in categories}
            if selection.keep(arrays):
                out.append((si, code))
    return out


def calculate_or_load_indices(dataset, indexing, selection,
                              categories=("images",)) -> list:
    """crc32-keyed JSON cache of selection results (selectionhelper.py:21-41)."""
    to_hash = (os.path.basename(dataset.dataset_path)
               + "".join(sorted(dataset.subject_subset))
               + repr(indexing) + repr(selection))
    crc32 = hex(zlib.crc32(bytes(to_hash, encoding="utf-8")) & 0xFFFFFFFF)

    indices_dir = os.path.join(os.path.dirname(dataset.dataset_path), "indices")
    file_path = os.path.join(indices_dir, f"{crc32}.json")
    if os.path.exists(file_path):
        with open(file_path, "r") as f:
            return [tuple(i) for i in json.load(f)["indices"]]

    logging.info("\t- need to calculate indices: %r", selection)
    indices = select_indices(dataset, indexing, selection, categories)
    os.makedirs(indices_dir, exist_ok=True)
    with open(file_path, "w") as f:
        json.dump({"indices": [list(i) for i in indices]}, f)
    logging.info("\t- written to file %s", file_path)
    return indices
