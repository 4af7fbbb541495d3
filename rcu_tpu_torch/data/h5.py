"""The HDF5 subject store of ``rcu_tpu.data.h5``: its writer and its read
side.

Layout (the store's contract)::

  /subjects                     string dataset of subject names (ordering!)
  /data/<subject>/<category>    e.g. images (Z,Y,X,C) f32, labels (Z,Y,X) u8
  /props/<subject>              attrs: size/spacing/origin/direction
  /meta/<subject>               free-form attrs, 'files' as a json string

Volumes of three or more axes are chunked a slice at a time
(``(1,) + shape[1:]``), so that a loader reads single slices. ``h5py`` is
imported when a store is opened or created, not when this module is: the
card's machine has none, and a store is written where the data is.
"""
from __future__ import annotations

import json
import os
import typing

import numpy as np

from rcu_tpu_torch.data.nifti import ImageProperties


class DatasetWriter:
    """Create a subject H5 store. Use it as a context manager: the
    ``subjects`` index is written at :meth:`close` (idempotent), and not at
    all when the block raises, so a partial store never opens as a whole
    one."""

    def __init__(self, path: str):
        import h5py
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = h5py.File(path, "w")
        self._subjects = []

    def add_subject(self, name: str, arrays: dict,
                    props: ImageProperties = None, meta: dict = None,
                    files: dict = None):
        """``arrays``: {category: array}; ``props`` the volume's geometry,
        ``meta`` free-form attributes, ``files`` the source files (stored
        as a JSON string)."""
        grp = self._f.require_group(f"data/{name}")
        for category, arr in arrays.items():
            arr = np.asarray(arr)
            chunks = (1,) + arr.shape[1:] if arr.ndim >= 3 else None
            grp.create_dataset(category, data=arr, chunks=chunks)
        pgrp = self._f.require_group(f"props/{name}")
        if props is not None:
            pgrp.attrs["size"] = np.asarray(props.size, np.int64)
            pgrp.attrs["spacing"] = np.asarray(props.spacing, np.float64)
            pgrp.attrs["origin"] = np.asarray(props.origin, np.float64)
            pgrp.attrs["direction"] = np.asarray(props.direction, np.float64)
        mgrp = self._f.require_group(f"meta/{name}")
        for key, value in (meta or {}).items():
            mgrp.attrs[key] = value
        if files:
            mgrp.attrs["files"] = json.dumps(files)
        self._subjects.append(name)

    def close(self):
        if self._f is None:
            return
        import h5py
        self._f.create_dataset("subjects", data=np.asarray(
            self._subjects, dtype=h5py.string_dtype()))
        self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None and self._f is not None:
            # no subjects index: the partial store does not open
            self._f.close()
            self._f = None
            return False
        self.close()


class SubjectDataset:
    """Read-side handle over a subject H5 store.

    ``subject_subset`` restricts visibility to the split's subjects, in the
    store's own order. The direct eval reads only ``subjects``,
    ``read_volume``, ``shape`` and ``files``; any object with these four
    members can stand in for a store (``eval.direct.evaluate_subjects``).
    """

    def __init__(self, path: str, subject_subset: typing.Sequence[str] = None):
        import h5py
        self.dataset_path = path
        self._f = h5py.File(path, "r")
        all_subjects = [s.decode() if isinstance(s, bytes) else s
                        for s in self._f["subjects"][()]]
        if subject_subset is not None:
            subset = set(subject_subset)
            missing = subset - set(all_subjects)
            if missing:
                raise ValueError(f"subjects not in dataset: {sorted(missing)}")
            self.subjects = [s for s in all_subjects if s in subset]
        else:
            self.subjects = all_subjects
        self.subject_subset = list(self.subjects)
        # an h5py path lookup costs ~0.25 ms; the loader reads by row
        self._handles = {}

    def _ds(self, subject: str, category: str):
        key = (subject, category)
        if key not in self._handles:
            self._handles[key] = self._f[f"data/{subject}/{category}"]
        return self._handles[key]

    def categories(self, subject: str = None):
        return sorted(self._f[f"data/{subject or self.subjects[0]}"].keys())

    def shape(self, subject: str, category: str = "images"):
        return self._ds(subject, category).shape

    def dtype(self, subject: str, category: str = "images"):
        return self._ds(subject, category).dtype

    def read_slice(self, subject: str, index: int, category: str):
        return self._ds(subject, category)[index]

    def read_volume(self, subject: str, category: str):
        return self._ds(subject, category)[()]

    def properties(self, subject: str) -> ImageProperties:
        attrs = self._f[f"props/{subject}"].attrs
        if "size" not in attrs:
            return ImageProperties(size=tuple(
                int(v) for v in self.shape(subject)[0:3][::-1]))
        return ImageProperties(
            size=tuple(int(v) for v in attrs["size"]),
            spacing=tuple(float(v) for v in attrs["spacing"]),
            origin=tuple(float(v) for v in attrs["origin"]),
            direction=tuple(float(v) for v in attrs["direction"]))

    def meta(self, subject: str) -> dict:
        return dict(self._f[f"meta/{subject}"].attrs)

    def files(self, subject: str) -> dict:
        attrs = self._f[f"meta/{subject}"].attrs
        return json.loads(attrs["files"]) if "files" in attrs else {}

    def close(self):
        self._handles.clear()
        self._f.close()
