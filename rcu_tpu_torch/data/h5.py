"""Read side of the HDF5 subject store written by ``rcu_tpu.data.h5``.

Layout (the store's contract)::

  /subjects                     string dataset of subject names (ordering!)
  /data/<subject>/<category>    e.g. images (Z,Y,X,C) f32, labels (Z,Y,X) u8
  /props/<subject>              attrs: size/spacing/origin/direction
  /meta/<subject>               free-form attrs, 'files' as a json string

``h5py`` is imported when a store is opened, not when this module is.
"""
from __future__ import annotations

import json
import typing

from rcu_tpu_torch.data.nifti import ImageProperties


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

    def files(self, subject: str) -> dict:
        attrs = self._f[f"meta/{subject}"].attrs
        return json.loads(attrs["files"]) if "files" in attrs else {}

    def close(self):
        self._handles.clear()
        self._f.close()
