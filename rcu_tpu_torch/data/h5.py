"""Read side of the HDF5 subject store written by ``rcu_tpu.data.h5``.

Layout (the store's contract)::

  /subjects                     string dataset of subject names (ordering!)
  /data/<subject>/<category>    e.g. images (Z,Y,X,C) f32, labels (Z,Y,X) u8
  /meta/<subject>               free-form attrs, 'files' as a json string

``h5py`` is imported when a store is opened, not when this module is.
"""
from __future__ import annotations

import json
import typing


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

    def shape(self, subject: str, category: str = "images"):
        return self._f[f"data/{subject}/{category}"].shape

    def read_volume(self, subject: str, category: str):
        return self._f[f"data/{subject}/{category}"][()]

    def files(self, subject: str) -> dict:
        attrs = self._f[f"meta/{subject}"].attrs
        return json.loads(attrs["files"]) if "files" in attrs else {}

    def close(self):
        self._f.close()
