"""Subject splits: the on-disk JSON layout of ``rcu_tpu.data.split``.

A single object with ``train`` / ``valid`` / ``test`` keys whose values are
flat subject-name lists, or lists-of-lists for fold files indexed with a
fold number at load time.
"""
from __future__ import annotations

import json


def load_split(file: str, k: int = None):
    """-> (train, valid, test) subject lists, fold ``k`` of a folded file."""
    with open(file) as fp:
        payload = json.load(fp)
    train, valid, test = payload["train"], payload["valid"], payload["test"]
    if k is None:
        return train, valid, test
    return train[k], valid[k], [] if test is None else test[k]
