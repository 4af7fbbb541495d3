"""Test-config yaml with ``rcu_tpu.engine.config``'s schema and envelope::

    config:
      test_name: brats_test_baseline_mc
      model_dir: ...
      split: config/splits/split_brats18_100-25-160.json
      seed: 20
      test_at: best
      others: {mc: 20}
      test_data: {batch_size: 32, dataset: ..., indexing: {slice: {}}}
    meta: {type: test-config, version: 0}

Polymorphic ``{type: {params}}`` nodes (a bare string means empty params)
parse into :class:`ParametricNode`. ``yaml`` is imported by :func:`load`.
"""
from __future__ import annotations

import dataclasses
import typing


@dataclasses.dataclass
class ParametricNode:
    """A ``{type: {params}}`` yaml node."""
    type: str
    params: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, node) -> "ParametricNode":
        if isinstance(node, str):
            return cls(node, {})
        if isinstance(node, dict):
            if len(node) != 1:
                raise ValueError(f"parametric node must have exactly one key: {node}")
            (t, p), = node.items()
            return cls(t, dict(p) if p else {})
        if isinstance(node, ParametricNode):
            return node
        raise ValueError(f"cannot parse parametric node: {node!r}")

    @classmethod
    def parse_list(cls, node) -> typing.Optional[list]:
        if node is None:
            return None
        if not isinstance(node, list):
            node = [node]
        return [cls.parse(n) for n in node]


@dataclasses.dataclass
class DataConfiguration:
    """The data node of a config; unknown keys land in ``others``."""
    dataset: str = ""
    batch_size: int = 10
    transform: list = None
    indexing: ParametricNode = None
    others: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "DataConfiguration":
        d = dict(d or {})
        cfg = cls()
        cfg.dataset = d.pop("dataset", cfg.dataset)
        cfg.batch_size = d.pop("batch_size", cfg.batch_size)
        cfg.transform = ParametricNode.parse_list(d.pop("transform", None))
        node = d.pop("indexing", None)
        cfg.indexing = ParametricNode.parse(node) if node is not None else None
        cfg.others = d.pop("others", {}) or {}
        cfg.others.update(d)
        return cfg


@dataclasses.dataclass
class TestConfiguration:
    """A test run: checkpoint, split, seed and the test data."""
    seed: int = 20
    split: str = ""
    model_dir: str = ""
    test_name: str = ""
    test_dir: str = None
    test_at: typing.Union[int, str] = ""  # 'best', 'last' or int epoch
    test_data: DataConfiguration = dataclasses.field(default_factory=DataConfiguration)
    others: dict = dataclasses.field(default_factory=dict)

    META_TYPE = "test-config"

    @classmethod
    def from_dict(cls, d: dict) -> "TestConfiguration":
        cfg = cls()
        for key in ("seed", "split", "model_dir", "test_name", "test_dir", "test_at"):
            if key in d:
                setattr(cfg, key, d[key])
        cfg.test_data = DataConfiguration.from_dict(d.get("test_data"))
        cfg.others = d.get("others", {}) or {}
        return cfg


def load(path: str) -> TestConfiguration:
    """Load a test-config yaml (``config:`` + ``meta:`` envelope)."""
    import yaml
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict) or not isinstance(raw.get("config"), dict):
        raise ValueError(f"{path}: missing 'config' mapping")
    mtype = (raw.get("meta") or {}).get("type")
    if mtype != TestConfiguration.META_TYPE:
        raise ValueError(f"{path}: expected config type "
                         f"{TestConfiguration.META_TYPE!r}, got {mtype!r}")
    return TestConfiguration.from_dict(raw["config"])
