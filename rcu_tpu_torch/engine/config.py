"""Train- and test-config yaml with ``rcu_tpu.engine.config``'s schema and
envelope::

    config:
      train_name: brats_baseline
      model: {unet: {depth: 4, dropout: 0.05, ...}}
      optimizer: {adam: {lr: 0.0001}}
      train_data: {batch_size: 32, dataset: ..., indexing: {slice: {}},
                   selection_strategy: {none-black: {}}}
      others: {}
    meta: {type: train-config, version: 0}

Polymorphic ``{type: {params}}`` nodes (a bare string means empty params)
parse into :class:`ParametricNode`. ``yaml`` is imported by :func:`load`
and :func:`save`.
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

    def to_dict(self):
        return self.type if not self.params else {self.type: self.params}


def _nodes_to_yaml(value):
    if isinstance(value, ParametricNode):
        return value.to_dict()
    if isinstance(value, list):
        return [_nodes_to_yaml(v) for v in value]
    return value


@dataclasses.dataclass
class DataConfiguration:
    """The data node of a config; unknown keys land in ``others``."""
    dataset: str = ""
    batch_size: int = 10
    num_workers: int = 1
    extractor: list = None
    transform: list = None
    indexing: ParametricNode = None
    selection_strategy: ParametricNode = None
    selection_extractor: ParametricNode = None
    shuffle: bool = True
    # SliceBatchLoader.shuffle_chunk: 0/1 the uniform shuffle
    shuffle_chunk: int = 0
    direct_extractor: list = None
    direct_transform: list = None
    others: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "DataConfiguration":
        d = dict(d or {})
        cfg = cls()
        cfg.dataset = d.pop("dataset", cfg.dataset)
        cfg.batch_size = d.pop("batch_size", cfg.batch_size)
        cfg.num_workers = d.pop("num_workers", cfg.num_workers)
        cfg.shuffle = d.pop("shuffle", cfg.shuffle)
        cfg.shuffle_chunk = d.pop("shuffle_chunk", cfg.shuffle_chunk)
        cfg.extractor = ParametricNode.parse_list(d.pop("extractor", None))
        cfg.transform = ParametricNode.parse_list(d.pop("transform", None))
        for single in ("indexing", "selection_strategy", "selection_extractor"):
            node = d.pop(single, None)
            setattr(cfg, single, ParametricNode.parse(node) if node is not None else None)
        cfg.direct_extractor = ParametricNode.parse_list(d.pop("direct_extractor", None))
        cfg.direct_transform = ParametricNode.parse_list(d.pop("direct_transform", None))
        cfg.others = d.pop("others", {}) or {}
        cfg.others.update(d)
        return cfg

    def to_dict(self) -> dict:
        out = {
            "dataset": self.dataset, "batch_size": self.batch_size,
            "num_workers": self.num_workers, "shuffle": self.shuffle,
        }
        if self.shuffle_chunk:
            out["shuffle_chunk"] = self.shuffle_chunk
        for key in ("extractor", "transform", "indexing", "selection_strategy",
                    "selection_extractor", "direct_extractor", "direct_transform"):
            value = getattr(self, key)
            if value is not None:
                out[key] = _nodes_to_yaml(value)
        if self.others:
            out["others"] = self.others
        return out


@dataclasses.dataclass
class TrainConfiguration:
    """A train run: model, optimizer, epochs, split, seed and the data."""
    epochs: int = 100
    valid_every_nth: int = 1
    log_every_nth: int = 1
    optimizer: ParametricNode = None
    model: ParametricNode = None
    seed: int = 20
    split: str = ""
    train_dir: str = ""
    train_name: str = ""
    train_data: DataConfiguration = dataclasses.field(default_factory=DataConfiguration)
    valid_data: DataConfiguration = dataclasses.field(default_factory=DataConfiguration)
    others: dict = dataclasses.field(default_factory=dict)

    META_TYPE = "train-config"
    VERSION = 0

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfiguration":
        cfg = cls()
        for key in ("epochs", "valid_every_nth", "log_every_nth", "seed", "split",
                    "train_dir", "train_name"):
            if key in d:
                setattr(cfg, key, d[key])
        if d.get("model") is not None:
            cfg.model = ParametricNode.parse(d["model"])
        if d.get("optimizer") is not None:
            cfg.optimizer = ParametricNode.parse(d["optimizer"])
        cfg.train_data = DataConfiguration.from_dict(d.get("train_data"))
        cfg.valid_data = DataConfiguration.from_dict(d.get("valid_data"))
        cfg.others = d.get("others", {}) or {}
        return cfg

    def to_dict(self) -> dict:
        return {
            "train_name": self.train_name, "train_dir": self.train_dir,
            "split": self.split, "epochs": self.epochs,
            "model": _nodes_to_yaml(self.model) if self.model else None,
            "optimizer": _nodes_to_yaml(self.optimizer) if self.optimizer else None,
            "seed": self.seed, "valid_every_nth": self.valid_every_nth,
            "log_every_nth": self.log_every_nth, "others": self.others,
            "train_data": self.train_data.to_dict(),
            "valid_data": self.valid_data.to_dict(),
        }


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
    VERSION = 0

    @classmethod
    def from_dict(cls, d: dict) -> "TestConfiguration":
        cfg = cls()
        for key in ("seed", "split", "model_dir", "test_name", "test_dir", "test_at"):
            if key in d:
                setattr(cfg, key, d[key])
        cfg.test_data = DataConfiguration.from_dict(d.get("test_data"))
        cfg.others = d.get("others", {}) or {}
        return cfg

    def to_dict(self) -> dict:
        return {
            "test_name": self.test_name, "test_dir": self.test_dir,
            "model_dir": self.model_dir, "split": self.split, "seed": self.seed,
            "test_at": self.test_at, "others": self.others,
            "test_data": self.test_data.to_dict(),
        }


_TYPES = {TrainConfiguration.META_TYPE: TrainConfiguration,
          TestConfiguration.META_TYPE: TestConfiguration}


def load(path: str, expected_type: str = None):
    """Load a train- or test-config yaml (``config:`` + ``meta:``
    envelope); ``expected_type`` (``"train-config"`` or ``"test-config"``)
    refuses the other."""
    import yaml
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict) or "config" not in raw:
        raise ValueError(f"{path}: missing 'config' envelope")
    if not isinstance(raw["config"], dict):
        raise ValueError(f"{path}: 'config' body must be a mapping, got "
                         f"{type(raw['config']).__name__}")
    mtype = (raw.get("meta") or {}).get("type")
    if expected_type is not None and mtype != expected_type:
        raise ValueError(f"{path}: expected config type {expected_type!r}, got {mtype!r}")
    cls = _TYPES.get(mtype)
    if cls is None:
        raise ValueError(f"{path}: unknown config type {mtype!r}")
    return cls.from_dict(raw["config"])


def save(cfg, path: str):
    """Write ``cfg`` with the envelope that :func:`load` reads."""
    import yaml
    envelope = {"config": cfg.to_dict(),
                "meta": {"type": cfg.META_TYPE, "version": cfg.VERSION}}
    with open(path, "w") as f:
        yaml.safe_dump(envelope, f, default_flow_style=False, sort_keys=False)


def require_log_sigma(config) -> bool:
    """``others.is_log_sigma`` is required for aleatoric runs: it says
    whether the sigma head gives log-sigma (exp) or sigma (abs)."""
    if "is_log_sigma" not in config.others:
        raise ValueError(
            'missing "is_log_sigma" entry in the configuration (others)')
    return bool(config.others["is_log_sigma"])
