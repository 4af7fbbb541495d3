"""DataConfiguration -> the subject store and the transform pipeline
(``rcu_tpu.engine.databuild`` counterparts of ``build_transform``,
``build_dataset`` and ``build_data``'s zero-subject guard; the direct eval
needs no loader)."""
from __future__ import annotations

import typing

from rcu_tpu_torch.data import transforms as tfm_lib
from rcu_tpu_torch.data.h5 import SubjectDataset
from rcu_tpu_torch.data.isic import IsicFolderDataset
from rcu_tpu_torch.engine.config import DataConfiguration, ParametricNode

# torch-layout transforms in the shared yaml configs; the port's public
# functions take channels-last data, as the JAX package's do
_LAYOUT_NOOPS = {"permute", "squeeze", "unsqueeze"}


def _pop_params(node, required=(), optional=()):
    """-> (required values, {optional name: value}); a parameter that the
    transform does not know raises, so that a typo cannot pass as a
    no-op."""
    p = dict(node.params)
    for name in required:
        if name not in p:
            raise ValueError(f'{node.type} transform needs a "{name}" param')
    values = [p.pop(name) for name in required]
    kwargs = {k: p.pop(k) for k in optional if k in p}
    if p:
        raise ValueError(f"unknown {node.type} params: {sorted(p)}")
    return values, kwargs


def build_transform(nodes: typing.Optional[list]):
    """The config's transform nodes as one :class:`~data.transforms.Compose`
    (None where the list is empty or holds layout nodes only): ``rescale``
    (entries, lower, upper, old_min, old_max), ``size`` (size, entries) and
    ``relabel`` (label_changes, entries; labels by default). Any other
    node raises ``ValueError``."""
    transforms = []
    for node in nodes or ():
        node = ParametricNode.parse(node)
        if node.type in _LAYOUT_NOOPS:
            continue
        if node.type == "rescale":
            _, kwargs = _pop_params(node, optional=(
                "entries", "lower", "upper", "old_min", "old_max"))
            transforms.append(tfm_lib.Rescale(**kwargs))
        elif node.type == "size":
            (size,), kwargs = _pop_params(node, ("size",), ("entries",))
            transforms.append(tfm_lib.Size(size, **kwargs))
        elif node.type == "relabel":
            (changes,), kwargs = _pop_params(node, ("label_changes",),
                                             ("entries",))
            transforms.append(tfm_lib.Relabel(changes, **kwargs))
        else:
            raise ValueError(f'unknown transform "{node.type}"')
    return tfm_lib.Compose(transforms) if transforms else None


def build_dataset(data_config: DataConfiguration, subjects=None,
                  prediction_dir: str = None):
    """An ``.h5`` path opens the H5 subject store, any other the ISIC
    folder dataset (superpixels where ``with_superpixels`` is set in the
    data config; the baseline predictions of ``prediction_dir`` as a
    second label channel)."""
    path = str(data_config.dataset)
    if path.endswith(".h5"):
        return SubjectDataset(path, subject_subset=subjects)
    return IsicFolderDataset(
        path, subject_subset=subjects, prediction_dir=prediction_dir,
        with_superpixels=bool(data_config.others.get("with_superpixels",
                                                     False)))


def build_data(data_config: DataConfiguration, subjects=None,
               prediction_dir: str = None):
    """The config's dataset restricted to ``subjects``; zero subjects
    raise."""
    dataset = build_dataset(data_config, subjects, prediction_dir)
    if not dataset.subjects:
        dataset.close()
        raise ValueError(
            f"no subjects: the dataset {data_config.dataset!r} "
            + ("with an empty subject selection "
               if subjects is not None else "")
            + "resolved to zero subjects")
    return dataset
