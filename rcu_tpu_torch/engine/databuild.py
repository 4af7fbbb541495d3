"""DataConfiguration -> the subject store and the transform pipeline."""
from __future__ import annotations

import typing

from rcu_tpu_torch.data.h5 import SubjectDataset
from rcu_tpu_torch.engine.config import DataConfiguration, ParametricNode

# torch-layout transforms in the shared yaml configs; the port's public
# functions take channels-last data, as the JAX package's do
_LAYOUT_NOOPS = {"permute", "squeeze", "unsqueeze"}


def build_transform(nodes: typing.Optional[list]):
    """None for an empty (or layout-only) transform list; the rescale/size/
    relabel transforms are not ported yet and raise."""
    for node in nodes or ():
        node = ParametricNode.parse(node)
        if node.type not in _LAYOUT_NOOPS:
            raise NotImplementedError(
                f'transform "{node.type}" is not ported to rcu_tpu_torch yet')
    return None


def build_data(data_config: DataConfiguration, subjects=None) -> SubjectDataset:
    """The config's H5 subject store, restricted to ``subjects``; the direct
    eval needs nothing else of the JAX ``build_data`` (no loader)."""
    path = str(data_config.dataset)
    if not path.endswith(".h5"):
        raise NotImplementedError(
            f"dataset {path!r}: only H5 subject stores are ported to "
            "rcu_tpu_torch yet (the ISIC folder dataset is not)")
    dataset = SubjectDataset(path, subject_subset=subjects)
    if not dataset.subjects:
        dataset.close()
        raise ValueError(f"no subjects: the dataset {data_config.dataset!r} "
                         "resolved to zero subjects")
    return dataset
