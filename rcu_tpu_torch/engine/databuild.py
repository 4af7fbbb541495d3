"""DataConfiguration -> the subject store, the transform pipeline, the
indices and the batch loader (``rcu_tpu.engine.databuild`` counterparts).
The direct eval reads the store of :func:`build_data`; training its
loader too."""
from __future__ import annotations

import dataclasses
import typing

from rcu_tpu_torch.data import indexing as idx_lib
from rcu_tpu_torch.data import transforms as tfm_lib
from rcu_tpu_torch.data.assembler import (PatchAssembler, Subject2dAssembler,
                                          SubjectAssembler)
from rcu_tpu_torch.data.h5 import SubjectDataset
from rcu_tpu_torch.data.isic import IsicFolderDataset
from rcu_tpu_torch.data.loader import SliceBatchLoader
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


def build_indexing(node: typing.Optional[ParametricNode]):
    """``slice``, ``empty`` (the default) or ``patch`` (patch_shape, pad)."""
    if node is None or node.type == "empty":
        return idx_lib.EmptyIndexing()
    if node.type == "slice":
        return idx_lib.SliceIndexing()
    if node.type == "patch":
        return idx_lib.PatchWiseIndexing(
            node.params.get("patch_shape", (128, 128)),
            pad=node.params.get("pad", (0, 0)))
    raise ValueError(f'unknown indexing "{node.type}"')


def build_assembler(dataset, indexing_node, entries):
    """The assembler that matches the indexing strategy."""
    indexing = build_indexing(indexing_node)
    if isinstance(indexing, idx_lib.SliceIndexing):
        return SubjectAssembler(dataset, entries)
    if isinstance(indexing, idx_lib.PatchWiseIndexing):
        return PatchAssembler(dataset, indexing, entries)
    return Subject2dAssembler(dataset, entries)


def build_selection(node: typing.Optional[ParametricNode],
                    selection_extractor: typing.Optional[ParametricNode]):
    """-> (selection strategy or None, the categories it reads):
    ``none-black`` (on the selection extractor's first category, images by
    default) or ``with-foreground`` (labels)."""
    if node is None:
        return None, ("images",)
    categories = ("images",)
    if selection_extractor is not None and selection_extractor.params:
        categories = tuple(selection_extractor.params.get("categories",
                                                          categories))
    if node.type == "none-black":
        return idx_lib.NoneBlackSelection(category=categories[0]), categories
    if node.type == "with-foreground":
        return idx_lib.WithForegroundSelection(), ("labels",)
    raise ValueError(f'unknown selection strategy "{node.type}"')


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


@dataclasses.dataclass
class Data:
    """Dataset, loader and batches per epoch."""
    dataset: object
    loader: SliceBatchLoader
    nb_batches: int


def build_data(data_config: DataConfiguration, subjects=None, seed: int = 0,
               batch_size: int = None, prediction_dir: str = None) -> Data:
    """The config's dataset restricted to ``subjects`` (zero subjects
    raise) and its loader: the indices of its indexing, filtered by its
    selection strategy through the index cache, the transform, the batch
    size (``batch_size`` or the config's), shuffle and workers."""
    dataset = build_dataset(data_config, subjects, prediction_dir)
    if not dataset.subjects:
        dataset.close()
        raise ValueError(
            f"no subjects: the dataset {data_config.dataset!r} "
            + ("with an empty subject selection "
               if subjects is not None else "")
            + "resolved to zero subjects")
    indexing = build_indexing(data_config.indexing)
    selection, categories = build_selection(data_config.selection_strategy,
                                            data_config.selection_extractor)
    if selection is not None:
        indices = idx_lib.calculate_or_load_indices(dataset, indexing,
                                                    selection, categories)
    else:
        indices = idx_lib.all_indices(dataset, indexing)
    loader = SliceBatchLoader(
        dataset, indices, batch_size=batch_size or data_config.batch_size,
        categories=tuple(dataset.categories()), shuffle=data_config.shuffle,
        seed=seed, transform=build_transform(data_config.transform),
        indexing=indexing, num_workers=data_config.num_workers,
        shuffle_chunk=data_config.shuffle_chunk)
    return Data(dataset=dataset, loader=loader, nb_batches=len(loader))


def direct_subject_info(dataset, subject_index: int) -> dict:
    """One subject's whole labels, properties and files (validation)."""
    subject = dataset.subjects[subject_index]
    return {"subject": subject,
            "labels": dataset.read_volume(subject, "labels"),
            "properties": dataset.properties(subject),
            "files": dataset.files(subject)}
