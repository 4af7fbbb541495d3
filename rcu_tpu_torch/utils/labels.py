"""Label helpers: one-hot and EDT border masks (``rcu_tpu.utils.labels``,
copied). ``scipy`` is imported inside :func:`border_mask`, its one user."""
from __future__ import annotations

import numpy as np


def to_one_hot(labels: np.ndarray, nb_classes: int = None) -> np.ndarray:
    if nb_classes is None:
        nb_classes = int(labels.max()) + 1
    eye = np.eye(nb_classes, dtype=np.float32)
    return eye[labels.astype(np.int64)]


def border_mask(mask: np.ndarray, distance_in: float = 1, distance_out: float = 1):
    """(distance_map, border_mask): voxels within ``distance_in`` inside or
    ``distance_out`` outside the object boundary, by Euclidean distance
    transforms. The distance map is the unsigned ``dist_in + dist_out``
    (one term is zero at every voxel), so a band filter such as
    ``distance <= d`` holds on both sides of the boundary."""
    from scipy import ndimage
    mask = mask.astype(bool)
    dist_out = ndimage.distance_transform_edt(~mask)
    dist_in = ndimage.distance_transform_edt(mask)
    border = (dist_out <= distance_out) & (dist_in <= distance_in)
    return dist_in + dist_out, border
