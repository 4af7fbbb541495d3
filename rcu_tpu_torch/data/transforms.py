"""Host-side sample transforms (``rcu_tpu.data.transforms`` counterparts):
numpy on the host, applied once per image or slice in the direct eval's
reader threads, never on the device.

A sample is a dict of arrays (``images`` (H, W, C), ``labels`` (H, W) or
(H, W, 2)); each transform rewrites the entries it names (all by default)
that the sample holds. The semantics are the JAX package's letter for
letter:
- :class:`Rescale` maps each entry's OWN min/max range to [lower, upper]
  (an ISIC jpg with pixel range [10, 200] maps to the full [0, 1]); a
  constant array raises ``ValueError``, so an all-background mask does;
- :class:`Relabel` applies its changes one after another, each to the
  previous one's output;
- :class:`Size` crops or pads from the centre, the odd pixel after.
The layout transforms (:class:`Permute`, :class:`Squeeze`,
:class:`UnSqueeze`) exist for explicit use; the configs' torch-layout
nodes are no-ops in ``engine.databuild.build_transform``.
"""
from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = [t for t in transforms if t is not None]

    def __call__(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


class EntriesTransform:
    def __init__(self, entries=None):
        self.entries = entries

    def _apply(self, arr):
        raise NotImplementedError

    def __call__(self, sample: dict) -> dict:
        entries = self.entries if self.entries is not None else list(sample)
        for e in entries:
            if e in sample and isinstance(sample[e], np.ndarray):
                sample[e] = self._apply(sample[e])
        return sample


class Permute(EntriesTransform):
    def __init__(self, permutation, entries=None):
        super().__init__(entries)
        self.permutation = tuple(permutation)

    def _apply(self, arr):
        return np.transpose(arr, self.permutation)


class Squeeze(EntriesTransform):
    def _apply(self, arr):
        return np.squeeze(arr)


class UnSqueeze(EntriesTransform):
    def __init__(self, axis=-1, entries=None):
        super().__init__(entries)
        self.axis = axis

    def _apply(self, arr):
        return np.expand_dims(arr, self.axis)


class Rescale(EntriesTransform):
    """Linear rescale of each entry's own min/max range (or the fixed
    ``old_min``/``old_max``) to [lower, upper], in float32."""

    def __init__(self, lower=0.0, upper=1.0, old_min=None, old_max=None,
                 entries=None):
        super().__init__(entries)
        self.lower, self.upper = float(lower), float(upper)
        self.old_min = None if old_min is None else float(old_min)
        self.old_max = None if old_max is None else float(old_max)

    def _apply(self, arr):
        arr = arr.astype(np.float32)
        lo = arr.min() if self.old_min is None else self.old_min
        hi = arr.max() if self.old_max is None else self.old_max
        if hi == lo:
            raise ValueError(
                "rescale: array has a constant value "
                f"({lo}); its min-max range cannot be rescaled (pass "
                "old_min/old_max to fix the source range explicitly)")
        scaled = (arr - lo) / (hi - lo)
        return scaled * (self.upper - self.lower) + self.lower


class Relabel(EntriesTransform):
    def __init__(self, label_changes: dict, entries=("labels",)):
        super().__init__(entries)
        self.label_changes = dict(label_changes)

    def _apply(self, arr):
        # one change after another: with {2: 1, 3: 2} the original 1s end
        # at 3
        out = arr.copy()
        for new, old in self.label_changes.items():
            out[out == old] = new
        return out


class Size(EntriesTransform):
    """Centre crop or pad of the leading spatial axes to ``size``."""

    def __init__(self, size, entries=None):
        super().__init__(entries)
        self.size = tuple(size)

    def _apply(self, arr):
        out = arr
        for axis, target in enumerate(self.size):
            cur = out.shape[axis]
            if cur > target:
                start = (cur - target) // 2
                sl = [slice(None)] * out.ndim
                sl[axis] = slice(start, start + target)
                out = out[tuple(sl)]
            elif cur < target:
                pad = [(0, 0)] * out.ndim
                before = (target - cur) // 2
                pad[axis] = (before, target - cur - before)
                out = np.pad(out, pad)
        return out


class IntensityNormalization(EntriesTransform):
    """Per-channel z-score over all voxels: (x - mean) / std of each
    trailing-axis channel, a zero std taken as 1."""

    def __init__(self, entries=("images",)):
        super().__init__(entries)

    def _apply(self, arr):
        arr = arr.astype(np.float32)
        axes = tuple(range(arr.ndim - 1))
        mean = arr.mean(axis=axes, keepdims=True)
        std = arr.std(axis=axes, keepdims=True)
        std = np.where(std == 0, 1.0, std)
        return (arr - mean) / std


class ToBinary(EntriesTransform):
    """Labels > 0 become 1 (a bool array becomes uint8)."""

    def __init__(self, entries=("labels",)):
        super().__init__(entries)

    def _apply(self, arr):
        return (arr > 0).astype(arr.dtype if arr.dtype != np.bool_ else np.uint8)
