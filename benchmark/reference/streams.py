"""The documented random streams that the program and the reference both
follow, re-derived here from their definitions, and the training order.

- A dropout generator is named by a tuple of ints: MC sample ``t`` of
  slice batch ``b`` of eval item ``i`` under run seed ``s`` is
  ``(s, i, b, t)``; train step ``k`` of epoch ``e`` under config seed
  ``s`` is ``(s, e, k)``. The name goes through numpy's
  ``SeedSequence``, whose first two 32-bit words ``w0, w1`` seed a
  ``torch.Generator`` on the device with ``(w0 << 31) ^ w1``.
- Each dropout site, in forward order, draws ``rand((rows, channels))``
  from its sample's generator and keeps a channel where the draw is below
  ``1 - p``.
- A training epoch visits the selected slices (subject-major, ascending
  z, slices with any voxel above 0) in the order of
  ``numpy.random.RandomState(seed + epoch).shuffle``.
"""
from __future__ import annotations

import numpy as np
import torch


def generator(names, device) -> torch.Generator:
    words = np.random.SeedSequence([int(n) for n in names]) \
        .generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return g


class Masks:
    """The channel-dropout draws of one sample's forward: each call is the
    next site's keep mask (rows, channels)."""

    def __init__(self, gen: torch.Generator, keep: float):
        self.gen, self.keep = gen, keep

    def __call__(self, rows: int, channels: int, device) -> torch.Tensor:
        return torch.rand((rows, channels), generator=self.gen,
                          device=device) < self.keep


def epoch_order(n_items: int, seed: int, epoch: int) -> np.ndarray:
    order = np.arange(n_items)
    np.random.RandomState(seed + epoch).shuffle(order)
    return order


def none_black(volume: np.ndarray) -> list:
    """The z indices of a (Z, H, W, C) volume with any voxel above 0."""
    return [z for z in range(volume.shape[0]) if np.any(volume[z] > 0)]
