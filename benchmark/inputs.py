"""Seeded inputs and weights, made on the device from ``--seed`` in a few
large draws, and the in-memory datasets that hand them to the program
through its dataset interface (``subjects``, ``read_volume``,
``read_slice``, ``shape``, ``files``).

- BraTS-like volumes (Z, H, W, 4) float32: an ellipsoid head of z-scored
  noise, a spherical lesion (+2 in every channel) as the target, and the
  raw t2 of the head as a gzip NIfTI file (the eval's foreground mask is
  ``t2 > 0``).
- ISIC-like images (H, W, 3) uint8: a skin tone with noise and a darker
  elliptic lesion, the mask {0, 255}; the ISIC test config rescales both
  to [0, 1] per image.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np
import torch

from benchmark.reference import streams
from benchmark.reference.unet import calibrate, seeded_weights

WEIGHTS, DATA = 0, 1  # the two streams drawn from a run's seed


def generator(seed: int, stream: int, device) -> torch.Generator:
    return streams.generator((seed, stream), device)


def write_nifti_gz(array: np.ndarray, path: str) -> None:
    """A NIfTI-1 file of an int16 (Z, Y, X) array, unit spacing."""
    z, y, x = array.shape
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, x, y, z, 1, 1, 1, 1)
    struct.pack_into("<hh", hdr, 70, 4, 16)  # int16
    struct.pack_into("<8f", hdr, 76, 1, 1, 1, 1, 1, 1, 1, 1)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, 1.0)
    hdr[344:348] = b"n+1\0"
    with gzip.open(path, "wb", compresslevel=1) as f:
        f.write(bytes(hdr) + b"\0" * 4)
        f.write(np.ascontiguousarray(array, "<i2").tobytes())


def brats_volumes(n: int, shape, channels: int, seed: int, device) -> list:
    """``n`` subjects: {images (Z, H, W, C) float32, labels (Z, H, W)
    uint8, head (Z, H, W) bool}, numpy on the host."""
    gen = generator(seed, DATA, device)
    size = torch.tensor(shape, dtype=torch.float32, device=device)
    grid = torch.meshgrid(*(torch.arange(s, device=device, dtype=torch.float32)
                            for s in shape), indexing="ij")
    head = sum(((g - s / 2) / (f * s)) ** 2 for g, s, f in
               zip(grid, size, (0.45, 0.4, 0.33))) < 1.0
    spots = size / 2 + (torch.rand((n, 3), generator=gen, device=device)
                        * 0.3 - 0.15) * size
    radius = 0.08 * float(size[1])
    out = []
    for i in range(n):
        lesion = sum(((g - c) / radius) ** 2
                     for g, c in zip(grid, spots[i])) < 1.0
        images = torch.randn(tuple(shape) + (channels,), generator=gen,
                             device=device)
        images = images * head[..., None] + 2.0 * (lesion & head)[..., None]
        out.append({"images": images.cpu().numpy(),
                    "labels": (lesion & head).to(torch.uint8).cpu().numpy(),
                    "head": head.cpu().numpy()})
    return out


def isic_images(n: int, shape, seed: int, device, block: int = 100) -> dict:
    """{images (n, H, W, 3) uint8, labels (n, H, W) uint8 {0, 255}}."""
    gen = generator(seed, DATA, device)
    h, w = shape
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    images, labels = [], []
    for lo in range(0, n, block):
        k = min(block, n - lo)
        u = torch.rand((k, 4), generator=gen, device=device)
        cy, cx = (0.3 + 0.4 * u[:, 0]) * h, (0.3 + 0.4 * u[:, 1]) * w
        ry, rx = (0.1 + 0.2 * u[:, 2]) * h, (0.1 + 0.2 * u[:, 3]) * w
        dist = ((yy - cy[:, None, None]) / ry[:, None, None]) ** 2 \
            + ((xx - cx[:, None, None]) / rx[:, None, None]) ** 2
        inside = dist < 1.0
        skin = torch.randint(150, 230, (k, 1, 1, 3), generator=gen,
                             device=device)
        spot = torch.randint(40, 130, (k, 1, 1, 3), generator=gen,
                             device=device)
        noise = torch.randint(0, 40, (k, h, w, 3), generator=gen,
                              device=device)
        image = torch.where(inside[..., None], spot, skin) + noise
        images.append(image.clamp(0, 255).to(torch.uint8).cpu())
        labels.append((inside.to(torch.uint8) * 255).cpu())
    return {"images": torch.cat(images).numpy(),
            "labels": torch.cat(labels).numpy()}


def rescaled(images: np.ndarray) -> np.ndarray:
    """Each image (or mask) min-max rescaled to [0, 1] in float32."""
    x = images.astype(np.float32)
    axes = tuple(range(1, x.ndim))
    lo, hi = x.min(axes, keepdims=True), x.max(axes, keepdims=True)
    return (x - lo) / (hi - lo)


def weights(model: dict, seed: int, device, calibration=None,
            background=None) -> dict:
    """The seeded weights of the published U-Net; inference weights
    (``calibration``: NCHW images; ``background``: their empty pixels)
    get calibrated BatchNorms and a fitted class head
    (``reference.unet.calibrate``)."""
    w = seeded_weights(model, generator(seed, WEIGHTS, device), device)
    if calibration is not None:
        calibrate(w, calibration, int(model["depth"]), background=background)
    return w


class VolumePool:
    """Named subjects over a pool of volumes: subject ``k`` of the list is
    volume ``k % len(pool)``; ``t2_dir`` holds each volume's raw t2."""

    def __init__(self, volumes: list, names: list, t2_dir: str = None):
        self.volumes, self.subjects = volumes, list(names)
        self.index = {name: k % len(volumes) for k, name in enumerate(names)}
        self.t2 = []
        if t2_dir is not None:
            os.makedirs(t2_dir, exist_ok=True)
            for k, volume in enumerate(volumes):
                path = os.path.join(t2_dir, f"t2_{k}.nii.gz")
                write_nifti_gz(volume["head"].astype(np.int16) * 100, path)
                self.t2.append(path)

    def named(self, names: list) -> "VolumePool":
        """The same volumes and t2 files under the subject list ``names``."""
        view = object.__new__(VolumePool)
        view.volumes, view.t2 = self.volumes, self.t2
        view.subjects = list(names)
        view.index = {name: k % len(self.volumes)
                      for k, name in enumerate(names)}
        return view

    def volume(self, subject: str) -> dict:
        return self.volumes[self.index[subject]]

    def read_volume(self, subject, category):
        return self.volume(subject)[category]

    def read_slice(self, subject, index, category):
        return self.volume(subject)[category][index]

    def shape(self, subject, category="images"):
        return self.volume(subject)[category].shape

    def dtype(self, subject, category="images"):
        return self.volume(subject)[category].dtype

    def categories(self, subject=None):
        return ["images", "labels"]

    def files(self, subject):
        return {"images": {"t2": self.t2[self.index[subject]]}} if self.t2 \
            else {}


class ImagePool:
    """Named images over a pool: image ``k`` of the list is pool image
    ``k % len(pool)``."""

    def __init__(self, data: dict, names: list):
        self.data, self.subjects = data, list(names)
        n = len(data["images"])
        self.index = {name: k % n for k, name in enumerate(names)}

    def read_volume(self, subject, category):
        return self.data[category][self.index[subject]]

    def read_slice(self, subject, index, category):
        return self.read_volume(subject, category)

    def shape(self, subject, category="images"):
        return self.data[category].shape[1:]

    def categories(self, subject=None):
        return ["images", "labels"]

    def files(self, subject):
        return {}
