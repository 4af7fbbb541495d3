"""Minimal, dependency-free NIfTI-1 I/O (.nii / .nii.gz) with ITK-style metadata.

The port's own copy of ``rcu_tpu/data/nifti.py`` (numpy only), so the
PyTorch package imports nothing of the JAX package. Host-side I/O only.

Conventions (matching SimpleITK so artifacts interoperate):
- arrays are returned/accepted in numpy [z, y, x] index order (like
  ``sitk.GetArrayFromImage``);
- :class:`ImageProperties` carries size (x,y,z), spacing, origin and direction
  in ITK's LPS world frame; NIfTI stores RAS, so the affine x/y rows are
  negated on write and read (the standard ITK<->NIfTI flip).
"""
from __future__ import annotations

import dataclasses
import gzip
import struct

import numpy as np

_DTYPES = {2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
           256: np.int8, 512: np.uint16, 768: np.uint32}
_CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.int32): 8,
          np.dtype(np.float32): 16, np.dtype(np.float64): 64, np.dtype(np.int8): 256,
          np.dtype(np.uint16): 512, np.dtype(np.uint32): 768}


@dataclasses.dataclass
class ImageProperties:
    """Geometry of a (2D/3D) image, ITK-style (pymia ImageProperties parity)."""
    size: tuple            # (x, y[, z])
    spacing: tuple = None  # per-axis mm
    origin: tuple = None   # world coords of voxel (0,0,0), LPS
    direction: tuple = None  # row-major 3x3 cosines, LPS

    def __post_init__(self):
        ndim = len(self.size)
        if self.spacing is None:
            self.spacing = (1.0,) * ndim
        if self.origin is None:
            self.origin = (0.0,) * ndim
        if self.direction is None:
            self.direction = tuple(np.eye(3).ravel())

    def direction_matrix(self):
        return np.asarray(self.direction, np.float64).reshape(3, 3)


def _affine_lps_to_ras(props: ImageProperties):
    """ITK (LPS) geometry -> NIfTI sform (RAS) 4x4 affine."""
    size3 = tuple(props.size) + (1,) * (3 - len(props.size))
    spacing3 = tuple(props.spacing) + (1.0,) * (3 - len(props.spacing))
    origin3 = tuple(props.origin) + (0.0,) * (3 - len(props.origin))
    d = props.direction_matrix()
    affine = np.eye(4)
    affine[:3, :3] = d @ np.diag(spacing3)
    affine[:3, 3] = origin3
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])  # LPS -> RAS
    return flip @ affine, size3


def _affine_ras_to_props(affine, size3, ndim):
    flip = np.diag([-1.0, -1.0, 1.0, 1.0])
    lps = flip @ affine
    m = lps[:3, :3]
    spacing = np.linalg.norm(m, axis=0)
    spacing[spacing == 0] = 1.0
    direction = m / spacing
    origin = lps[:3, 3]
    return ImageProperties(
        size=tuple(int(s) for s in size3[:ndim]),
        spacing=tuple(float(s) for s in spacing[:ndim]),
        origin=tuple(float(o) for o in origin[:ndim]),
        direction=tuple(float(v) for v in direction.ravel()),
    )


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        if "w" in mode:
            # level 1: ~5x faster than the default 9 on float volumes for a
            # few % size — artifact writing is on the test-loop critical path
            return gzip.open(path, mode, compresslevel=1)
        return gzip.open(path, mode)
    return open(path, mode)


def _qform_affine(hdr, endian, pixdim):
    """NIfTI-1 method-2 (qform) affine: quaternion rotation x voxel spacing
    + qoffset translation (the spec's fallback when no sform is present —
    typical FSL output; dropping it would silently lose origin/direction)."""
    b, c, d = struct.unpack_from(endian + "3f", hdr, 256)
    qoffset = struct.unpack_from(endian + "3f", hdr, 268)
    a2 = 1.0 - (b * b + c * c + d * d)
    a = float(np.sqrt(max(0.0, a2)))
    rot = np.array([
        [a * a + b * b - c * c - d * d, 2 * b * c - 2 * a * d,
         2 * b * d + 2 * a * c],
        [2 * b * c + 2 * a * d, a * a + c * c - b * b - d * d,
         2 * c * d - 2 * a * b],
        [2 * b * d - 2 * a * c, 2 * c * d + 2 * a * b,
         a * a + d * d - b * b - c * c],
    ])
    qfac = -1.0 if pixdim[0] < 0 else 1.0
    spacing = [p if p != 0 else 1.0 for p in pixdim[1:4]]
    affine = np.eye(4)
    affine[:3, :3] = rot @ np.diag([spacing[0], spacing[1],
                                    qfac * spacing[2]])
    affine[:3, 3] = qoffset
    return affine


def read(path: str):
    """Read a NIfTI-1 file -> (array in [z,y,x] order, ImageProperties)."""
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        endian = ">"
        if struct.unpack_from(">i", hdr, 0)[0] != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
    dim = struct.unpack_from(endian + "8h", hdr, 40)
    ndim = int(dim[0])
    shape_xyz = [max(1, int(d)) for d in dim[1:1 + ndim]]
    size3 = (shape_xyz + [1, 1, 1])[:3]
    datatype = struct.unpack_from(endian + "h", hdr, 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    vox_offset = int(struct.unpack_from(endian + "f", hdr, 108)[0]) or 352
    scl_slope, scl_inter = struct.unpack_from(endian + "2f", hdr, 112)
    sform_code = struct.unpack_from(endian + "h", hdr, 254)[0]
    srow = np.array(struct.unpack_from(endian + "12f", hdr, 280)).reshape(3, 4)
    pixdim = struct.unpack_from(endian + "8f", hdr, 76)

    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=vox_offset)
    # NIfTI data is x-fastest; reshape reversed -> [.., z, y, x]
    array = data.reshape(shape_xyz[::-1])
    # NIfTI-1 spec: scaling is DISABLED when scl_slope is 0 (scl_inter is
    # then meaningless — an uninitialized header must not add a bogus
    # offset), and a NaN slope (written by some converters) means unset.
    # A NaN INTERCEPT with a valid slope also means unset (nibabel treats
    # it as 0) — adding it would silently turn every voxel into NaN.
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if (np.isfinite(scl_slope) and scl_slope != 0.0
            and (scl_slope != 1.0 or scl_inter != 0.0)):
        array = array * scl_slope + scl_inter

    qform_code = struct.unpack_from(endian + "h", hdr, 252)[0]
    affine = np.eye(4)
    if sform_code > 0:
        affine[:3, :] = srow
    elif qform_code > 0:
        affine = _qform_affine(hdr, endian, pixdim)
    else:
        affine[:3, :3] = np.diag([p if p != 0 else 1.0 for p in pixdim[1:4]])
    props = _affine_ras_to_props(affine, size3, min(ndim, 3))
    if not array.flags.writeable:
        # unscaled reads view the immutable file buffer; hand the caller a
        # writable array so in-place ops don't raise data-dependently
        array = array.copy()
    return np.ascontiguousarray(array), props


def write(array: np.ndarray, path: str, props: ImageProperties = None):
    """Write an array in [z,y,x] order to a NIfTI-1 file."""
    array = np.asarray(array)
    # normalize byte order first: the _CODES lookup is byte-order sensitive,
    # and a big-endian int array (e.g. round-tripped from a >i2 file) must
    # stay integer, not silently fall through to float32
    native = array.dtype.newbyteorder("=")
    if array.dtype != native:
        array = array.astype(native)
    if array.dtype == np.bool_:
        array = array.astype(np.uint8)
    if array.dtype not in _CODES:
        array = array.astype(np.float32)
    ndim = array.ndim
    shape_xyz = array.shape[::-1]
    if props is None:
        props = ImageProperties(size=shape_xyz[:3] if ndim >= 3 else shape_xyz)
    affine, _ = _affine_lps_to_ras(props)

    hdr = bytearray(352)
    struct.pack_into("<i", hdr, 0, 348)
    dim = [ndim] + [int(s) for s in shape_xyz] + [1] * (7 - ndim)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, _CODES[array.dtype])
    struct.pack_into("<h", hdr, 72, array.dtype.itemsize * 8)  # bitpix
    spacing3 = tuple(props.spacing) + (1.0,) * (7 - len(props.spacing))
    struct.pack_into("<8f", hdr, 76, 1.0, *spacing3)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope/inter
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0 (unset), sform_code=1
    struct.pack_into("<12f", hdr, 280, *affine[:3, :].ravel())
    hdr[344:348] = b"n+1\x00"

    with _open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.ascontiguousarray(array).tobytes())
