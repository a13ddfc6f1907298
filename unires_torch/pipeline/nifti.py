"""Self-contained NIfTI-1 reader/writer (host-side).

The reference delegates NIfTI I/O to nitorch.io/nibabel (unires/_util.py:
134-226); this package ships its own codec (a copy of
``unires_tpu.pipeline.nifti``):
header parse/build, sform/qform affines, scl_slope/inter scaling, gzip, and
save-like-source. Covers the subset of NIfTI-1 the pipeline needs (3D/4D
scalar volumes); raises clearly on anything exotic.
"""
from __future__ import annotations

import dataclasses
import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

_HDR_SIZE = 348
_MAGIC1 = b"n+1\x00"
_MAGIC1_PAIR = b"ni1\x00"

# NIfTI datatype code -> numpy dtype
_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiHeader:
    dim: Tuple[int, ...]
    dtype: np.dtype
    affine: np.ndarray  # (4,4) f64, index -> mm (0-based voxel convention)
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    pixdim: Tuple[float, ...] = None
    descrip: bytes = b"unires-tpu"
    raw: Optional[bytes] = None  # original header bytes (save-like-source)


def _quaternion_to_rot(b, c, d):
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    return np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])


def _parse_header(hdr: bytes) -> NiftiHeader:
    if len(hdr) < _HDR_SIZE:
        raise ValueError("Truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", hdr, 0)[0]
    endian = "<"
    if sizeof_hdr != _HDR_SIZE:
        sizeof_hdr_be = struct.unpack_from(">i", hdr, 0)[0]
        if sizeof_hdr_be == _HDR_SIZE:
            endian = ">"
        else:
            raise ValueError("Not a NIfTI-1 file (bad sizeof_hdr)")
    u = lambda fmt, off: struct.unpack_from(endian + fmt, hdr, off)
    magic = hdr[344:348]
    if magic not in (_MAGIC1, _MAGIC1_PAIR):
        raise ValueError(f"Unsupported NIfTI magic {magic!r}")
    ndim = u("h", 40)[0]
    dims = u("8h", 40)[1:]
    if not (1 <= ndim <= 7):
        raise ValueError(f"Bad ndim {ndim}")
    shape = tuple(int(d) for d in dims[:ndim])
    datatype = u("h", 70)[0]
    if datatype not in _DTYPES:
        raise ValueError(f"Unsupported NIfTI datatype {datatype}")
    dt = np.dtype(_DTYPES[datatype]).newbyteorder(endian)
    pixdim = u("8f", 76)
    vox_offset = u("f", 108)[0]
    scl_slope = u("f", 112)[0]
    scl_inter = u("f", 116)[0]
    qform_code = u("h", 252)[0]
    sform_code = u("h", 254)[0]
    if sform_code > 0:
        sx = u("4f", 280)
        sy = u("4f", 296)
        sz = u("4f", 312)
        affine = np.array([sx, sy, sz, [0, 0, 0, 1]], dtype=np.float64)
    elif qform_code > 0:
        b, c, d = u("3f", 256)
        qx, qy, qz = u("3f", 268)
        R = _quaternion_to_rot(b, c, d)
        qfac = pixdim[0] if pixdim[0] in (-1.0, 1.0) else 1.0
        Z = np.diag([pixdim[1], pixdim[2], pixdim[3] * qfac])
        affine = np.eye(4)
        affine[:3, :3] = R @ Z
        affine[:3, 3] = (qx, qy, qz)
    else:
        affine = np.diag([pixdim[1] or 1.0, pixdim[2] or 1.0, pixdim[3] or 1.0, 1.0])
    return NiftiHeader(
        dim=shape, dtype=dt, affine=affine,
        scl_slope=float(scl_slope) if scl_slope not in (0.0,) else 1.0,
        scl_inter=float(scl_inter),
        pixdim=tuple(float(p) for p in pixdim[1:1 + len(shape)]),
        raw=bytes(hdr[:_HDR_SIZE]),
    ), float(vox_offset), endian


def _open(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: str):
    """Read a NIfTI-1 volume -> (data float32 array, header).

    Applies scl_slope/inter; data is returned in Fortran voxel order
    (x fastest in file -> numpy array with shape dim and C-contiguous copy).
    """
    with _open(path, "rb") as f:
        blob = f.read()
    hdr, vox_offset, endian = _parse_header(blob[:_HDR_SIZE + 4])
    n = int(np.prod(hdr.dim))
    off = int(vox_offset) if vox_offset else _HDR_SIZE + 4
    raw = np.frombuffer(blob, dtype=hdr.dtype, count=n, offset=off)
    dat = raw.reshape(hdr.dim, order="F").astype(np.float32)
    if hdr.scl_slope not in (0.0, 1.0) or hdr.scl_inter != 0.0:
        dat = dat * np.float32(hdr.scl_slope) + np.float32(hdr.scl_inter)
    return np.ascontiguousarray(dat), hdr


def _build_header(shape, dtype, affine, descrip=b"unires-tpu") -> bytes:
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dims = [len(shape)] + list(shape) + [1] * (7 - len(shape))
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, _CODES[np.dtype(dtype)])
    struct.pack_into("<h", hdr, 72, np.dtype(dtype).itemsize * 8)  # bitpix
    vx = np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(0))
    pixdim = [1.0] + list(vx) + [1.0] * (7 - len(shape)) + [0.0] * max(0, len(shape) - 3)
    struct.pack_into("<8f", hdr, 76, *pixdim[:8])
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)  # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)  # scl_inter
    struct.pack_into("<80s", hdr, 148, descrip[:80])
    struct.pack_into("<h", hdr, 252, 0)  # qform_code
    struct.pack_into("<h", hdr, 254, 2)  # sform_code = aligned
    A = np.asarray(affine, np.float64)
    struct.pack_into("<4f", hdr, 280, *A[0])
    struct.pack_into("<4f", hdr, 296, *A[1])
    struct.pack_into("<4f", hdr, 312, *A[2])
    struct.pack_into("<4s", hdr, 344, _MAGIC1)
    return bytes(hdr)


def save(dat, path: str, affine=None, like: Optional[NiftiHeader] = None,
         dtype=np.float32):
    """Write a NIfTI-1 volume. ``like`` reuses the source header's affine if
    no explicit affine is given (reference savef(..., like=file))."""
    dat = np.asarray(dat)
    if affine is None:
        affine = like.affine if like is not None else np.eye(4)
    hdr = _build_header(dat.shape, np.dtype(dtype), affine)
    body = np.asarray(dat, dtype=np.dtype(dtype)).flatten(order="F").tobytes()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with _open(path, "wb") as f:
        f.write(hdr)
        f.write(b"\x00\x00\x00\x00")
        f.write(body)
    return path
