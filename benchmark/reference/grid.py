"""The recon grid's rules that the judge works out again: whether UniRes
fits super-resolution or denoising, and the common output grid that its
``--common_output`` states: the atlas brain box at the recon voxel size,
each dim padded to the smaller of 2 * 2^k and 3 * 2^k (at most ``pow``), the
box centred in the padded grid."""
from __future__ import annotations

import numpy as np

from reference.forward import voxel_size


def super_resolution(vx, headers) -> bool:
    """Whether UniRes' ``_format_y`` (unires/_core.py:209-260) fits
    super-resolution, else denoising, for inputs of voxel-to-world
    ``headers`` at the recon voxel size ``vx`` (0 or None: the inputs'
    own): unless every input has one voxel size (to 3 decimals of a mm) and
    that is the recon's (to 1e-3 mm)."""
    vxs = [voxel_size(h) for h in headers]
    same = all(np.array_equal(np.round(v, 3), np.round(vxs[0], 3))
               for v in vxs[1:])
    if vx is None or (np.ndim(vx) == 0 and float(vx) == 0.0):
        return not same
    vx = np.broadcast_to(np.asarray(vx, np.float64), (3,))
    return not (same and bool((np.abs(vxs[0] - vx) < 1e-3).all()))


def _ceil_pow(n, lead, cap):
    """The least lead * 2^k >= n, at most ``cap``."""
    val = float(lead)
    while val < n:
        val *= 2.0
    return min(val, float(cap))


def common_grid(spec, vx):
    """(mat, dims) of the grid of ``spec`` (``bb_min_mm``, ``bb_max_mm``,
    ``pow``) at voxel size ``vx`` (3,)."""
    lo = np.asarray(spec["bb_min_mm"], np.float64)
    hi = np.asarray(spec["bb_max_mm"], np.float64)
    vx = np.asarray(vx, np.float64)
    dim = np.floor((hi - lo + 1.0) / vx)
    ndim = np.array([min(_ceil_pow(n, 2, spec["pow"]),
                         _ceil_pow(n, 3, spec["pow"])) for n in dim])
    mat = np.eye(4)
    mat[:3, 3] = lo
    mat = mat @ np.diag(np.r_[vx, 1.0])
    shift = np.eye(4)
    shift[:3, 3] = -np.round((ndim - dim) / 2.0)
    return mat @ shift, tuple(int(n) for n in ndim)
