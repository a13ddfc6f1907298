"""The common output grid that UniRes' ``--common_output`` states: the atlas
brain box at the recon voxel size, each dim padded to the smaller of 2 * 2^k
and 3 * 2^k (at most ``pow``), the box centred in the padded grid."""
from __future__ import annotations

import numpy as np


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
