"""Small-affine helpers for the host-side maps (float64).

The counterpart of ``unires_tpu.ops.lie``. The JAX package computes its
SE(3) exponential and maps in float32 on the device so that its fit loop can
update poses inside one jitted program. The port's loop runs on the host and
its maps are launch arguments of the kernels: the exponential and its
derivative are :func:`unires_torch.geometry.expm` / ``dexpm`` (float64), and
the maps are composed and inverted here in float64 and cast to float32 once
(:func:`compose_maps`). Expect the last bits of a map to differ from the JAX
package's, which rounds ``pre @ R @ post`` in float32.
"""
from __future__ import annotations

import numpy as np


def inv44(M4) -> np.ndarray:
    """Inverse of a 4x4 affine [L t; 0 1] (float64)."""
    M4 = np.asarray(M4, np.float64)
    Li = np.linalg.inv(M4[:3, :3])
    out = np.eye(4)
    out[:3, :3] = Li
    out[:3, 3] = -(Li @ M4[:3, 3])
    return out


def compose_maps(pre, R, post):
    """(M, Minv): the (3, 4) float32 maps of M4 = pre @ R @ post, composed
    and inverted in float64."""
    M4 = (np.asarray(pre, np.float64) @ np.asarray(R, np.float64)
          @ np.asarray(post, np.float64))
    return (np.ascontiguousarray(M4[:3, :4], dtype=np.float32),
            np.ascontiguousarray(inv44(M4)[:3, :4], dtype=np.float32))
