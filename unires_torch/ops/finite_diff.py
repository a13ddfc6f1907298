"""Finite-difference gradient / divergence (D and D^T) for the JTV prior.

The semantics of ``unires_tpu.ops.finite_diff`` (nitorch im_gradient /
im_divergence as pinned by the reference, unires/_project.py:314-315,
unires/_update.py:132, 168-193): difference type 'forward' | 'backward' |
'central', voxel-size scaled, Dirichlet-zero bound, and ``im_divergence`` the
EXACT adjoint of ``im_gradient`` (the solver adds rho lam^2 D^T D to the CG
normal matrix, so adjointness is load-bearing).

Layout: the gradient of a (X, Y, Z) image is (3, X, Y, Z); leading axes
(a batch of images) ride along, (..., X, Y, Z) -> (..., 3, X, Y, Z).
"""
from __future__ import annotations

import torch


def _roll_zero(u: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """Shift with zero fill (Dirichlet bound): shift 1 -> u[i-1], -1 -> u[i+1]."""
    n = u.shape[axis]
    zero = torch.zeros_like(u.narrow(axis, 0, 1))
    if shift == 1:
        return torch.cat([zero, u.narrow(axis, 0, n - 1)], dim=axis)
    if shift == -1:
        return torch.cat([u.narrow(axis, 1, n - 1), zero], dim=axis)
    raise ValueError(shift)


def im_gradient(dat: torch.Tensor, vx, which: str = "forward") -> torch.Tensor:
    """D dat: (..., 3, X, Y, Z), per-axis finite difference divided by voxel
    size."""
    gs = []
    for d in range(3):
        ax = d - 3
        if which == "forward":
            g = _roll_zero(dat, -1, ax) - dat
        elif which == "backward":
            g = dat - _roll_zero(dat, 1, ax)
        elif which == "central":
            g = 0.5 * (_roll_zero(dat, -1, ax) - _roll_zero(dat, 1, ax))
        else:
            raise ValueError(which)
        gs.append(g / float(vx[d]))
    return torch.stack(gs, dim=-4)


def im_divergence(p: torch.Tensor, vx, which: str = "forward") -> torch.Tensor:
    """D^T p: exact adjoint of :func:`im_gradient` (NOT the negative adjoint)."""
    out = torch.zeros_like(p.select(-4, 0))
    for d in range(3):
        ax = d - 3
        q = p.select(-4, d)
        if which == "forward":
            a = _roll_zero(q, 1, ax) - q
        elif which == "backward":
            a = q - _roll_zero(q, -1, ax)
        elif which == "central":
            a = 0.5 * (_roll_zero(q, 1, ax) - _roll_zero(q, -1, ax))
        else:
            raise ValueError(which)
        out = out + a / float(vx[d])
    return out


def DtD(dat: torch.Tensor, vx, which: str = "forward") -> torch.Tensor:
    """D^T (D dat), the membrane operator of the CG normal matrix."""
    return im_divergence(im_gradient(dat, vx, which), vx, which)
