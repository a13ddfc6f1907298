"""Batched preconditioned conjugate gradients with a per-channel residual stop.

The iteration of ``unires_tpu.solvers.cg.cg_batched``: every batch (channel)
entry follows the trajectory a lone residual-stop PCG would give it —
per-entry alpha/beta from inner products over the volume axes, entries that
reach their stopping residual are FROZEN (alpha = 0, p and rz held) while the
rest iterate — and the operator and preconditioner act on the whole stack.

The stop test needs the device's answer on the host: ``bool(live.any())``
costs one synchronisation per CG step. It keeps the iteration counts of the
JAX solver exactly (running all ``max_iter`` steps with frozen channels would
give the same iterates at up to ~5x the work, since warm-started solves stop
after a few steps).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.host import to_host


def cg_batched(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
               x0: torch.Tensor, max_iter: int = 20, tol: float = 1e-3,
               precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
               verbose: bool = False, return_iters: bool = False):
    """Solve A x = b per leading-axis entry (SPD, matrix-free), from x0."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    axes = tuple(range(1, b.dim()))

    def dot(a, c):
        return torch.sum(a * c, dim=axes)

    def bc(s):
        return s.reshape(s.shape + (1,) * (b.dim() - 1))

    tiny = 1e-30
    x = x0
    r = b - A(x)
    p = precond(r)
    rz = dot(r, p)
    ref = (tol * tol) * torch.clamp(dot(b, precond(b)), min=tiny)
    live = torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
    it = 0
    while it < max_iter and bool(to_host(live.any())):  # one sync per step
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(live, rz / torch.clamp(pAp, min=tiny), 0.0)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * Ap
        z = precond(r)
        rz_new = torch.where(live, dot(r, z), rz)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = torch.where(bc(live), z + bc(beta) * p, p)
        live = live & (rz_new >= ref)
        rz = rz_new
        if verbose:  # Settings.cgs_verbose
            print(f"cg it={it} rz={rz.tolist()}")
        it += 1
    if return_iters:
        return x, it
    return x
