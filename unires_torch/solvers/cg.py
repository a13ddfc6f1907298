"""Matrix-free preconditioned conjugate gradients: ``cg`` for one system
(max-gain or residual stop) and ``cg_batched`` over a leading (channel)
axis with a per-entry residual stop.

``cg`` re-implements nitorch.core.optim.cg as the reference's y-update calls
it (unires/_update.py:140-148: 20 iterations, stop='max_gain', tol 1e-3),
after ``unires_tpu.solvers.cg.cg``. Gain (nitorch get_gain): gain_k =
(f_{k-1} - f_k) / (max f - min f) over the objective trace f_k = 1/2 x^T A x
- b^T x, tracked by a running max and min.

``cg_batched`` is the iteration of ``unires_tpu.solvers.cg.cg_batched``:
every batch (channel, or subject and channel) entry follows the trajectory
``cg(..., stop='residual')`` would give it alone —
per-entry alpha/beta from inner products over the volume axes, entries that
reach their stopping residual are FROZEN (alpha = 0, p and rz held) while the
rest iterate — and the operator and preconditioner act on the whole stack.

Each step of ``cg_batched`` runs under ``utils.graph.cond(live.any())``: in
a captured graph (the fit chunk on the card) a conditional IF node whose
predicate the device reads, so that the host reads nothing and a step after
the stop launches nothing; elsewhere one host read per step, and the loop
ends at the first false one. Either way the iteration counts are the JAX
solver's exactly (running all ``max_iter`` steps with frozen channels would
give the same iterates at up to ~5x the work, since warm-started solves stop
after a few steps). Its iterates are updated in place inside the step.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.graph import capturing, cond
from ..utils.host import to_host


def cg(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       x0: torch.Tensor, max_iter: int = 20, tol: float = 1e-3,
       precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
       stop: str = "max_gain") -> torch.Tensor:
    """Solve A x = b for SPD matrix-free A, starting at x0.

    stop='max_gain' mirrors the reference (objective gain normalised by the
    trace's own range; it rarely fires on warm starts, so it effectively
    runs max_iter, like the reference). stop='residual' exits when the
    preconditioned residual energy <r, P r> drops below tol^2 of <b, P b>:
    an absolute criterion, so warm starts that are already converged exit
    after one iteration. Either test reads one flag from the device per
    step.
    """
    if precond is None:
        precond = lambda v: v  # noqa: E731

    def dot(a, c):
        return torch.sum(a * c)

    tiny = 1e-30
    x = x0
    r = b - A(x)
    p = precond(r)
    rz = dot(r, p)
    if stop == "residual":
        ref = (tol * tol) * torch.clamp(dot(b, precond(b)), min=tiny)
    # objective f = 1/2 x^T A x - b^T x = -1/2 (<x, b> + <x, r>)
    f_prev = f_max = f_min = -0.5 * (dot(x, b) + dot(x, r))
    for it in range(max_iter):
        Ap = A(p)
        alpha = rz / torch.clamp(dot(p, Ap), min=tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        p = z + (rz_new / torch.clamp(rz, min=tiny)) * p
        rz = rz_new
        if stop == "residual":
            done = rz_new < ref
        else:
            f = -0.5 * (dot(x, b) + dot(x, r))
            f_max = torch.maximum(f_max, f)
            f_min = torch.minimum(f_min, f)
            gain = (f_prev - f) / torch.clamp(f_max - f_min, min=tiny)
            done = (gain.abs() < tol) & (it >= 1)
            f_prev = f
        if bool(to_host(done)):
            break
    return x


def cg_batched(A: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
               x0: torch.Tensor, max_iter: int = 20, tol: float = 1e-3,
               precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
               verbose: bool = False, return_iters: bool = False,
               groups: int = 1, live: Optional[torch.Tensor] = None):
    """Solve A x = b per leading-axis entry (SPD, matrix-free), from x0.
    ``return_iters`` also returns the steps taken, a 0-d int64 tensor.

    ``groups``: the entries are that many equal runs (the subjects of a
    batched fit, each run its channels), and each run's inner products are
    reduced on their own, as that subject's would be alone. ``live``: a
    bool per entry, False for entries that stay at x0 (a frozen subject's);
    by default every entry is solved."""
    if precond is None:
        precond = lambda v: v  # noqa: E731
    axes = tuple(range(1, b.dim()))

    def dot(a, c):
        if groups == 1:
            return torch.sum(a * c, dim=axes)
        return torch.cat([torch.sum(q, dim=axes)
                          for q in (a * c).chunk(groups)])

    def bc(s):
        return s.reshape(s.shape + (1,) * (b.dim() - 1))

    tiny = 1e-30
    x = x0.clone()
    r = b - A(x)
    p = precond(r).clone()  # updated in place: never the residual itself
    rz = dot(r, p)
    ref = (tol * tol) * torch.clamp(dot(b, precond(b)), min=tiny)
    live = (torch.ones(b.shape[0], dtype=torch.bool, device=b.device)
            if live is None else live.clone())
    its = torch.zeros((), dtype=torch.int64, device=b.device)

    def step():
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(live, rz / torch.clamp(pAp, min=tiny), 0.0)
        x.add_(bc(alpha) * p)
        r.sub_(bc(alpha) * Ap)
        z = precond(r)
        rz_new = torch.where(live, dot(r, z), rz)
        beta = rz_new / torch.clamp(rz, min=tiny)
        torch.where(bc(live), z + bc(beta) * p, p, out=p)
        live.copy_(live & (rz_new >= ref))
        rz.copy_(rz_new)
        its.add_(1)
        if verbose and not capturing():  # Settings.cgs_verbose
            print(f"cg it={int(its) - 1} rz={rz.tolist()}")

    for _ in range(max_iter):
        if not cond(live.any(), step):
            break
    if return_iters:
        return x, its
    return x
