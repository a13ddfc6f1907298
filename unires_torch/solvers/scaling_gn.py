"""Even/odd slice scaling update (Gauss-Newton, closed form).

The counterpart of ``unires_tpu.solvers.scaling_gn`` (reference
unires/_update.py:270-393, gradient and Hessian from derivations/scaling.m):

    gr  = tau * (sum y_-(x_- - y_-) - sum y_+(x_+ - y_+))
    Hes = tau * (sum y_-^2 + sum y_+^2)

where +/- are the exp(+s) (even-index) / exp(-s) (odd-index) slice groups and
y is the projected reconstruction with the current scaling applied. The
projection (pull + blur) is computed once per observation and update; the
line search only re-applies the diagonal scaling. CT observations are
skipped (reference :286-288). Sums are taken in float64. The step
(:func:`scaling_gn`) decides on the device, its candidates evaluated in turn
until one is accepted (``utils.graph.cond``); the fit chunk runs it in its
graph, the host API (:func:`scaling_step`, :func:`update_scaling`) reads
each decision and the result. The host ``update_scaling`` builds the pose
as the JAX package's does: the uncentred ``expm(q)``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import expm
from ..models.forward import make_obs_suite, obs_dyn_args
from ..models.proj_op import ProjOp
from ..ops.scaling import apply_scaling, even_slices, odd_slices
from ..utils.batch import any_of, sum_f64
from ..utils.graph import cond
from ..utils.host import to_host


def _sums(dat_y0, dat_x, s, axis) -> torch.Tensor:
    """(sum res^2, sum y+(x+ - y+), sum y-(x- - y-), sum y+^2, sum y-^2)
    at scaling ``s``, float64 on the data's device: (5,), or (B, 5) for a
    batch of volumes (B, ...) at scales (B,), each subject summed alone."""
    dat_y = apply_scaling(dat_y0, s, axis)
    msk = dat_x != 0
    res = torch.where(msk, dat_x - dat_y, 0.0)
    y = torch.where(msk, dat_y, 0.0)
    ye, yo = even_slices(y, axis), odd_slices(y, axis)
    xe, xo = even_slices(dat_x, axis), odd_slices(dat_x, axis)
    return torch.stack([sum_f64(res * res), sum_f64(ye * (xe - ye)),
                        sum_f64(yo * (xo - yo)), sum_f64(ye * ye),
                        sum_f64(yo * yo)], dim=-1)


def _res2(dat_y0, dat_x, s, axis) -> torch.Tensor:
    res = torch.where(dat_x != 0, dat_x - apply_scaling(dat_y0, s, axis), 0.0)
    return sum_f64(res * res)


def scaling_stats(dat_y0, dat_x, s, tau, axis) -> np.ndarray:
    """(ll, gr, Hes) at scaling ``s`` (``dat_y0``: unscaled projection)."""
    ll2, sp, sm, he, ho = (float(v) for v in to_host(
        _sums(dat_y0, dat_x, s, axis)))
    return np.array([0.5 * tau * ll2, tau * (sm - sp), tau * (he + ho)])


def scaling_gn(dat_y0, dat_x, s0: torch.Tensor, tau, axis: int,
               num_ls: int = 6, live=None):
    """One Gauss-Newton step with a halving line search from step 1, on
    the device: (s, ll), 0-d float64 tensors, from ``s0`` (0-d float64 on
    the data's device), with nothing read back under a capture. The
    candidates are evaluated in turn, each under ``utils.graph.cond``, and
    the first whose data term falls below the current one is taken, later
    ones not evaluated (the JAX loop's ``while_loop``); none: ``s0`` and the
    current data term. With ``num_ls = 0`` the full step is taken unchecked
    and ll is the current one.

    A batch: volumes (B, ...), ``s0`` and ``tau`` (B,) float64, (s, ll)
    (B,); a candidate is evaluated while some subject has accepted none,
    each subject accepting its first (``vmap`` of the JAX loop), and
    ``live`` (B,) bool leaves the other subjects at ``s0``."""
    ll2, sp, sm, he, ho = _sums(dat_y0, dat_x, s0, axis).unbind(-1)
    ll0 = 0.5 * tau * ll2
    delta = tau * (sm - sp) / torch.clamp(tau * (he + ho), min=1e-30)
    if num_ls == 0:
        return s0 - delta, ll0
    s, ll = s0.clone(), ll0.clone()
    acc = (torch.zeros(s0.shape, dtype=torch.bool, device=s0.device)
           if live is None else ~live)
    for k in range(num_ls):
        def candidate(k=k):
            cand = s0 - 0.5 ** k * delta
            llc = 0.5 * tau * _res2(dat_y0, dat_x, cand, axis)
            ok = llc < ll0
            if ok.numel() > 1:  # one subject runs this only while ~acc
                ok = ok & ~acc
            s.copy_(torch.where(ok, cand, s))
            ll.copy_(torch.where(ok, llc, ll))
            acc.copy_(acc | ok)
        cond(any_of(~acc), candidate)
    return s, ll


def scaling_step(dat_y0, dat_x, s0, tau, axis, num_ls: int = 6):
    """:func:`scaling_gn` from a host scale, read back: (s, ll) floats."""
    s, ll = scaling_gn(dat_y0, dat_x, torch.tensor(
        float(s0), dtype=torch.float64, device=dat_x.device), tau, axis,
        num_ls)
    s, ll = to_host(torch.stack([s, ll]))
    return float(s), float(ll)


def make_scaling_fns(po: ProjOp, method: str):
    """(project, stats, ll_at) for one observation, as the JAX package's."""
    project = make_obs_suite(po, method)["project"]
    axis = po.dim_thick

    def stats(dat_y0, dat_x, s, tau):
        return tuple(scaling_stats(dat_y0, dat_x, s, tau, axis))

    def ll_at(dat_y0, dat_x, s, tau):
        return 0.5 * tau * float(to_host(_res2(dat_y0, dat_x, s, axis)))

    return project, stats, ll_at


def update_scaling(x, y, sett, max_niter_gn: int = 1, num_linesearch: int = 6):
    """Update po.scl for every non-CT observation. Returns (x, sum ll)."""
    sll = 0.0
    for c in range(len(x)):
        for o in x[c]:
            if o.ct:
                continue
            project = make_obs_suite(o.po, sett.method)["project"]
            rigid = o.po.rigid
            if o.rigid_q is not None:
                rigid = expm(o.rigid_q, sett.rigid_basis)
            M, _ = obs_dyn_args(o.po, "super-resolution", rigid)
            dat_y0 = project(y[c].dat, M)
            tau = float(np.float32(o.tau))
            scl = float(o.po.scl)
            ll = None
            for _ in range(max_niter_gn):
                scl, ll = scaling_step(dat_y0, o.dat, scl, tau,
                                       o.po.dim_thick, num_linesearch)
            o.po.scl = float(scl)
            if ll is not None:
                sll += float(ll)
    return x, sll
