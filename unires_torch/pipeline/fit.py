"""Fit orchestrator: the host-driven outer loop.

Mirrors ``unires_tpu.pipeline.fit`` (reference ``fit``, unires/run.py:24-207):
lambda schedule with countdowns, gain-based convergence, FOV cleaning and
rigid-matrix collection. One outer iteration per step
(``solvers.fitloop.make_fit_iteration``); the rigid and even/odd scaling
Gauss-Newton updates are not ported yet (``settings.check_supported``).
"""
from __future__ import annotations

from timeit import default_timer as timer

import numpy as np
import torch

from ..geometry import fov_centre, rigid_from_q
from ..settings import check_supported
from ..solvers.admm import step_size
from ..solvers.fitloop import init_state, make_fit_iteration
from ..utils.log import info
from .structs import XData, YData


def get_gain(obj_trace) -> float:
    """Relative gain of the last step (nitorch get_gain, run.py:100)."""
    v = np.asarray(obj_trace, dtype=np.float64)
    if v.size < 2:
        return float("inf")
    denom = v.max() - v.min()
    if denom == 0:
        return 0.0
    return float((v[-2] - v[-1]) / denom)


def get_sched(N: int, sett):
    """Coarse-to-fine lambda schedule (reference _core.py:288-307)."""
    if sett.sched_num < 0 or N == 1:
        sett.sched_num = 0
    if sett.rigid_mod < 1:
        sett.rigid_mod = 1
    scl = np.atleast_1d(np.asarray(sett.reg_scl, dtype=np.float32))
    if scl.size > 1:
        # explicit schedule given by the user
        sett.reg_scl = scl
        return sett
    sched = 2.0 ** np.arange(31, -1, -1, dtype=np.float32)
    ix = int(np.argmin(np.abs(sched - scl[0])))
    sched = sched[max(ix - sett.sched_num, 0):ix]
    sett.reg_scl = np.concatenate([sched, scl.reshape(1)])
    return sett


def clean_fov(x: XData, y: YData) -> None:
    """Zero recon voxels outside every observation's FOV (reference
    run.py:162-187; coordinate range g in [0, dim) per axis)."""
    for c in range(len(y)):
        dim_y = tuple(int(d) for d in y[c].dim)
        dev = y[c].dat.device
        ii, jj, kk = (torch.arange(n, dtype=torch.float32, device=dev)
                      for n in dim_y)
        ii, jj, kk = ii[:, None, None], jj[None, :, None], kk[None, None, :]
        msk = torch.ones(dim_y, dtype=torch.bool, device=dev)
        for o in x[c]:
            Minv = np.linalg.inv(np.linalg.solve(y[c].mat, o.po.rigid @ o.mat))
            Mj = Minv[:3, :4].astype(np.float32)
            for d in range(3):
                g = (float(Mj[d, 0]) * ii + float(Mj[d, 1]) * jj
                     + float(Mj[d, 2]) * kk + float(Mj[d, 3]))
                msk = msk & (g >= 0) & (g < o.dim[d])
        y[c].dat = torch.where(msk, y[c].dat, 0.0)


def fit(x: XData, y: YData, sett):
    """Run the iterative solver; returns (y, R, jtv, obj_trace, n_iter).

    Output writing is the caller's job (``pipeline.run.fit``).
    """
    N = sum(len(xc) for xc in x)
    C = len(x)
    check_supported(sett, N)
    sett = get_sched(N, sett)

    # schedule position 0
    reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
    for c in range(C):
        y[c].lam = float(reg[0]) * y[c].lam0

    jtv = None
    obj_trace = []
    R = np.stack([np.eye(4)] * N)
    if sett.max_iter > 0:
        info(sett, "step-size", step_size(x, y, sett))
        state = init_state(x, y, sett)
        iterate = make_fit_iteration(x, y, sett)
        xdats = [[o.dat for o in xc] for xc in x]
        t00 = info(sett, "fit-start", C, N)
        while not state.done and state.n_iter < sett.max_iter:
            t_it = timer()
            state, obj, gain = iterate(state, xdats)
            obj_trace.append(obj)
            info(sett, "fit-ll", state.n_iter - 1, obj, gain, t_it)
        if state.done:
            info(sett, "fit-finish", t00, state.n_iter - 1)
        for c in range(C):
            y[c].dat = state.ys[c]
            y[c].lam = float(reg[min(state.cnt_scl, reg.size - 1)]) * y[c].lam0
        jtv = state.jtv

    if sett.clean_fov:
        clean_fov(x, y)

    # rigid matrices (reference run.py:195-200): centre-conjugated world
    # transforms of the (here fixed) pose parameters
    centre = fov_centre(y[0].mat, y[0].dim)
    cnt = 0
    for c in range(C):
        for o in x[c]:
            if o.rigid_q is not None and sett.rigid_basis is not None:
                R[cnt] = rigid_from_q(o.rigid_q, sett.rigid_basis, centre)
            cnt += 1

    n_done = len(obj_trace)
    return (y, R, jtv, np.asarray(obj_trace) if obj_trace else np.zeros((0, 3)),
            n_done)
