"""Fit orchestrator: the host-driven outer loop.

Mirrors ``unires_tpu.pipeline.fit`` (reference ``fit``, unires/run.py:24-207):
lambda schedule with countdowns, gain-based convergence, optional even/odd
scaling and unified rigid updates, FOV cleaning and rigid-matrix collection.
One outer iteration per step (``solvers.fitloop.make_fit_iteration``). The
JAX package's window re-plans have no counterpart: the CUDA kernels take any
affine, so a drifted pose never needs another program.
"""
from __future__ import annotations

from timeit import default_timer as timer

import numpy as np
import torch

from ..geometry import fov_centre, rigid_from_q
from ..ops.resample import affine_to_M, pull
from ..settings import check_supported
from ..solvers.admm import step_size
from ..solvers.fitloop import FitState, init_state, make_fit_iteration
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


def _gather_subdats(x, subs):
    """Flat per-observation NN-subsampled volumes for the rigid update
    (reference unires/_update.py:589-593) on the grids that
    ``solvers.fitloop.chunk_geom`` chose (``subs``); None without unified
    rigid or where the rigid grid is the main grid (rigid_samp=1 on >= 1 mm
    data)."""
    obs = [o for xc in x for o in xc]
    return [None if s is None or s["sub_is_main"] else
            pull(o.dat, affine_to_M(s["po"].D_x), s["po"].dim_x, order=0)
            for o, s in zip(obs, subs)]


def _sync_state(x, y, sett, state: FitState) -> None:
    """Write the loop state back into the pipeline structs: q -> rigid_q and
    the centre-conjugated po.rigid, scl -> po.scl, ys -> y, lam."""
    basis = sett.rigid_basis
    centre = fov_centre(y[0].mat, y[0].dim)
    i = 0
    for xc in x:
        for o in xc:
            o.rigid_q = np.array(state.q[i], np.float64)
            if basis is not None:
                o.po.rigid = rigid_from_q(o.rigid_q, basis, centre)
            o.po.scl = float(state.scl[i])
            i += 1
    reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
    for c in range(len(y)):
        y[c].dat = state.ys[c]
        y[c].lam = float(reg[min(state.cnt_scl, reg.size - 1)]) * y[c].lam0


def fit(x: XData, y: YData, sett, state: FitState = None):
    """Run the iterative solver; returns (y, R, jtv, obj_trace, n_iter).

    Output writing is the caller's job (``pipeline.run.fit``). ``state``
    continues a fit from a given loop state (``pipeline.convert``) instead
    of a fresh one.
    """
    N = sum(len(xc) for xc in x)
    C = len(x)
    check_supported(sett)
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
        if state is None:
            state = init_state(x, y, sett)
        iterate = make_fit_iteration(x, y, sett)
        xdats = [[o.dat for o in xc] for xc in x]
        subdats = _gather_subdats(x, iterate.subs)
        t00 = info(sett, "fit-start", C, N)
        while not state.done and state.n_iter < sett.max_iter:
            t_it = timer()
            state, obj, gain = iterate(state, xdats, subdats)
            obj_trace.append(obj)
            info(sett, "fit-ll", state.n_iter - 1, obj, gain, t_it)
            if sett.do_print >= 2:  # reference verbosity 2 (_util.py:107-129)
                _sync_state(x, y, sett, state)
                info(sett, "reg-param", x)
                info(sett, "scl-param", x)
        if state.done:
            info(sett, "fit-finish", t00, state.n_iter - 1)
        _sync_state(x, y, sett, state)
        jtv = state.jtv

    if sett.clean_fov:
        clean_fov(x, y)

    # rigid matrices (reference run.py:195-200): centre-conjugated world
    # transforms of the fitted pose parameters
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
