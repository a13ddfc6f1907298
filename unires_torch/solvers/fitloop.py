"""The outer ADMM iteration with its convergence and schedule bookkeeping.

The control flow of ``unires_tpu.solvers.fitloop`` (``live_iter``,
fitloop.py:605-762) without the rigid and scaling Gauss-Newton updates:

  * lam from the coarse-to-fine schedule position, rho refreshed from it;
  * one ADMM iteration (``solvers.admm``);
  * the gain over the posterior trace (nitorch get_gain);
  * the convergence countdown ``countdown0`` (reference run.py:100-110);
  * the schedule step with ``countdown1`` (reference run.py:140-155) and the
    dual-consistency rescale of z at a lambda step.

The JAX package scans K such iterations on the device per call, to amortise
its per-dispatch cost on a remote TPU; here the host drives one iteration at
a time and reads back the (3,) objective, which the log and the gain need
anyway. The CG data-term diagonals are recomputed every
``Settings.chunk_iters`` iterations, the cadence at which the JAX loop
refreshes them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from ..models.forward import obs_dyn_args
from .admm import make_admm_body, make_cdiag_fn


@dataclasses.dataclass
class FitState:
    """Everything the loop carries between outer iterations."""

    ys: torch.Tensor  # (C, *dim_y)
    z: torch.Tensor  # (C, 3, *dim_y)
    w: torch.Tensor  # (C, 3, *dim_y)
    jtv: torch.Tensor  # (*dim_y) latest shrinkage field
    cdiags: Any = None  # (C,) preconditioner data-term diagonals
    cnt_scl: int = 0  # schedule position
    cnt_scl_iter: int = 0
    countdown0: int = 6  # convergence countdown (6 -> 0)
    countdown1: int = 6  # schedule countdown
    n_iter: int = 0
    done: bool = False
    prev_obj: float = 0.0
    obj_max: float = -np.inf
    obj_min: float = np.inf
    has_prev: bool = False


def init_state(x, y, sett) -> FitState:
    """Fresh loop state from the pipeline structs (z = w = 0)."""
    dev = torch.device(sett.device)
    dim_y = tuple(int(d) for d in y[0].dim)
    ys = torch.stack([yc.dat.to(dev, torch.float32) for yc in y])
    shape = (len(x), 3) + dim_y
    return FitState(ys=ys,
                    z=torch.zeros(shape, dtype=torch.float32, device=dev),
                    w=torch.zeros(shape, dtype=torch.float32, device=dev),
                    jtv=torch.zeros(dim_y, dtype=torch.float32, device=dev))


def make_fit_iteration(x, y, sett):
    """``iterate(state, xdats) -> (state, obj (3,) float64 numpy, gain)``,
    one outer iteration for this problem."""
    C = len(x)
    method = sett.method
    obs = [(c, n) for c in range(C) for n in range(len(x[c]))]
    admm_body = make_admm_body(x, y, sett)
    cdiag_fn = make_cdiag_fn(x, sett)

    # the schedule holds float32 values, as the JAX loop's device table
    reg_scl = np.atleast_1d(np.asarray(sett.reg_scl, np.float32)).astype(
        np.float64)
    n_sched = int(reg_scl.size)
    lam0 = [float(yc.lam0) for yc in y]
    has_ct = any(o.ct for xc in x for o in xc)
    rho_fixed = (1.0 if has_ct else
                 (float(sett.rho) if sett.rho is not None else None))
    rho_scl = float(sett.rho_scl)
    tol = float(sett.tolerance)
    max_iter = int(sett.max_iter)
    K = max(1, min(int(getattr(sett, "chunk_iters", 16)), max_iter))

    # no pose or scale updates on this path: the maps are fixed
    maps = [[obs_dyn_args(o.po, method) for o in x[c]] for c in range(C)]
    Ms: List[list] = [[m[0] for m in row] for row in maps]
    Minvs: List[list] = [[m[1] for m in row] for row in maps]
    scls = [[float(np.float32(o.po.scl)) for o in x[c]] for c in range(C)]
    taus = [[float(np.float32(o.tau)) for o in x[c]] for c in range(C)]

    def rho_of(lams):
        if rho_fixed is not None:
            return rho_fixed
        tau_all = [taus[c][n] for (c, n) in obs]
        return rho_scl * float(np.sqrt(np.mean(tau_all))) / float(np.mean(lams))

    def iterate(st: FitState, xdats):
        if st.cdiags is None or st.n_iter % K == 0:
            st.cdiags = cdiag_fn(Ms, Minvs, scls, taus)
        lams = [float(reg_scl[st.cnt_scl]) * lam0[c] for c in range(C)]
        rho = rho_of(lams)
        st.ys, st.z, st.w, st.jtv, obj = admm_body(
            st.ys, st.z, st.w, xdats, Ms, Minvs, scls, taus, lams, rho,
            st.cdiags)
        obj = obj.cpu().numpy()  # the host needs it: gain, log

        # gain over the posterior trace (nitorch get_gain)
        o0 = float(obj[0])
        omax = max(st.obj_max, o0)
        omin = min(st.obj_min, o0)
        denom = omax - omin
        if not st.has_prev:
            gain = float("inf")
        else:
            gain = (st.prev_obj - o0) / denom if denom > 0 else 0.0

        # convergence countdown (reference run.py:103-110)
        conv_ok = (st.cnt_scl >= n_sched - 1 and st.cnt_scl_iter > 20
                   and (abs(gain) < tol or st.n_iter >= max_iter - 1))
        cd0 = st.countdown0 - 1 if conv_ok else 6
        done_now = conv_ok and cd0 == 0

        if not done_now:
            # schedule step (reference run.py:140-155)
            sch_ok = (st.cnt_scl + 1 < n_sched and st.cnt_scl_iter > 16
                      and abs(gain) < 1e-3)
            cd1 = st.countdown1 - 1 if sch_ok else 6
            if sch_ok and cd1 == 0:
                # z approximates lam D y: rescale it by lam'/lam at the step
                # (w by (lam'/lam)(rho'/rho) = 1), as the JAX loop does
                fac_z = (reg_scl[min(st.cnt_scl + 1, n_sched - 1)]
                         / reg_scl[st.cnt_scl])
                st.z = st.z * float(fac_z)
                st.cnt_scl += 1
                st.cnt_scl_iter = 0
                cd1 = 6
            st.countdown1 = cd1

        st.cnt_scl_iter += 1
        st.countdown0 = cd0
        st.n_iter += 1
        st.done = st.done or done_now
        st.prev_obj, st.obj_max, st.obj_min = o0, omax, omin
        st.has_prev = True
        return st, obj, gain

    return iterate
