"""The outer iteration: ADMM, convergence and schedule bookkeeping, and the
even/odd scaling and unified rigid Gauss-Newton updates.

The control flow of ``unires_tpu.solvers.fitloop`` (``live_iter``,
fitloop.py:605-762), one iteration per call:

  1. lam from the coarse-to-fine schedule position, rho refreshed from it;
     one ADMM iteration (``solvers.admm``) at the current poses and scales;
  2. the gain over the posterior trace (nitorch get_gain) and the
     convergence countdown ``countdown0`` (reference run.py:100-110);
  3. unless converged: the scaling Gauss-Newton step of every non-CT
     observation (reference unires/_update.py:270-393);
  4. every ``rigid_mod`` iterations (not the first): the rigid GN deltas of
     every observation, the pose-gauge common mode projected out of them
     when ``rigid_gauge_anchor`` is on and N > 1, a halving line search per
     observation, and a re-centre of q when its mean drifts beyond 0.25
     (mm, 10 mrad units);
  5. the schedule step with ``countdown1`` (reference run.py:140-155) and
     the dual-consistency rescale of z at a lambda step.

Poses are centre-conjugated (``geometry.rigid_from_q``): the map of
observation i is pre_i @ expm(q_i) @ post_i with pre = mat_y^-1 T(c) and
post = T(-c) mat_yx (mat_x for denoising), c the recon FOV's world centre.
q (Nobs x 6) and the scales live on the host in float64, and the (3, 4)
maps are rebuilt from them every iteration.

The JAX package scans K iterations on the device per call; here the host
drives one at a time and reads back what the decisions need. The CG
data-term diagonals are recomputed from the current poses and scales every
``Settings.chunk_iters`` iterations, the cadence at which the JAX loop
refreshes them. The JAX loop's window-plan capacity checks have no
counterpart: the CUDA kernels take any affine, so every check there is
true, its pre-scale loop exits at step 1 and its veto never fires.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from ..geometry import (affine_basis, affine_translation, dexpm, expm,
                        fov_centre)
from ..models.forward import make_obs_suite
from ..models.proj_op import proj_info
from ..ops.lie import compose_maps
from ..utils.host import to_host
from .admm import make_admm_body, make_cdiag_fn
from .rigid import (_assemble, _centred_coords, ctc_volume, gn_delta,
                    match_ll_device, match_stats_device, split_stats)
from .scaling_gn import scaling_step

# units of the gauge-drift threshold: 1 mm of translation ~ 10 mrad of
# rotation (comparable displacement at ~100 mm from the centre)
_Q_GAUGE_SCALE = np.array([1.0, 1.0, 1.0, 0.01, 0.01, 0.01])
_NUM_LS = 6  # line-search budget (reference run.py:119,131)


@dataclasses.dataclass
class FitState:
    """Everything the loop carries between outer iterations."""

    ys: torch.Tensor  # (C, *dim_y)
    z: torch.Tensor  # (C, 3, *dim_y)
    w: torch.Tensor  # (C, 3, *dim_y)
    jtv: torch.Tensor  # (*dim_y) latest shrinkage field
    q: np.ndarray = None  # (Nobs, 6) float64 rigid parameters
    scl: np.ndarray = None  # (Nobs,) float64 even/odd scaling
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
    z = torch.zeros(shape, dtype=torch.float32, device=dev)
    w = torch.zeros(shape, dtype=torch.float32, device=dev)
    q = np.stack([np.zeros(6) if o.rigid_q is None
                  else np.asarray(o.rigid_q, np.float64)
                  for xc in x for o in xc])
    scl = np.array([float(o.po.scl) for xc in x for o in xc])
    return FitState(ys=ys, z=z, w=w, q=q, scl=scl,
                    jtv=torch.zeros(dim_y, dtype=torch.float32, device=dev))


def chunk_geom(x, y, sett):
    """Per-observation geometry of the fit: ``(pres, posts, subs)``.

    pres/posts are the float64 4x4 factors of the centre-conjugated maps.
    ``subs[i]`` is None without unified rigid, else a dict describing the
    rigid-subsample grid: ``po`` (the operator on it), ``post`` (its post
    factor), ``dim``, ``center`` and ``sub_is_main`` (the grids coincide,
    the ``rigid_samp=1`` default on >= 1 mm data). This is the one place
    that decides the grid: ``pipeline.fit._gather_subdats`` reads it.
    """
    method = sett.method
    dim_y = tuple(int(d) for d in y[0].dim)
    c_world = fov_centre(y[0].mat, dim_y)
    Tc, Tc_inv = affine_translation(c_world), affine_translation(-c_world)
    pres, posts, subs = [], [], []
    for xc in x:
        for o in xc:
            po = o.po
            sr = method == "super-resolution"
            pres.append(np.linalg.inv(np.asarray(po.mat_y, np.float64)) @ Tc)
            posts.append(Tc_inv @ np.asarray(po.mat_yx if sr else po.mat_x,
                                             np.float64))
            if not sett.unified_rigid:
                subs.append(None)
                continue
            po_sub = proj_info(po.dim_y, po.mat_y, o.dim, o.mat,
                               rigid=po.rigid, prof_ip=sett.profile_ip,
                               prof_tp=sett.profile_tp, gap=sett.gap,
                               scl=po.scl, samp=sett.rigid_samp)
            main = po_sub.dim_x == po.dim_x and po_sub.dim_yx == po.dim_yx
            po_use = po if main else po_sub
            dim_m = po_use.dim_yx if sr else po_use.dim_x
            subs.append(dict(
                po=po_use, dim=dim_m, sub_is_main=main,
                center=tuple((d - 1) / 2.0 for d in dim_m),
                post=Tc_inv @ np.asarray(po_use.mat_yx if sr
                                         else po_use.mat_x, np.float64)))
    return pres, posts, subs


def make_fit_iteration(x, y, sett):
    """``iterate(state, xdats, subdats) -> (state, obj (3,) float64, gain)``,
    one outer iteration for this problem.

    ``subdats`` is the flat per-observation list of rigid-subsample volumes
    (``pipeline.fit._gather_subdats`` of ``iterate.subs``; None where the
    grids coincide). The returned function also exposes ``subs`` (of
    :func:`chunk_geom`), ``maps(q)`` and the per-observation updates
    ``scaling_obs`` / ``rigid_stats`` / ``rigid_ls`` as attributes.
    """
    C = len(x)
    method = sett.method
    sr = method == "super-resolution"
    dev = torch.device(sett.device)
    obs = [(c, n) for c in range(C) for n in range(len(x[c]))]
    Nobs = len(obs)
    admm_body = make_admm_body(x, y, sett)
    cdiag_fn = make_cdiag_fn(x, sett)
    basis = (np.asarray(sett.rigid_basis, np.float64)
             if sett.rigid_basis is not None else affine_basis("SE"))
    pres, posts, subs = chunk_geom(x, y, sett)
    suites = [make_obs_suite(x[c][n].po, method) for (c, n) in obs]
    sub_suites = [None if s is None else
                  (suites[i] if s["sub_is_main"]
                   else make_obs_suite(s["po"], method))
                  for i, s in enumerate(subs)]
    coords = [None if s is None else _centred_coords(s["dim"], s["center"],
                                                     dev) for s in subs]
    ctcs: List[Optional[torch.Tensor]] = [None] * Nobs  # built at first use

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
    do_scaling = bool(sett.scaling)
    do_rigid = bool(sett.unified_rigid)
    gauge_anchor = bool(getattr(sett, "rigid_gauge_anchor", True))
    rigid_mod = max(int(sett.rigid_mod), 1)
    taus = [[float(np.float32(o.tau)) for o in x[c]] for c in range(C)]

    def nested(flat):
        out, i = [], 0
        for c in range(C):
            out.append(list(flat[i:i + len(x[c])]))
            i += len(x[c])
        return out

    def maps(q):
        """Nested (Ms, Minvs) of the main operators at poses q."""
        mm = [compose_maps(pres[i], expm(q[i], basis), posts[i])
              for i in range(Nobs)]
        return nested([m[0] for m in mm]), nested([m[1] for m in mm])

    def rho_of(lams):
        if rho_fixed is not None:
            return rho_fixed
        tau_all = [taus[c][n] for (c, n) in obs]
        return rho_scl * float(np.sqrt(np.mean(tau_all))) / float(np.mean(lams))

    def scaling_obs(ys_c, dat_x, M, s0, i):
        """Scaling GN step of observation i at map M from scale s0."""
        c, n = obs[i]
        y0 = suites[i]["project"](ys_c, M)  # pull + blur, no scaling
        s, _ = scaling_step(y0, dat_x, float(np.float32(s0)), taus[c][n],
                            x[c][n].po.dim_thick, _NUM_LS)
        return s

    def sub_map(q_i, i):
        return compose_maps(pres[i], expm(q_i, basis), subs[i]["post"])[0]

    def rigid_stats(ys_c, dat_x, q_i, s_i, i, debug=False):
        """GN delta (and the data term) of observation i at pose q_i."""
        c, n = obs[i]
        sub = subs[i]
        if ctcs[i] is None:
            ctcs[i] = ctc_volume(sub["po"], sub["dim"], dev) if sr else 1.0
        pre, post = pres[i], sub["post"]
        R, dR = dexpm(q_i, basis)
        M = compose_maps(pre, R, post)[0]
        dRq = np.einsum("ij,kjl,lm->kim", pre, dR, post)
        v = to_host(match_stats_device(
            dat_x, ys_c, M, float(np.float32(s_i)), taus[c][n],
            sub_suites[i], sub["po"], sr, coords[i], ctcs[i]))
        ll, *mom = split_stats(v)
        g, H = _assemble(*mom, dRq, sub["center"])
        delta = gn_delta(g, H)
        if debug:
            return delta, ll, dict(g=g, H=H)
        return delta, ll

    def rigid_ls(ys_c, dat_x, q_i, s_i, i, delta, ll):
        """Halving line search along -delta from step 1; q_i if no
        candidate lowers the data term."""
        c, n = obs[i]
        sub = subs[i]
        step = 1.0
        for _ in range(_NUM_LS):
            cand = q_i - step * delta
            llc = float(to_host(match_ll_device(
                dat_x, ys_c, sub_map(cand, i), float(np.float32(s_i)),
                taus[c][n], sub_suites[i], sub["po"], sr)))
            if llc < ll:
                return cand
            step *= 0.5
        return q_i

    def rigid_round(ys, xdats, subdats, q, scl):
        """One rigid round over every observation; returns the new q."""
        dats, deltas, lls = [], [], []
        for i, (c, n) in enumerate(obs):
            dat_i = xdats[c][n] if subs[i]["sub_is_main"] else subdats[i]
            dats.append(dat_i)
            d_i, ll_i = rigid_stats(ys[c], dat_i, q[i], scl[i], i)
            deltas.append(d_i)
            lls.append(ll_i)
        deltas = np.stack(deltas)
        if gauge_anchor and Nobs > 1:
            # project the pose-gauge common mode out of the GN steps before
            # the line searches (the joint model is gauge-free)
            deltas = deltas - deltas.mean(axis=0, keepdims=True)
        qn = np.stack([rigid_ls(ys[c], dats[i], q[i], scl[i], i, deltas[i],
                                lls[i]) for i, (c, n) in enumerate(obs)])
        if gauge_anchor and Nobs > 1:
            # the line searches may re-introduce a small common mode:
            # re-centre only when it drifts beyond 0.25 (mm / 10 mrad)
            mq = qn.mean(axis=0)
            if np.max(np.abs(mq) / _Q_GAUGE_SCALE) > 0.25:
                qn = qn - mq[None]
        return qn

    def iterate(st: FitState, xdats, subdats=None):
        Ms, Minvs = maps(st.q)
        scls = nested([float(np.float32(s)) for s in st.scl])
        if st.cdiags is None or st.n_iter % K == 0:
            st.cdiags = cdiag_fn(Ms, Minvs, scls, taus)
        lams = [float(reg_scl[st.cnt_scl]) * lam0[c] for c in range(C)]
        rho = rho_of(lams)
        st.ys, st.z, st.w, st.jtv, obj = admm_body(
            st.ys, st.z, st.w, xdats, Ms, Minvs, scls, taus, lams, rho,
            st.cdiags)
        obj = to_host(obj)  # the host needs it: gain, log

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
            if do_scaling:
                scl = st.scl.copy()
                for i, (c, n) in enumerate(obs):
                    if not x[c][n].ct:
                        scl[i] = scaling_obs(st.ys[c], xdats[c][n], Ms[c][n],
                                             st.scl[i], i)
                st.scl = scl
            if do_rigid and st.n_iter > 0 and st.n_iter % rigid_mod == 0:
                st.q = rigid_round(st.ys, xdats, subdats, st.q, st.scl)
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

    iterate.subs = subs
    iterate.maps = maps
    iterate.scaling_obs = scaling_obs
    iterate.rigid_stats = rigid_stats
    iterate.rigid_ls = rigid_ls
    return iterate
