"""The ADMM solver for the multi-channel JTV MAP problem.

One outer iteration of ``unires_tpu.solvers.admm`` (reference
unires/_update.py:105-195 and :396-427), in eager PyTorch:

  * the y-update: ONE batched preconditioned CG over all channels on
    sum_n tau_n A^T A + rho lam^2 D^T D (``solvers.cg.cg_batched``), with the
    DCT-diagonal ('dct'), voxel-diagonal ('jacobi') or no ('none')
    preconditioner of ``Settings.precond``;
  * the objective (-ln p(y|x), -ln p(x|y), -ln p(y)), accumulated in float64
    (``.sum(dtype=torch.float64)``). The JAX package emulates that with
    compensated float32 sums (``unires_tpu/ops/reductions.py``) because a
    TPU's float64 is emulated; the card's is native, so the port has no
    counterpart of that module;
  * the joint-shrinkage z-update and the dual w-update.

tau is a Python float (fixed for a fit). lam and rho are float64 tensors on
the device (the fit chunk looks them up from the schedule position without
reading it back) or Python numbers; either way they enter each product as a
Python number would, rounded to float32 there. Maps are (3, 4) host arrays
or device tensors (``ops.resample``), and ``Minvs`` may be the maps' push
plans.

A batch of subjects (the batched fit chunk, ``solvers.fitloop``) runs the
same body on tensors stacked on a leading subject axis: ys (B, C, X, Y,
Z), volumes (B, ...), maps (B, 3, 4), and every per-subject number a
device tensor, tau and the scales (B,) float32, lam (B, C) and rho (B,)
float64, the objective (B, 3). The CG runs over the B * C entries, each
subject's channels reduced together and apart from the other subjects'
(``cg_batched(groups=B)``); the objective, the JTV norm and the DCT
products are taken per subject on a single fit's shapes
(``utils.batch.each``), so a subject keeps its single fit's numbers.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.forward import make_obs_ops, obs_dyn_args
from ..ops.finite_diff import DtD, im_divergence, im_gradient
from ..utils.batch import each, sum_f64
from .cg import cg_batched


def _device(sett) -> torch.device:
    return torch.device(sett.device)


def _vx_y(y) -> tuple:
    vx = np.sqrt((np.asarray(y[0].mat, np.float64)[:3, :3] ** 2).sum(0))
    return tuple(float(v) for v in vx.astype(np.float32))


def _f64_sum(v: torch.Tensor) -> torch.Tensor:
    return v.sum(dtype=torch.float64)


def _f32(v, nd: int):
    """A per-subject number as a factor of a float32 tensor with ``nd``
    axes after the subject axis: a Python number as it is, one number in a
    tensor as a 0-d tensor (rounded to float32 in the product), a (B,)
    tensor rounded to float32 and shaped to broadcast."""
    if not isinstance(v, torch.Tensor) or v.numel() == 1:
        return v if not isinstance(v, torch.Tensor) else v.reshape(())
    return v.to(torch.float32).reshape(v.shape + (1,) * nd)


def _half(tau):
    """0.5 tau in float64: a Python number, or a (B,) tensor."""
    if isinstance(tau, torch.Tensor):
        return 0.5 * tau.to(torch.float64)
    return 0.5 * float(tau)


def _device_scalars(lams, rho, device):
    """(lams (C,), rho) as float64 tensors on ``device``; tensors pass as
    they are."""
    if not isinstance(lams, torch.Tensor):
        lams = torch.tensor([float(v) for v in lams], dtype=torch.float64,
                            device=device)
    if not isinstance(rho, torch.Tensor):
        rho = torch.tensor(float(rho), dtype=torch.float64, device=device)
    return lams, rho


def admm_aux(C: int, dim_y, device="cpu") -> tuple:
    """The zero auxiliary and dual variables z, w, each (C, 3, *dim_y)."""
    shape = (int(C), 3) + tuple(int(d) for d in dim_y)
    return (torch.zeros(shape, dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device))


def step_size(x, y, sett) -> float:
    """rho = rho_scl * sqrt(mean tau) / mean lam; 1.0 for CT (ref :35-64)."""
    if any(o.ct for c in x for o in c):
        return 1.0
    if sett.rho is not None:
        return float(sett.rho)
    taus = [o.tau for c in x for o in c]
    lams = [c.lam for c in y]
    return float(sett.rho_scl) * float(np.sqrt(np.mean(taus)) / np.mean(lams))


# ---------------------------------------------------------------------------
# Preconditioner tables
# ---------------------------------------------------------------------------

def dct_matrices(dim_y, device="cpu"):
    """Per-axis orthonormal DCT-II matrices (built in float64, kept float32).

    The DCT diagonalises the membrane term D^T D with Neumann boundary, so
    the preconditioner is six dense (n, n) matrix products.
    """
    out = []
    for n in dim_y:
        n = int(n)
        k = np.arange(n)[:, None]
        i = np.arange(n)[None, :]
        C = np.cos(np.pi * (i + 0.5) * k / n) * np.sqrt(2.0 / n)
        C[0] /= np.sqrt(2.0)
        out.append(torch.as_tensor(C.astype(np.float32), device=device))
    return out


def _eig_field(dim_y, vx_y, period: float) -> np.ndarray:
    """sum_d 4 sin^2(pi k_d / (period n_d)) / vx_d^2 on the full grid, each
    axis in float64 and the sum in float32 in axis order, as the JAX
    package's tables."""
    dim_y = tuple(int(d) for d in dim_y)
    lamD = np.zeros(dim_y, np.float32)
    for d in range(3):
        k = np.arange(dim_y[d])
        e = (4.0 / float(vx_y[d]) ** 2) * np.sin(
            np.pi * k / (period * dim_y[d])) ** 2
        shape = [1, 1, 1]
        shape[d] = dim_y[d]
        lamD = lamD + e.reshape(shape).astype(np.float32)
    return lamD


def dct_membrane_eigs(dim_y, vx_y, device="cpu") -> torch.Tensor:
    """DCT-II eigenvalues of the Neumann-boundary membrane operator,
    sum_d 4 sin^2(pi k_d / (2 n_d)) / vx_d^2, as a full (X, Y, Z) float32
    table (the preconditioner of the parallel solvers)."""
    return torch.as_tensor(_eig_field(dim_y, vx_y, 2.0), device=device)


def fourier_membrane_eigs(dim_y, vx_y, device="cpu") -> torch.Tensor:
    """rfftn eigenvalues of the circulant membrane operator,
    sum_d 4 sin^2(pi k_d / n_d) / vx_d^2, on the (X, Y, Z // 2 + 1) half
    grid (the FFT preconditioner the DCT one replaced)."""
    lamD = _eig_field(dim_y, vx_y, 1.0)
    return torch.as_tensor(lamD[..., :int(dim_y[2]) // 2 + 1].copy(),
                           device=device)


def dct_apply(V: torch.Tensor, Mx, My, Mz) -> torch.Tensor:
    """The separable transform of a (C, X, Y, Z) stack, one (n, n) matrix per
    axis: each axis moved last by a transpose, reshaped and multiplied."""
    Cn, X, Y, Z = V.shape
    t = V.transpose(1, 3).reshape(-1, X)
    t = (t @ Mx).reshape(Cn, Z, Y, X).transpose(1, 3)
    t = t.transpose(2, 3).reshape(-1, Y)
    t = (t @ My).reshape(Cn, X, Z, Y).transpose(2, 3)
    t = t.reshape(-1, Z)
    return (t @ Mz).reshape(Cn, X, Y, Z)


def _axis_tables(dim_y, fn, device):
    dim_y = tuple(int(d) for d in dim_y)
    out = []
    for d in range(3):
        shape = [1, 1, 1]
        shape[d] = dim_y[d]
        e = fn(dim_y[d]).astype(np.float32).reshape(shape)
        out.append(torch.as_tensor(e, device=device))
    return tuple(out)


def dct_membrane_tables(dim_y, device="cpu"):
    """Per-axis DCT-II membrane eigenvalue tables 4 sin^2(pi k / (2 n)),
    broadcast-ready ((X,1,1), (1,Y,1), (1,1,Z)); the full field is
    ``sum_d tables[d] / vx_d^2``."""
    return _axis_tables(
        dim_y, lambda n: 4.0 * np.sin(np.pi * np.arange(n) / (2.0 * n)) ** 2,
        device)


def jacobi_tables(dim_y, device="cpu"):
    """Per-axis diagonal of D^T D for forward differences,
    ([i < n-1] + [i > 0]) before the 1/vx_d^2 factor."""
    def diag(n):
        e = np.full(n, 2.0)
        e[0] = 1.0
        e[-1] = 1.0
        return e

    return _axis_tables(dim_y, diag, device)


def make_cdiag_fn(x, sett) -> Callable:
    """cdiags(Ms, Minvs, scls, taus) -> (C,) float32 tensor with
    cdiag_c = sum_n tau_cn * mean(AtA_cn(1)), the data-term diagonal of the
    CG preconditioner; (B, C) for a batch's (B, 3, 4) maps and (B,) taus
    and scales."""
    C = len(x)
    method = sett.method
    do_proj = sett.do_proj
    dim_y = tuple(int(d) for d in x[0][0].po.dim_y)
    dev = _device(sett)
    ops = [[make_obs_ops(o.po, method) for o in x[c]] for c in range(C)]

    def cdiags(Ms, Minvs, scls, taus):
        M0 = Ms[0][0]
        lead = tuple(M0.shape[:-2]) if isinstance(M0, torch.Tensor) else ()
        # one volume of ones, read by every subject of a batch
        ones = torch.ones(dim_y, dtype=torch.float32,
                          device=dev).expand(lead + dim_y)
        out = []
        for c in range(C):
            acc = torch.zeros(lead, dtype=torch.float32, device=dev)
            for n in range(len(x[c])):
                tau = taus[c][n]
                tau = tau if isinstance(tau, torch.Tensor) else float(tau)
                if do_proj:
                    ata1 = ops[c][n][2](ones, Ms[c][n], Minvs[c][n],
                                        scls[c][n])
                    acc = acc + tau * each(torch.mean, ata1, 3)
                else:
                    acc = acc + tau
            out.append(acc)
        return torch.stack(out, dim=-1)

    return cdiags


# ---------------------------------------------------------------------------
# The outer-iteration body
# ---------------------------------------------------------------------------

def make_admm_body(x, y, sett):
    """Single ADMM iteration for this problem's geometry.

    Returns ``body(ys, z, w, xdats, Ms, Minvs, scls, taus, lams, rho, cdiags,
    live=None) -> (ys, z, w, jtv, obj)`` with obj a (3,) float64 tensor =
    (-ln p(y|x), -ln p(x|y), -ln p(y)). ``lams`` (C,) and ``rho``: float64
    device tensors or Python numbers. Nothing is read back but the CG's stop
    test, which a captured graph reads on the device. For a batch (ys of
    five axes; see the module's docstring) every output gains the subject
    axis, and ``live`` (B,) bool marks the subjects to solve: the CG entries
    of the others stay where they are.
    """
    C = len(x)
    method = sett.method
    do_proj = sett.do_proj
    diff = sett.diff
    vx = _vx_y(y)
    alpha = float(sett.alpha)
    cg_iter = int(sett.cgs_max_iter)
    cg_tol = float(sett.cgs_tol)
    tiny = 1e-7
    dim_y = tuple(int(d) for d in y[0].dim)
    dev = _device(sett)

    ops = [[make_obs_ops(o.po, method) for o in x[c]] for c in range(C)]
    precond_mode = getattr(sett, "precond", "dct") or "dct"
    if precond_mode not in ("dct", "jacobi", "none"):
        raise ValueError(f"precond={precond_mode!r} (use dct|jacobi|none)")
    # the DCT products run in full float32 on the card (no TF32), as the JAX
    # package's Precision.HIGHEST: pipeline.run.get_device pins it
    Cx, Cy, Cz = dct_matrices(dim_y, dev)
    eig_tabs = dct_membrane_tables(dim_y, dev)
    jac_tabs = jacobi_tables(dim_y, dev)

    def make_precond(cdiags, rho, lams_t, groups):
        if precond_mode == "none":
            return None
        tabs = jac_tabs if precond_mode == "jacobi" else eig_tabs
        field = (tabs[0] / (vx[0] * vx[0]) + tabs[1] / (vx[1] * vx[1])
                 + tabs[2] / (vx[2] * vx[2]))
        rl = _f32(rho, 1) * (lams_t * lams_t)
        denom = (cdiags.reshape(-1, 1, 1, 1)
                 + rl.reshape(-1, 1, 1, 1) * field)
        if precond_mode == "jacobi":
            return lambda V: V / denom
        CxT, CyT, CzT = Cx.T, Cy.T, Cz.T

        def P1(V, d):
            t = dct_apply(V, CxT, CyT, CzT)
            return dct_apply(t / d, Cx, Cy, Cz)

        if groups == 1:
            return lambda V: P1(V, denom)
        # the products of each subject on its own (a single fit's shapes)
        return lambda V: torch.cat([P1(v, d) for v, d in zip(
            V.chunk(groups), denom.chunk(groups))])

    def body(ys, z, w, xdats, Ms, Minvs, scls, taus, lams, rho, cdiags,
             live=None):
        lams, rho = _device_scalars(lams, rho, dev)
        lead = tuple(ys.shape[:-4])  # () or (B,): the subjects
        B = lead[0] if lead else 1
        lams_t = lams.to(torch.float32)

        def chan(t, c):  # channel c of a (..., C, ...) stack
            return t.select(len(lead), c)

        # ---- y-update: all channels (of every subject) in one batched CG
        rhs_all = []
        for c in range(C):
            rhs = torch.zeros_like(chan(ys, c))
            for n in range(len(x[c])):
                tau = _f32(taus[c][n], 3)
                if do_proj:
                    rhs = rhs + tau * ops[c][n][1](
                        xdats[c][n], Ms[c][n], Minvs[c][n], scls[c][n])
                else:
                    rhs = rhs + tau * xdats[c][n]
            rhs_all.append(rhs - im_divergence(
                chan(w, c) - _f32(rho, 4) * chan(z, c), vx, diff,
                scale=_f32(lams[..., c], 3)))
        rhs_all = torch.stack(rhs_all, dim=-4).reshape((-1,) + dim_y)

        def lhs_all(V):
            V = V.reshape(lead + (C,) + dim_y)
            outs = []
            for c in range(C):
                lam = lams[..., c]
                Vc = chan(V, c)
                out = DtD(Vc, vx, diff, scale=_f32(rho * lam * lam, 3))
                for n in range(len(x[c])):
                    tau = _f32(taus[c][n], 3)
                    if do_proj:
                        out = out + tau * ops[c][n][2](
                            Vc, Ms[c][n], Minvs[c][n], scls[c][n])
                    else:
                        out = out + tau * Vc
                outs.append(out)
            return torch.stack(outs, dim=-4).reshape((-1,) + dim_y)

        # residual stop at 3x the gain tolerance, as the JAX solver
        ys = cg_batched(lhs_all, rhs_all, ys.reshape((-1,) + dim_y),
                        max_iter=cg_iter, tol=3.0 * cg_tol,
                        precond=make_precond(cdiags, rho, lams_t, B),
                        verbose=bool(sett.cgs_verbose), groups=B,
                        live=None if live is None
                        else live.repeat_interleave(C))
        ys = ys.reshape(lead + (C,) + dim_y)

        # ---- objective (reference _compute_nll), float64 sums ----
        nll_xy = torch.zeros(lead, dtype=torch.float64, device=dev)
        for c in range(C):
            for n in range(len(x[c])):
                if do_proj:
                    Ay = ops[c][n][0](chan(ys, c), Ms[c][n], Minvs[c][n],
                                      scls[c][n])
                else:
                    Ay = chan(ys, c)
                res = torch.where(xdats[c][n] != 0, xdats[c][n] - Ay, 0.0)
                nll_xy = nll_xy + _half(taus[c][n]) * sum_f64(res * res)

        # ---- gradients for z/w (and the JTV prior term) ----
        Dys = torch.stack([im_gradient(chan(ys, c), vx, diff,
                                       scale=_f32(lams[..., c], 4))
                           for c in range(C)], dim=-5)  # (..., C, 3, *dim_y)
        nll_y = each(lambda d: _f64_sum(torch.sqrt(torch.sum(d, dim=(0, 1)))),
                     Dys * Dys, 5)

        if alpha != 1.0:  # over/under-relaxation (reference :163-190)
            Dys_rel = alpha * Dys + (1.0 - alpha) * z
        else:
            Dys_rel = Dys

        # ---- z-update: multi-channel group shrinkage (per subject) ----
        u = w / _f32(rho, 5) + Dys_rel
        mag = each(lambda q: torch.sqrt(torch.sum(q, dim=(0, 1))), u * u, 5)
        shrink = (torch.clamp(mag - _f32(1.0 / rho, 3), min=0.0)
                  / (mag + tiny))
        z = shrink[..., None, None, :, :, :] * u

        # ---- w-update: dual ascent ----
        w = w + _f32(rho, 5) * (Dys_rel - z)

        obj = torch.stack([nll_xy + nll_y, nll_xy, nll_y], dim=-1)
        return ys, z, w, shrink, obj

    return body


def make_admm_step(x, y, sett) -> Callable:
    """ADMM iteration with the CG data-term diagonal frozen at the nominal
    maps (the JAX package's ``make_admm_step``).

    step(ys, z, w, xdats, Ms, Minvs, scls, taus, lams, rho)
      -> (ys, z, w, jtv, obj)
    """
    C = len(x)
    body = make_admm_body(x, y, sett)
    dim_y = tuple(int(d) for d in y[0].dim)
    ones = torch.ones(dim_y, dtype=torch.float32, device=_device(sett))
    c_unit = []  # per-observation mean of A^T A(1) at the nominal map
    for c in range(C):
        row = []
        for o in x[c]:
            if sett.do_proj:
                AtA = make_obs_ops(o.po, sett.method)[2]
                M0, Mi0 = obs_dyn_args(o.po, sett.method)
                row.append(float(torch.mean(AtA(ones, M0, Mi0, o.po.scl))))
            else:
                row.append(1.0)
        c_unit.append(row)

    def step(ys, z, w, xdats, Ms, Minvs, scls, taus, lams, rho):
        cd = [sum(float(taus[c][n]) * c_unit[c][n] for n in range(len(x[c])))
              for c in range(C)]
        cdiags = torch.tensor(cd, dtype=torch.float32, device=ys.device)
        return body(ys, z, w, xdats, Ms, Minvs, scls, taus, lams, rho, cdiags)

    return step


def make_compute_nll(x, y, sett) -> Callable:
    """Standalone objective: nll(ys, xdats, Ms, Minvs, scls, taus, lams) ->
    (3,) float64 tensor."""
    C = len(x)
    method = sett.method
    do_proj = sett.do_proj
    diff = sett.diff
    vx = _vx_y(y)
    ops = [[make_obs_ops(o.po, method) for o in x[c]] for c in range(C)]

    def nll(ys, xdats, Ms, Minvs, scls, taus, lams):
        nll_xy = torch.zeros((), dtype=torch.float64, device=ys.device)
        for c in range(C):
            for n in range(len(x[c])):
                Ay = (ops[c][n][0](ys[c], Ms[c][n], Minvs[c][n], scls[c][n])
                      if do_proj else ys[c])
                res = torch.where(xdats[c][n] != 0, xdats[c][n] - Ay, 0.0)
                nll_xy = nll_xy + 0.5 * float(taus[c][n]) * _f64_sum(res * res)
        Dys = torch.stack([float(lams[c]) * im_gradient(ys[c], vx, diff)
                           for c in range(C)])
        nll_y = _f64_sum(torch.sqrt(torch.sum(Dys * Dys, dim=(0, 1))))
        return torch.stack([nll_xy + nll_y, nll_xy, nll_y])

    return nll
