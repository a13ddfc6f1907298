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

Scalars (tau, lam, rho) are Python floats; maps are (3, 4) host arrays.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..models.forward import make_obs_ops, obs_dyn_args
from ..ops.finite_diff import im_divergence, im_gradient
from .cg import cg_batched


def _device(sett) -> torch.device:
    return torch.device(sett.device)


def _vx_y(y) -> tuple:
    vx = np.sqrt((np.asarray(y[0].mat, np.float64)[:3, :3] ** 2).sum(0))
    return tuple(float(v) for v in vx.astype(np.float32))


def _f64_sum(v: torch.Tensor) -> torch.Tensor:
    return v.sum(dtype=torch.float64)


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
    CG preconditioner."""
    C = len(x)
    method = sett.method
    do_proj = sett.do_proj
    dim_y = tuple(int(d) for d in x[0][0].po.dim_y)
    dev = _device(sett)
    ops = [[make_obs_ops(o.po, method) for o in x[c]] for c in range(C)]

    def cdiags(Ms, Minvs, scls, taus):
        ones = torch.ones(dim_y, dtype=torch.float32, device=dev)
        out = []
        for c in range(C):
            acc = torch.zeros((), dtype=torch.float32, device=dev)
            for n in range(len(x[c])):
                if do_proj:
                    ata1 = ops[c][n][2](ones, Ms[c][n], Minvs[c][n],
                                        scls[c][n])
                    acc = acc + float(taus[c][n]) * torch.mean(ata1)
                else:
                    acc = acc + float(taus[c][n])
            out.append(acc)
        return torch.stack(out)

    return cdiags


# ---------------------------------------------------------------------------
# The outer-iteration body
# ---------------------------------------------------------------------------

def make_admm_body(x, y, sett):
    """Single ADMM iteration for this problem's geometry.

    Returns ``body(ys, z, w, xdats, Ms, Minvs, scls, taus, lams, rho, cdiags)
    -> (ys, z, w, jtv, obj)`` with obj a (3,) float64 tensor =
    (-ln p(y|x), -ln p(x|y), -ln p(y)).
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
    X, Y, Z = dim_y

    ops = [[make_obs_ops(o.po, method) for o in x[c]] for c in range(C)]
    precond_mode = getattr(sett, "precond", "dct") or "dct"
    if precond_mode not in ("dct", "jacobi", "none"):
        raise ValueError(f"precond={precond_mode!r} (use dct|jacobi|none)")
    # the DCT products must run in full float32, as the JAX package's
    # Precision.HIGHEST matmuls do: no TF32 on the card
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    Cx, Cy, Cz = dct_matrices(dim_y, dev)
    eig_tabs = dct_membrane_tables(dim_y, dev)
    jac_tabs = jacobi_tables(dim_y, dev)

    def _dct_apply(V, Mx, My, Mz):
        # per-axis transform as transpose + reshape + matmul
        Cn = V.shape[0]
        t = V.transpose(1, 3).reshape(-1, X)
        t = (t @ Mx).reshape(Cn, Z, Y, X).transpose(1, 3)
        t = t.transpose(2, 3).reshape(-1, Y)
        t = (t @ My).reshape(Cn, X, Z, Y).transpose(2, 3)
        t = t.reshape(-1, Z)
        return (t @ Mz).reshape(Cn, X, Y, Z)

    def _bc(v):
        return v[:, None, None, None]

    def make_precond(cdiags, rho, lams_t):
        if precond_mode == "none":
            return None
        tabs = jac_tabs if precond_mode == "jacobi" else eig_tabs
        field = (tabs[0] / (vx[0] * vx[0]) + tabs[1] / (vx[1] * vx[1])
                 + tabs[2] / (vx[2] * vx[2]))
        denom = _bc(cdiags) + rho * _bc(lams_t * lams_t) * field
        if precond_mode == "jacobi":
            return lambda V: V / denom
        CxT, CyT, CzT = Cx.T, Cy.T, Cz.T

        def P(V):
            t = _dct_apply(V, CxT, CyT, CzT)
            return _dct_apply(t / denom, Cx, Cy, Cz)

        return P

    def body(ys, z, w, xdats, Ms, Minvs, scls, taus, lams, rho, cdiags):
        lams = [float(v) for v in lams]
        rho = float(rho)
        lams_t = torch.tensor(lams, dtype=torch.float32, device=dev)

        # ---- y-update: all channels in one batched CG ----
        rhs_all = []
        for c in range(C):
            rhs = torch.zeros_like(ys[c])
            for n in range(len(x[c])):
                if do_proj:
                    rhs = rhs + float(taus[c][n]) * ops[c][n][1](
                        xdats[c][n], Ms[c][n], Minvs[c][n], scls[c][n])
                else:
                    rhs = rhs + float(taus[c][n]) * xdats[c][n]
            div = im_divergence(w[c] - rho * z[c], vx, diff)
            rhs_all.append(rhs - lams[c] * div)
        rhs_all = torch.stack(rhs_all)

        def lhs_all(V):
            outs = []
            for c in range(C):
                lam = lams[c]
                out = rho * lam * lam * im_divergence(
                    im_gradient(V[c], vx, diff), vx, diff)
                for n in range(len(x[c])):
                    if do_proj:
                        out = out + float(taus[c][n]) * ops[c][n][2](
                            V[c], Ms[c][n], Minvs[c][n], scls[c][n])
                    else:
                        out = out + float(taus[c][n]) * V[c]
                outs.append(out)
            return torch.stack(outs)

        # residual stop at 3x the gain tolerance, as the JAX solver
        ys = cg_batched(lhs_all, rhs_all, ys, max_iter=cg_iter,
                        tol=3.0 * cg_tol,
                        precond=make_precond(cdiags, rho, lams_t),
                        verbose=bool(sett.cgs_verbose))

        # ---- objective (reference _compute_nll), float64 sums ----
        nll_xy = torch.zeros((), dtype=torch.float64, device=dev)
        for c in range(C):
            for n in range(len(x[c])):
                if do_proj:
                    Ay = ops[c][n][0](ys[c], Ms[c][n], Minvs[c][n],
                                      scls[c][n])
                else:
                    Ay = ys[c]
                res = torch.where(xdats[c][n] != 0, xdats[c][n] - Ay, 0.0)
                nll_xy = nll_xy + 0.5 * float(taus[c][n]) * _f64_sum(res * res)

        # ---- gradients for z/w (and the JTV prior term) ----
        Dys = torch.stack([lams[c] * im_gradient(ys[c], vx, diff)
                           for c in range(C)])  # (C, 3, *dim_y)
        nll_y = _f64_sum(torch.sqrt(torch.sum(Dys * Dys, dim=(0, 1))))

        if alpha != 1.0:  # over/under-relaxation (reference :163-190)
            Dys_rel = alpha * Dys + (1.0 - alpha) * z
        else:
            Dys_rel = Dys

        # ---- z-update: multi-channel group shrinkage ----
        u = w / rho + Dys_rel
        mag = torch.sqrt(torch.sum(u * u, dim=(0, 1)))
        shrink = torch.clamp(mag - 1.0 / rho, min=0.0) / (mag + tiny)
        z = shrink[None, None] * u

        # ---- w-update: dual ascent ----
        w = w + rho * (Dys_rel - z)

        obj = torch.stack([nll_xy + nll_y, nll_xy, nll_y])
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
