"""Unified rigid registration update (Gauss-Newton on the SE(3) pose).

The counterpart of ``unires_tpu.solvers.rigid`` (reference
unires/_update.py:198-267 and :448-710). The chain rule avoids the
reference's 18 dAff volumes: dAff_{i,d}(o) is affine in the voxel coordinate
o, so every contraction sum_o W(o) dAff_{i,d1}(o) dAff_{j,d2}(o) is a
quadratic form in the order-<=2 spatial moments of W. The device computes
only the moments of the 3 gradient and 6 Hessian weight volumes; the 6x6
system is assembled and solved in float64, on the host for the host API
(:func:`update_rigid`) and on the device for the fit chunk
(:func:`_assemble` takes either; :func:`gn_delta` solves on the device).

The moments are reduced in float64 through the three 2D marginals of each
weight volume (``sum_k W``, ``sum_j W``, ``sum_i W``), which give every
moment of order <= 2 over separable coordinates: 3 volume passes per weight
instead of 10. With float64 sums the coordinates need no normalisation
(the JAX fit loop divides them by the half-extent to keep its float32 sums
accurate). The fit's GN round takes the moments of G and W from
``ops.gn_stats.gn_moments``: on a CUDA tensor one kernel pass over the
gradient, on a CPU tensor this plain chain.

:func:`_moments`, :func:`_assemble` and :func:`gn_delta` also serve the fit
loop (``solvers.fitloop``) and co-registration (``pipeline.registration``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import affine_translation, dexpm, expm, fov_centre, rigid_from_q
from ..models.forward import make_obs_suite
from ..models.proj_op import ProjOp, proj_info
from ..ops.conv import blur_down_sep, blur_up_sep
from ..ops.gn_stats import gn_moments
from ..ops.resample import affine_to_M, pull
from ..ops.scaling import apply_scaling
from ..utils.batch import sum_f64
from ..utils.host import to_host

# symmetric 3x3 -> 6-vector index map (reference _update.py:564)
_LKP = np.array([[0, 3, 4], [3, 1, 5], [4, 5, 2]])


def _centred_coords(dim, center, device):
    """Per-axis voxel coordinates minus ``center`` (float64 vectors)."""
    return tuple(torch.arange(n, dtype=torch.float64, device=device) - c
                 for n, c in zip(dim, center))


def _moments(W: torch.Tensor, coords, order: int = 2) -> torch.Tensor:
    """Spatial moments of ``W`` (..., X, Y, Z) over centred coordinates.

    Returns a float64 tensor (..., 10) = (m0, m1[3], m2[6]) with m1 =
    (sum W i, sum W j, sum W k) and m2 = (ii, jj, kk, ij, ik, jk), or
    (..., 4) = (m0, m1[3]) for ``order=1``. The products with the
    coordinates are elementwise sums, not matrix-vector products: the fit
    chunk takes them inside a graph's conditional nodes, which the library
    kernels of a matrix-vector product do not enter.
    """
    ii, jj, kk = coords

    def dot(P, c):  # contract the last axis of P with c
        return (P * c).sum(dim=-1)

    Pxy = W.sum(dim=-1, dtype=torch.float64)  # (..., X, Y)
    Px = Pxy.sum(dim=-1)
    Py = Pxy.sum(dim=-2)
    Pxz = W.sum(dim=-2, dtype=torch.float64)  # (..., X, Z)
    Pz = Pxz.sum(dim=-2)
    out = [Px.sum(dim=-1), dot(Px, ii), dot(Py, jj), dot(Pz, kk)]
    if order == 2:
        Pyz = W.sum(dim=-3, dtype=torch.float64)  # (..., Y, Z)
        out += [dot(Px, ii * ii), dot(Py, jj * jj), dot(Pz, kk * kk),
                dot(dot(Pxy, jj), ii), dot(dot(Pxz, kk), ii),
                dot(dot(Pyz, kk), jj)]
    return torch.stack(out, dim=-1)


def _assemble(g_m0, g_m1, w_m0, w_m1, w_m2, dRq, center, lkp=_LKP):
    """Float64 assembly of the GN gradient and Hessian from moments: numpy
    for host arrays, torch on the tensors' device (``center`` a (3,) and
    ``lkp`` :data:`_LKP` as tensors there too). Every contraction is a
    broadcast product and a sum (no library matrix product: see
    :func:`_moments`).

    dAff_{i,d}(o) = c[i,d] + sum_e b[i,d,e] (o_e - center_e) with
    b[i,d,e] = dRq[i][d,e], c[i,d] = dRq[i][d,3] + sum_e b[i,d,e] center_e.
    g_m0 (3,), g_m1 (3,3) are the moments of the gradient volumes G_d;
    w_m0 (6,), w_m1 (6,3), w_m2 (6,6) those of the Hessian weights W_k.
    """
    if not isinstance(dRq, torch.Tensor):
        g_m0, g_m1, w_m0, w_m1, w_m2, dRq, center = (
            np.asarray(a, np.float64) for a in (g_m0, g_m1, w_m0, w_m1, w_m2,
                                                dRq, center))
    b = dRq[:, :3, :3]  # (k, d, e)
    cc = dRq[:, :3, 3] + (b * center).sum(axis=-1)  # (k, d)
    g = (cc * g_m0).sum(axis=-1) + (b * g_m1).sum(axis=(-2, -1))
    M2 = w_m2[:, lkp]  # (6, 3, 3): the symmetric second moments
    m0m = w_m0[lkp]  # (3, 3)
    m1m = w_m1[lkp]  # (3, 3, 3)
    M2m = M2[lkp]  # (3, 3, 3, 3)
    # H[k, j] over d, e (and f, g): cc cc m0, cc b m1, b cc m1, b b M2
    H = ((cc[:, None, :, None] * cc[None, :, None, :] * m0m)
         .sum(axis=(-2, -1))
         + (cc[:, None, :, None, None] * b[None, :, None, :, :] * m1m)
         .sum(axis=(-3, -2, -1))
         + (b[:, None, :, None, :] * cc[None, :, None, :, None] * m1m)
         .sum(axis=(-3, -2, -1))
         + (b[:, None, :, None, :, None] * b[None, :, None, :, None, :]
            * M2m).sum(axis=(-4, -3, -2, -1)))
    return g, H


def _spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for a small symmetric positive definite A: Cholesky
    column by column and two triangular substitutions, in elementwise
    tensor ops on A's device (no library handle, no check read back)."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    for j in range(n):
        v = A[j:, j]
        if j:
            v = v - (L[j:, :j] * L[j, :j]).sum(dim=-1)
        L[j:, j] = v / torch.sqrt(v[0])
    y = torch.zeros_like(b)
    for i in range(n):
        r = b[i] - (L[i, :i] * y[:i]).sum() if i else b[i]
        y[i] = r / L[i, i]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        r = y[i] - (L[i + 1:, i] * x[i + 1:]).sum() if i < n - 1 else y[i]
        x[i] = r / L[i, i]
    return x


def gn_delta(g: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """The fit loop's 6x6 solve on the tensors' device: Jacobi-equilibrated,
    with a 1e-5 ridge on the equilibrated system
    (unires_tpu/solvers/fitloop.py:480-489), by Cholesky (the ridged system
    is positive definite)."""
    dscale = 1.0 / torch.sqrt(torch.abs(torch.diagonal(H)) + 1e-20)
    Hn = H * dscale[:, None] * dscale[None, :]
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    return _spd_solve(Hn + 1e-5 * eye, g * dscale) * dscale


def match_stats_device(dat_x, dat_y, M, scl, tau, suite, po: ProjOp, sr,
                       coords, ctc):
    """Device part of one GN round: a (1 + 3*4 + 6*10,) float64 tensor
    (ll, moments of G_0..G_2, moments of W_0..W_5). A batch of volumes
    (B, ...) at maps (B, 3, 4), scales and taus (B,) gives (B, 73), each
    subject's sums and moments taken alone (``utils.batch.sum_f64``,
    ``ops.gn_stats.gn_moments``)."""
    dat_yx = suite["pull"](dat_y, M)
    if sr:
        dat_yx = blur_down_sep(dat_yx, po.smo_ker_1d, po.ratio)
        dat_yx = apply_scaling(dat_yx, scl, po.dim_thick)
    gr = suite["pull_grad"](dat_y, M)  # (dim..., 3), on the pre-blur grid
    msk = dat_x != 0
    res = torch.where(msk, dat_x - dat_yx, 0.0)
    ll = (0.5 * tau) * sum_f64(res.square())
    diff = torch.where(msk & (dat_yx != 0), dat_yx - dat_x, 0.0)
    if sr:
        diff = blur_up_sep(diff, po.smo_ker_1d, po.ratio)
    return torch.cat([ll[..., None], gn_moments(gr, diff, ctc, coords)],
                     dim=-1)


def split_stats(v: np.ndarray):
    """(ll, g_m0, g_m1, w_m0, w_m1, w_m2) of :func:`match_stats_device`."""
    G = v[1:13].reshape(3, 4)
    W = v[13:].reshape(6, 10)
    return float(v[0]), G[:, 0], G[:, 1:4], W[:, 0], W[:, 1:4], W[:, 4:]


def match_ll_device(dat_x, dat_y, M, scl, tau, suite, po: ProjOp, sr):
    """The data term at map ``M`` (float64 device scalar; (B,) for a batch
    as :func:`match_stats_device`'s)."""
    dat_yx = suite["pull"](dat_y, M)
    if sr:
        dat_yx = blur_down_sep(dat_yx, po.smo_ker_1d, po.ratio)
        dat_yx = apply_scaling(dat_yx, scl, po.dim_thick)
    res = torch.where(dat_x != 0, dat_x - dat_yx, 0.0)
    return (0.5 * tau) * sum_f64(res.square())


def ctc_volume(po: ProjOp, dim, device):
    """C^T C (1): the blur's normal operator on ones, the Hessian's
    modulation for super-resolution."""
    ones = torch.ones(tuple(dim), dtype=torch.float32, device=device)
    return blur_up_sep(blur_down_sep(ones, po.smo_ker_1d, po.ratio),
                       po.smo_ker_1d, po.ratio)


def make_rigid_fns(po: ProjOp, method: str, device="cpu"):
    """(match_stats, match_ll, center) for one (possibly subsampled) operator.

    match_stats(dat_x, dat_y, M, scl, tau) ->
        (ll, G_m0 (3,), G_m1 (3,3), W_m0 (6,), W_m1 (6,3), W_m2 (6,6))
    on the host in float64; match_ll(...) -> float.
    """
    sr = method == "super-resolution"
    dim = po.dim_yx if sr else po.dim_x
    center = tuple((d - 1) / 2.0 for d in dim)
    suite = make_obs_suite(po, method)
    coords = _centred_coords(dim, center, device)
    ctc = ctc_volume(po, dim, device) if sr else 1.0

    def match_stats(dat_x, dat_y, M, scl, tau):
        v = match_stats_device(dat_x, dat_y, M, scl, tau, suite, po, sr,
                               coords, ctc)
        return split_stats(to_host(v))

    def match_ll(dat_x, dat_y, M, scl, tau):
        return float(to_host(match_ll_device(dat_x, dat_y, M, scl, tau,
                                             suite, po, sr)))

    return match_stats, match_ll, center


def update_rigid(x, y, sett, mean_correct: bool = True, max_niter_gn: int = 1,
                 num_linesearch: int = 4, samp: int = 3):
    """Gauss-Newton update of every observation's rigid_q (reference
    :198-267), with the JAX package's host semantics: a plain 6x6 solve,
    Armijo from step 1, and the mean of q subtracted afterwards when
    ``mean_correct``."""
    basis = sett.rigid_basis
    sll = 0.0
    for c in range(len(x)):
        for o in x[c]:
            sll += _update_rigid_obs(o, y[c], sett, basis, max_niter_gn,
                                     num_linesearch, samp)
    if mean_correct:
        mean_q = np.mean([o.rigid_q for ch in x for o in ch], axis=0)
        centre = fov_centre(y[0].mat, y[0].dim)
        for ch in x:
            for o in ch:
                o.rigid_q = o.rigid_q - mean_q
                o.po.rigid = rigid_from_q(o.rigid_q, basis, centre)
    return x, sll


def _update_rigid_obs(o, yc, sett, basis, max_niter_gn, num_linesearch, samp):
    method = sett.method
    # subsampled operator for speed (reference :576-579)
    po = proj_info(o.po.dim_y, o.po.mat_y, o.dim, o.mat, rigid=o.po.rigid,
                   prof_ip=sett.profile_ip, prof_tp=sett.profile_tp,
                   gap=sett.gap, scl=o.po.scl, samp=samp)
    mat = po.mat_yx if method == "super-resolution" else po.mat_x
    match_stats, match_ll, center = make_rigid_fns(po, method, o.dat.device)
    if samp > 0 and po.D_x is not None:  # NN-subsample (reference :589-593)
        dat_x = pull(o.dat, affine_to_M(po.D_x), po.dim_x, order=0)
    else:
        dat_x = o.dat
    q = np.asarray(o.rigid_q, np.float64).copy()
    tau = float(np.float32(o.tau))
    scl = float(np.float32(po.scl))
    # centre-conjugated pose parameterisation (geometry.rigid_from_q), as the
    # fit loop's pre/post folding
    centre = fov_centre(po.mat_y, po.dim_y)
    pre_c = np.linalg.solve(np.asarray(po.mat_y, np.float64),
                            affine_translation(centre))
    post_c = affine_translation(-centre) @ np.asarray(mat, np.float64)
    armijo = 1.0
    ll = None
    for _ in range(max_niter_gn):
        R, dR = dexpm(q, basis)
        dRq = [pre_c @ dR[i] @ post_c for i in range(basis.shape[0])]
        M = affine_to_M(pre_c @ R @ post_c)
        ll, *mom = match_stats(dat_x, yc.dat, M, scl, tau)
        g, H = _assemble(*mom, dRq, center)
        try:
            update = np.linalg.solve(H, g)
        except np.linalg.LinAlgError:
            break
        old_ll, old_q = ll, q.copy()
        if num_linesearch == 0:
            q = old_q - armijo * update
            continue
        for _ls in range(num_linesearch):
            cand = old_q - armijo * update
            Mc = affine_to_M(pre_c @ expm(cand, basis) @ post_c)
            cand_ll = match_ll(dat_x, yc.dat, Mc, scl, tau)
            if cand_ll < old_ll:
                q, ll = cand, cand_ll
                armijo = min(1.25 * armijo, 1.0)
                break
            armijo *= 0.5
        else:
            q, ll = old_q, old_ll
    o.rigid_q = q
    o.po.rigid = rigid_from_q(q, basis, centre)
    return float(ll) if ll is not None else 0.0
