"""Spatial (halo) sharding of the ADMM solver: a slab decomposition.

The counterpart of ``unires_tpu.parallel.spatial``. For volumes beyond one
device, y, z, w and x are cut into slabs along their first axis, one per
rank of a ``torch.distributed`` group, with

  * a one-row halo exchange with the two neighbouring ranks for the D / D^T
    stencils: the zero-bound finite differences of ``ops.finite_diff``,
    stitched across slab boundaries (the global ends get zeros, the
    Dirichlet bound);
  * an H-row halo for the resampling footprint: each rank extends its slab
    with its neighbours' edge rows and runs the local pull / push with a
    map offset to its slab and the GLOBAL field of view in its own frame
    (the ``fov`` override of ``ops.resample``, which the CUDA kernels take
    as bounds); pull and the gather-form push only READ the halo, so no
    cross-rank scatter exists;
  * the CG inner products all-reduced over the group, two all-reduces per
    step.

The exchanges are ``dist.batch_isend_irecv`` pairs with the two neighbours;
with one slab nothing is sent. The super-resolution chain adds the blur's
halo (its yx slabs overlap by the kernel's support) and a global even/odd
slice parity (:func:`make_spatial_admm_step_sr`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..models.proj_op import ProjOp
from ..ops.conv import blur_down_sep, blur_up_sep
from ..ops.finite_diff import _roll_zero
from ..ops.resample import pull, push, push_window
from ..ops.scaling import apply_scaling
from ..solvers.admm import dct_apply, dct_matrices, dct_membrane_eigs
from ..utils.host import to_host
from .sharding import _rank_device, _vx


@dataclasses.dataclass
class SpatialMesh:
    """The ('space',) mesh: ``n`` slabs, this rank's ``rank``, the
    ``group`` (the world) and this rank's ``device``."""

    n: int
    rank: int
    group: object
    device: torch.device


def build_spatial_mesh(n_devices: int | None = None) -> SpatialMesh:
    """One slab per rank of the world (``n_devices``, when given, must be
    the world size)."""
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"build_spatial_mesh: {n_devices} != world {n}")
    return SpatialMesh(n=n, rank=dist.get_rank(), group=dist.group.WORLD,
                       device=_rank_device())


def _swap(to_prev, to_next, mesh: SpatialMesh):
    """Send ``to_prev`` to the previous rank and ``to_next`` to the next
    (either may be None: not sent), and return (from_prev, from_next), what
    they sent this rank, zeros where there is no neighbour. Every rank
    calls it with the same Nones and shapes, so the pairs match."""
    r, n = mesh.rank, mesh.n
    ops, keep = [], []
    from_prev = from_next = None
    if to_prev is not None:
        from_next = to_prev.new_zeros(to_prev.shape)
        if r > 0:
            keep.append(to_prev.contiguous())
            ops.append(dist.P2POp(dist.isend, keep[-1], r - 1, mesh.group))
        if r < n - 1:
            ops.append(dist.P2POp(dist.irecv, from_next, r + 1, mesh.group))
    if to_next is not None:
        from_prev = to_next.new_zeros(to_next.shape)
        if r < n - 1:
            keep.append(to_next.contiguous())
            ops.append(dist.P2POp(dist.isend, keep[-1], r + 1, mesh.group))
        if r > 0:
            ops.append(dist.P2POp(dist.irecv, from_prev, r - 1, mesh.group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev, from_next


def _shift_halo(u, shift: int, mesh: SpatialMesh, x_axis: int):
    """u shifted by one along the sharded axis with a ZERO global bound:
    shift=+1 -> u[i-1] (the first row from the previous rank), shift=-1 ->
    u[i+1]. With one slab this is ``ops.finite_diff._roll_zero``."""
    L = u.shape[x_axis]
    if shift == -1:
        _, head = _swap(u.narrow(x_axis, 0, 1), None, mesh)
        return torch.cat([u.narrow(x_axis, 1, L - 1), head], dim=x_axis)
    if shift == 1:
        tail, _ = _swap(None, u.narrow(x_axis, L - 1, 1), mesh)
        return torch.cat([tail, u.narrow(x_axis, 0, L - 1)], dim=x_axis)
    raise ValueError(shift)


def _shifted(u, s: int, d: int, mesh: SpatialMesh):
    return _shift_halo(u, s, mesh, 0) if d == 0 else _roll_zero(u, s, d)


def halo_gradient(dat, vx, which: str, mesh: SpatialMesh):
    """``im_gradient`` of a local (Xl, Y, Z) slab, the first axis's
    difference stitched across slab boundaries."""
    gs = []
    for d in range(3):
        if which == "forward":
            g = _shifted(dat, -1, d, mesh) - dat
        elif which == "backward":
            g = dat - _shifted(dat, 1, d, mesh)
        elif which == "central":
            g = 0.5 * (_shifted(dat, -1, d, mesh) - _shifted(dat, 1, d, mesh))
        else:
            raise ValueError(which)
        gs.append(g / float(vx[d]))
    return torch.stack(gs, dim=0)


def halo_divergence(p, vx, which: str, mesh: SpatialMesh):
    """The exact adjoint of :func:`halo_gradient` (p is (3, Xl, Y, Z))."""
    out = torch.zeros_like(p[0])
    for d in range(3):
        q = p[d]
        if which == "forward":
            a = _shifted(q, 1, d, mesh) - q
        elif which == "backward":
            a = q - _shifted(q, -1, d, mesh)
        elif which == "central":
            a = 0.5 * (_shifted(q, 1, d, mesh) - _shifted(q, -1, d, mesh))
        else:
            raise ValueError(which)
        out = out + a / float(vx[d])
    return out


def _extend_x(u, h: int, mesh: SpatialMesh):
    """(Xl, Y, Z) -> (Xl + 2h, Y, Z): h rows of each neighbour, zeros at the
    global ends."""
    tail, head = _swap(u[:h], u[-h:], mesh)
    return torch.cat([tail, u, head], dim=0)


def _make_slab_precond(Xl: int, dim_y: tuple, vx_y, device="cpu"):
    """The slab-LOCAL DCT preconditioner: ``solvers.admm``'s spectral
    preconditioner on the slab's own grid (Neumann bounds at the slab ends,
    wrong by one stencil row per boundary, which a preconditioner may be:
    it stays SPD and needs no collective).

    Returns ``precond(cdiag, rho_lam2) -> P`` with ``P(r)`` acting on a
    local (Xl, Y, Z) slab; ``cdiag`` the data-term diagonal, ``rho_lam2`` =
    rho lam^2 scaling the membrane eigenvalues.
    """
    ldim = (int(Xl),) + tuple(int(d) for d in dim_y[1:])
    Cx, Cy, Cz = dct_matrices(ldim, device)
    lamD = dct_membrane_eigs(ldim, vx_y, device)

    def precond(cdiag, rho_lam2):
        denom = cdiag + rho_lam2 * lamD

        def P(r):
            t = dct_apply(r[None], Cx.T, Cy.T, Cz.T)
            return dct_apply(t / denom, Cx, Cy, Cz)[0]

        return P

    return precond


def _psum(mesh: SpatialMesh):
    """psum(a, b, ...) -> the sums of a, b, ... over every slab, in ONE
    all-reduce (float32, as the JAX package's)."""
    def psum(*vals):
        s = torch.stack([torch.sum(v) for v in vals])
        dist.all_reduce(s, group=mesh.group)
        return s.unbind()

    return psum


def _pcg(lhs, rhs, x0, P, psum, max_iter: int, tol: float,
         return_iters: bool = False):
    """Preconditioned CG on local slabs, the inner products summed over the
    group: two all-reduces per step (r.z rides with the stop test's r.r).

    Residual-amplitude stop, ||r|| < tol ||r0||, read on the host once per
    step; every rank reads the same sums, so every rank stops at the same
    step. ``P = None`` runs plain CG.
    """
    if P is None:
        P = lambda v: v  # noqa: E731
    tiny = 1e-30
    x = x0
    r = rhs - lhs(x0)
    p = P(r)
    rz, rr0 = psum(r * p, r * r)
    thr = (tol * tol) * torch.clamp(rr0, min=tiny)
    it = 0
    while it < max_iter:
        Ap = lhs(p)
        (pAp,) = psum(p * Ap)
        alpha = rz / torch.clamp(pAp, min=tiny)
        x = x + alpha * p
        r = r - alpha * Ap
        zn = P(r)
        rz_new, rr = psum(r * zn, r * r)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = zn + beta * p
        rz = rz_new
        it += 1
        if bool(to_host(rr < thr)):
            break
    if return_iters:
        return x, it
    return x


def spatial_halo_bound(po: ProjOp, method: str = "denoising") -> int:
    """The halo (rows) the operator's resampling footprint needs: max
    |g_x - x| over the volume, plus the interpolation support, plus 1."""
    M = po.M_den() if method == "denoising" else po.M_sr()
    dim = po.dim_x if method == "denoising" else po.dim_yx
    off = abs(float(M[0, 3]))
    off += abs(float(M[0, 0]) - 1.0) * dim[0]
    off += abs(float(M[0, 1])) * dim[1] + abs(float(M[0, 2])) * dim[2]
    return int(np.ceil(off)) + 2


def _offset_map(M, out0: float, in0: float) -> np.ndarray:
    """The (3, 4) map between slabs whose first rows sit at global rows
    ``out0`` (output) and ``in0`` (input): M . (i + out0, j, k, 1) - in0 e_x,
    in float32 in the JAX package's order."""
    M = np.array(M, np.float32).reshape(3, 4)
    M[:, 3] = M[:, 3] + M[:, 0] * np.float32(out0)
    M[0, 3] = M[0, 3] + np.float32(-in0)
    return M


def _global_fov(dim_y, in0: float) -> np.ndarray:
    """The global bounds [-0.5, n - 0.5] in the frame of a slab whose first
    row sits at global row ``in0`` (float32, as the JAX package's)."""
    fov = np.array([[0.0, 0.0], [-0.5, dim_y[1] - 0.5],
                    [-0.5, dim_y[2] - 0.5]], np.float32)
    fov[0, 0] = np.float32(-0.5) - np.float32(in0)
    fov[0, 1] = np.float32(dim_y[0] - 0.5) - np.float32(in0)
    return fov


def slab_maps(M, Minv, dim_y, out0: float, src0: float, val0: float,
              tgt0: float) -> dict:
    """The maps and bounds of one rank's pull and push: pull reads the
    extended y slab starting at global row ``src0`` into output rows from
    ``out0``; push reads values on the extended grid from row ``val0`` into
    the y slab from row ``tgt0``. Keys ``Ml``, ``fov_pull``, ``Mp``,
    ``Mpi``, ``fov_push``."""
    return dict(Ml=_offset_map(M, out0, src0),
                fov_pull=_global_fov(dim_y, src0),
                Mp=_offset_map(M, val0, tgt0),
                Mpi=_offset_map(Minv, tgt0, val0),
                fov_push=_global_fov(dim_y, tgt0))


def make_spatial_admm_step(po: ProjOp, sett, mesh: SpatialMesh) -> Callable:
    """One slab-sharded ADMM iteration of the denoising chain (A = pull).

    Signature: step(ys, z, w, xdat, M, Minv, tau, lam, rho) -> (ys, z, w,
    obj), with this rank's slabs ys / xdat (C, Xl, Y, Z) and z / w (C, 3,
    Xl, Y, Z) (:func:`shard_spatial`), the host maps M / Minv (3, 4), tau /
    lam (C,) and rho. The math of ``solvers.admm.make_admm_body``'s
    denoising branch, with the slab-local DCT preconditioner
    (:func:`_make_slab_precond`) in place of the global one; ``obj``
    (float64) is the same on every rank.
    """
    n = mesh.n
    dim_y = tuple(int(d) for d in po.dim_y)
    if dim_y[0] % n:
        raise ValueError(f"{n} slabs do not divide {dim_y[0]} rows")
    Xl = dim_y[0] // n
    H = spatial_halo_bound(po, "denoising")
    if H > Xl:
        raise ValueError(f"halo {H} exceeds the slab's {Xl} rows: use fewer "
                         "slabs")
    vx_y = _vx(po)
    window = push_window(po.M_den())
    diff = sett.diff
    cg_iter = int(sett.cgs_max_iter)
    cg_tol = float(sett.cgs_tol)
    tiny = 1e-7
    precond_factory = _make_slab_precond(Xl, dim_y, vx_y, mesh.device)
    psum = _psum(mesh)
    x0 = mesh.rank * Xl
    loc_dim = (Xl,) + dim_y[1:]

    def step(ys, z, w, xdat, M, Minv, tau, lam, rho):
        rho = float(rho)
        # output row i_local = i_global - x0; extended-source row o_ext =
        # o_global - (x0 - H); the GLOBAL FOV in local coordinates
        mp = slab_maps(M, Minv, dim_y, x0, x0 - H, x0 - H, x0)

        def A_loc(yc):
            return pull(_extend_x(yc, H, mesh), mp["Ml"], loc_dim,
                        fov=mp["fov_pull"])

        def At_loc(xc):
            return push(_extend_x(xc, H, mesh), mp["Mp"], loc_dim,
                        Minv=mp["Mpi"], window=window, fov=mp["fov_push"])

        def y_update(yc, zc, wc, xc, tc, lc):
            rhs = tc * At_loc(xc)
            rhs = rhs - lc * halo_divergence(wc - rho * zc, vx_y, diff, mesh)

            def lhs(v):
                out = rho * lc * lc * halo_divergence(
                    halo_gradient(v, vx_y, diff, mesh), vx_y, diff, mesh)
                return out + tc * At_loc(A_loc(v))

            # cdiag = tau: the denoising A^T A(1) is ~1 inside the FOV
            P_slab = precond_factory(tc, rho * lc * lc)
            return _pcg(lhs, rhs, yc, P_slab, psum, cg_iter, cg_tol)

        taus = [float(t) for t in tau]
        lams = [float(v) for v in lam]
        C = ys.shape[0]
        ys = torch.stack([y_update(ys[c], z[c], w[c], xdat[c], taus[c],
                                   lams[c]) for c in range(C)])
        return _finish(ys, z, w, [
            0.5 * taus[c] * _sq_masked(xdat[c], A_loc(ys[c]))
            for c in range(C)], lams, rho, vx_y, diff, tiny, mesh)

    return step


def _sq_masked(xc, Ay):
    """sum over the observed voxels (x != 0) of (x - A y)^2, in float64."""
    res = torch.where(xc != 0, xc - Ay, 0.0)
    return (res * res).sum(dtype=torch.float64)


def _finish(ys, z, w, nll_terms, lams, rho, vx_y, diff, tiny, mesh):
    """The objective, the joint shrinkage z-update and the dual w-update of
    a slab step (channels are local: the JTV magnitude needs no
    collective; the two sums of the objective take one all-reduce)."""
    C = ys.shape[0]
    Dys = torch.stack([lams[c] * halo_gradient(ys[c], vx_y, diff, mesh)
                       for c in range(C)])
    nll = torch.stack([sum(nll_terms), torch.sqrt(
        torch.sum(Dys * Dys, dim=(0, 1))).sum(dtype=torch.float64)])
    dist.all_reduce(nll, group=mesh.group)
    u = w / rho + Dys
    mag = torch.sqrt(torch.sum(u * u, dim=(0, 1)))
    shrink = torch.clamp(mag - 1.0 / rho, min=0.0) / (mag + tiny)
    z = shrink[None, None] * u
    w = w + rho * (Dys - z)
    return ys, z, w, torch.stack([nll[0] + nll[1], nll[0], nll[1]])


def shard_spatial(mesh: SpatialMesh, ys, z, w, xdat):
    """This rank's slabs, on its device: ys (C, X, ...) and xdat (C, Xx,
    ...) cut along their first spatial axis, z / w (C, 3, X, ...) along
    theirs."""
    def cut(t, axis):
        t = torch.as_tensor(t)
        L = t.shape[axis] // mesh.n
        return t.narrow(axis, mesh.rank * L, L).to(mesh.device).contiguous()

    return cut(ys, 1), cut(z, 2), cut(w, 2), cut(xdat, 1)


# ---------------------------------------------------------------------------
# The super-resolution chain on slabs: halo convolutions and slab-consistent
# decimation
# ---------------------------------------------------------------------------

def _extend_overlap(u, h: int, ov: int, mesh: SpatialMesh):
    """Extend an OVERLAPPING first-axis decomposition by h rows per side.

    The SR chain's yx slabs overlap by ``ov`` rows (length L = (Xl_x - 1)
    r0 + K0, stride L - ov): the next rank's row k is this rank's row
    (L - ov) + k, so the h rows after this slab are the next rank's rows
    [ov, ov + h) and the h rows before it the previous rank's rows
    [L - ov - h, L - ov). Zeros at the global ends."""
    L = u.shape[0]
    tail, head = _swap(u[ov:ov + h], u[L - ov - h:L - ov], mesh)
    return torch.cat([tail, u, head], dim=0)


def _sum_overlap(u, ov: int, mesh: SpatialMesh):
    """The slab-consistent decimation adjoint: rows shared by neighbouring
    yx slabs hold PARTIAL sums after the local blur_up (each rank sees only
    its own x rows' contributions); the ov-row strips are exchanged and
    added, so every rank holds the full value of every row of its slab."""
    if ov <= 0:
        return u
    L = u.shape[0]
    from_prev, from_next = _swap(u[:ov], u[L - ov:], mesh)
    u = u.clone()
    u[L - ov:] += from_next
    u[:ov] += from_prev
    return u


def sr_halo_bounds(po: ProjOp, n: int) -> tuple:
    """(H_pull, H_push): the y-slab halo of the pull and the yx-slab halo of
    the push, from every slab's worst-case footprint of the SR map (affine
    in the row index, hence extreme at the slab and in-plane corners)."""
    M4 = np.eye(4)
    M4[:3, :4] = np.asarray(po.M_sr(), np.float64)
    Minv = np.linalg.inv(M4)
    dyx, dy = po.dim_yx, po.dim_y
    Xl_y = dy[0] // n
    Xl_x = po.dim_x[0] // n
    r0 = int(po.ratio[0])
    K0 = int(np.asarray(po.smo_ker_1d[0]).shape[0])
    Lyx = (Xl_x - 1) * r0 + K0
    L1 = np.abs(Minv[0, :3]).sum()
    Hp = Hq = 0.0
    for idx in range(n):
        s_yx = idx * Xl_x * r0
        y0 = idx * Xl_y
        for j in (s_yx, s_yx + Lyx - 1):
            for b in (0, dyx[1] - 1):
                for c in (0, dyx[2] - 1):
                    g = (M4[0, 0] * j + M4[0, 1] * b + M4[0, 2] * c
                         + M4[0, 3])
                    Hp = max(Hp, y0 - g, g - (y0 + Xl_y - 1))
        for i in (y0, y0 + Xl_y - 1):
            for b in (0, dy[1] - 1):
                for c in (0, dy[2] - 1):
                    ci = (Minv[0, 0] * i + Minv[0, 1] * b + Minv[0, 2] * c
                          + Minv[0, 3])
                    Hq = max(Hq, s_yx - (ci - L1),
                             (ci + L1) - (s_yx + Lyx - 1))
    return int(np.ceil(Hp)) + 2, int(np.ceil(Hq)) + 2


def make_spatial_admm_step_sr(po: ProjOp, sett,
                              mesh: SpatialMesh) -> Callable:
    """One slab-sharded ADMM iteration of the SUPER-RESOLUTION chain.

    Signature: step(ys, z, w, xdat, M, Minv, scl, tau, lam, rho) -> (ys, z,
    w, obj); this rank's slabs ys (C, Xl, Y, Z), xdat (C, Xl_x, Yx, Zx),
    z / w (C, 3, Xl, Y, Z); scl / tau / lam (C,) host values.

    The operator chain on slabs:
      pull   y -> yx : read-only y halo, a map offset to the slab, the
                       global FOV bounds, as the denoising step;
      blur   yx -> x : no exchange: each yx slab is (Xl_x - 1) r0 + K0 rows
                       long, the kernel's overlap built in, so the decimated
                       rows a rank owns read only its own rows;
      scale  x -> x  : even / odd parity from the GLOBAL slice index;
      adjoint        : the local blur_up leaves partial sums on the
                       overlapping rows, exchanged once per side
                       (:func:`_sum_overlap`); then a read-only yx halo
                       feeds the gather-form push into the local y slab.
    """
    n = mesh.n
    dim_y = tuple(int(d) for d in po.dim_y)
    dim_x = tuple(int(d) for d in po.dim_x)
    dim_yx = tuple(int(d) for d in po.dim_yx)
    if dim_y[0] % n or dim_x[0] % n:
        raise ValueError(f"{n} slabs must divide {dim_y[0]} and {dim_x[0]}")
    Xl_y = dim_y[0] // n
    Xl_x = dim_x[0] // n
    r0 = int(po.ratio[0])
    kers = [np.asarray(k) for k in po.smo_ker_1d]
    ratio = tuple(int(r) for r in po.ratio)
    K0 = kers[0].shape[0]
    Lyx = (Xl_x - 1) * r0 + K0
    ov = K0 - r0
    if ov < 0:
        raise ValueError("first-axis kernel shorter than its stride")
    if (n - 1) * Xl_x * r0 + Lyx != dim_yx[0]:
        raise ValueError("the yx slabs do not tile dim_yx")
    H, H2 = sr_halo_bounds(po, n)
    if H > Xl_y:
        raise ValueError(f"pull halo {H} exceeds the y slab {Xl_y}")
    if ov + H2 > Lyx:
        raise ValueError(f"push halo {H2} exceeds the yx slab")
    dim_thick = int(po.dim_thick)
    vx_y = _vx(po)
    window = push_window(po.M_sr())
    diff = sett.diff
    cg_iter = int(sett.cgs_max_iter)
    cg_tol = float(sett.cgs_tol)
    tiny = 1e-7
    precond_factory = _make_slab_precond(Xl_y, dim_y, vx_y, mesh.device)
    # cdiag: tau mean(A^T A 1) ~ tau sum(ker)^2 / prod(ratio) (the blur
    # keeps mass, the decimation one sample in prod(ratio))
    ata1_mean = float(np.prod([np.sum(k) ** 2 for k in kers])
                      / np.prod(ratio))
    psum = _psum(mesh)
    idx = mesh.rank
    x0y = idx * Xl_y
    s_yx = idx * Xl_x * r0
    pull_dim = (Lyx,) + dim_yx[1:]
    loc_dim = (Xl_y,) + dim_y[1:]
    # the parity of the slab's x rows, from their GLOBAL index
    rows = torch.arange(Xl_x, device=mesh.device) + idx * Xl_x
    sgn = torch.where(rows % 2 == 0, 1.0, -1.0).reshape(Xl_x, 1, 1)

    def scale_loc(t, s):
        if dim_thick == 0:
            return t * torch.exp(s * sgn)
        return apply_scaling(t, s, dim_thick)

    def step(ys, z, w, xdat, M, Minv, scl, tau, lam, rho):
        rho = float(rho)
        mp = slab_maps(M, Minv, dim_y, s_yx, x0y - H, s_yx - H2, x0y)

        def pull_loc(yc):
            return pull(_extend_x(yc, H, mesh), mp["Ml"], pull_dim,
                        fov=mp["fov_pull"])

        def push_half(t):
            t = _extend_overlap(_sum_overlap(t, ov, mesh), H2, ov, mesh)
            return push(t, mp["Mp"], loc_dim, Minv=mp["Mpi"], window=window,
                        fov=mp["fov_push"])

        def A_loc(yc, s):
            return scale_loc(blur_down_sep(pull_loc(yc), kers, ratio), s)

        def y_update(yc, zc, wc, xc, sc, tc, lc):
            rhs = tc * push_half(blur_up_sep(scale_loc(xc, sc), kers, ratio))
            rhs = rhs - lc * halo_divergence(wc - rho * zc, vx_y, diff, mesh)

            def lhs(v):
                out = rho * lc * lc * halo_divergence(
                    halo_gradient(v, vx_y, diff, mesh), vx_y, diff, mesh)
                t = scale_loc(blur_down_sep(pull_loc(v), kers, ratio),
                              2.0 * sc)
                return out + tc * push_half(blur_up_sep(t, kers, ratio))

            P_slab = precond_factory(tc * ata1_mean, rho * lc * lc)
            return _pcg(lhs, rhs, yc, P_slab, psum, cg_iter, cg_tol)

        scls = [float(s) for s in scl]
        taus = [float(t) for t in tau]
        lams = [float(v) for v in lam]
        C = ys.shape[0]
        ys = torch.stack([y_update(ys[c], z[c], w[c], xdat[c], scls[c],
                                   taus[c], lams[c]) for c in range(C)])
        return _finish(ys, z, w, [
            0.5 * taus[c] * _sq_masked(xdat[c], A_loc(ys[c], scls[c]))
            for c in range(C)], lams, rho, vx_y, diff, tiny, mesh)

    return step
