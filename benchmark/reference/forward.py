"""The plain forward model of a thick-slice acquisition, and its objective.

Written from UniRes' published model (reference unires/_project.py): an
observation is the recon volume pulled onto the observation's grid,
upsampled along the slice axis (trilinear, zero outside the field of view
[-0.5, n - 0.5]), blurred by the slice profile and decimated by the integer
ratio of the voxel sizes, then even / odd slices multiplied by exp(+s) /
exp(-s). The objective of a recon is the Gaussian data term plus the joint
total variation (forward differences, zero bound, divided by the voxel size)
of all channels, each channel weighted by its lambda.

Every linear map along an axis (the slice-profile blur with its decimation,
the finite differences) is a dense matrix product: the textbook definition
of a separable operator. The functions take the dtype they compute in, so
the same code gives the float64 reference and, with TF32 operands in its
matrix products, the control one precision step below float32. Sums are
accumulated in float64 either way. Nothing here imports the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def voxel_size(mat) -> np.ndarray:
    mat = np.asarray(mat, np.float64)
    return np.sqrt((mat[:3, :3] ** 2).sum(axis=0))


def affine_matrix_classic(p) -> np.ndarray:
    """SPM's affine from [tx ty tz rx ry rz] (radians, T @ Rx @ Ry @ Rz)."""
    p = np.zeros(6) + np.asarray(p, np.float64).ravel()
    T = np.eye(4)
    T[:3, 3] = p[:3]
    cx, sx = math.cos(p[3]), math.sin(p[3])
    cy, sy = math.cos(p[4]), math.sin(p[4])
    cz, sz = math.cos(p[5]), math.sin(p[5])
    Rx = np.array([[1, 0, 0, 0], [0, cx, sx, 0], [0, -sx, cx, 0], [0, 0, 0, 1]])
    Ry = np.array([[cy, 0, sy, 0], [0, 1, 0, 0], [-sy, 0, cy, 0], [0, 0, 0, 1]])
    Rz = np.array([[cz, sz, 0, 0], [-sz, cz, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    return T @ Rx @ Ry @ Rz


# ---------------------------------------------------------------------------
# Slice profile
# ---------------------------------------------------------------------------

def _phi(x):
    return 0.5 * (1.0 + np.vectorize(math.erf)(np.asarray(x, np.float64)
                                               / math.sqrt(2.0)))


def kernel_1d(profile: int, fwhm: float) -> np.ndarray:
    """Slice-profile taps (-1 dirac, 0 rect, 2 gaussian of full width at half
    maximum ``fwhm`` voxels), each the profile's integral over its voxel,
    odd length, normalised to sum 1."""
    if profile == -1 or fwhm <= 1e-6:
        return np.ones(1)
    if profile == 0:
        radius = int(math.ceil((fwhm + 1.0) / 2.0 - 0.5))
        t = np.arange(-radius, radius + 1, dtype=np.float64)
        lo, hi = t - 0.5, t + 0.5
        ker = np.clip(np.minimum(hi, fwhm / 2) - np.maximum(lo, -fwhm / 2),
                      0.0, None) / fwhm
    elif profile == 2:
        sd = fwhm / math.sqrt(8.0 * math.log(2.0))
        radius = max(1, int(math.ceil(3.0 * sd + 0.5)))
        t = np.arange(-radius, radius + 1, dtype=np.float64)
        ker = _phi((t + 0.5) / sd) - _phi((t - 0.5) / sd)
    else:
        raise ValueError(f"profile {profile} is not modelled")
    nz = np.nonzero(ker > 0)[0]
    r = max(radius - nz[0], nz[-1] - radius)
    ker = ker[radius - r:radius + r + 1]
    return ker / ker.sum()


# ---------------------------------------------------------------------------
# Geometry of one observation
# ---------------------------------------------------------------------------

def obs_geometry(dim_y, mat_y, dim_x, mat_x, prof_ip=2, prof_tp=0):
    """The upsampled grid of an observation: the integer ratio of its voxel
    size to the recon's per axis, the grid ``yx`` of the observation refined
    by that ratio and padded by the kernel's half width (dims and
    voxel-to-world affine), the taps per axis and the slice axis."""
    mat_x = np.asarray(mat_x, np.float64)
    vx_x = voxel_size(mat_x)
    thick = int(np.argmax(vx_x))
    ratio = np.linalg.solve(np.asarray(mat_y, np.float64), mat_x)
    ratio = np.maximum(np.ceil(np.sqrt((ratio[:3, :3] ** 2).sum(0)) - 1e-4),
                       1.0)
    kers = []
    for d in range(3):
        prof = -1 if ratio[d] == 1.0 else (prof_tp if d == thick else prof_ip)
        kers.append(kernel_1d(prof, float(ratio[d])))
    half = np.array([(k.size - 1) // 2 for k in kers], np.float64)
    mat_yx = mat_x @ np.diag(np.r_[1.0 / ratio, 1.0])
    shift = np.eye(4)
    shift[:3, 3] = -half
    dim_yx = (np.asarray(dim_x, np.float64) - 1.0) * ratio + 1.0 + 2.0 * half
    return dict(ratio=tuple(int(r) for r in ratio), mat_yx=mat_yx @ shift,
                dim_yx=tuple(int(d) for d in dim_yx), kers=kers, thick=thick,
                dim_x=tuple(int(d) for d in dim_x), dim_y=tuple(dim_y))


def decimation_matrix(ker, ratio, n_out, device, dtype):
    """(n_out, (n_out - 1) ratio + len(ker)): out[i] = sum_t ker[t] in[r i + t]."""
    K = len(ker)
    B = torch.zeros((n_out, (n_out - 1) * ratio + K), dtype=torch.float64)
    for i in range(n_out):
        B[i, ratio * i:ratio * i + K] = torch.as_tensor(ker)
    return B.to(device=device, dtype=dtype)


def to_tf32(t):
    """float32 ``t`` rounded to TF32's 10-bit mantissa (to nearest), as a
    tensor core reads a float32 operand when TF32 is allowed."""
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def along(vol, mat, axis, tf32=False):
    """The matrix ``mat`` (n_out, n_in) applied along ``axis`` of ``vol``;
    ``tf32``: both float32 operands rounded to TF32 first."""
    v = torch.movedim(vol, axis, -1)
    if tf32:
        v, mat = to_tf32(v), to_tf32(mat)
    return torch.movedim(torch.matmul(v, mat.T), -1, axis)


# ---------------------------------------------------------------------------
# Resampling
# ---------------------------------------------------------------------------

def sample_points(M, out_dim, device, dtype):
    """g_d = M[d,0] i + M[d,1] j + M[d,2] k + M[d,3] for every voxel (i, j,
    k) of ``out_dim``, formed in ``dtype`` from the map ``M`` (its (3, 4)
    part) as the model states it."""
    M = torch.as_tensor(np.asarray(M, np.float64)[:3, :4], device=device,
                        dtype=dtype)
    idx = [torch.arange(n, device=device, dtype=dtype) for n in out_dim]
    return [M[d, 0] * idx[0][:, None, None] + M[d, 1] * idx[1][None, :, None]
            + M[d, 2] * idx[2][None, None, :] + M[d, 3] for d in range(3)]


def pull(vol, M, out_dim):
    """Trilinear samples of ``vol`` at the points g of ``M``
    (:func:`sample_points`) for every voxel of ``out_dim``: corners outside
    the volume read 0, points outside [-0.5, n - 0.5] on any axis give 0. In
    ``vol``'s dtype."""
    dev, dt = vol.device, vol.dtype
    g = sample_points(M, out_dim, dev, dt)
    n = vol.shape
    inside = torch.ones(out_dim, dtype=torch.bool, device=dev)
    for d in range(3):
        inside &= (g[d] >= -0.5) & (g[d] <= n[d] - 0.5)
    i0 = [torch.floor(gd) for gd in g]
    f = [gd - i for gd, i in zip(g, i0)]
    i0 = [i.to(torch.int64) for i in i0]
    flat = vol.reshape(-1)
    out = torch.zeros(out_dim, dtype=dt, device=dev)
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                w = ((f[0] if a else 1 - f[0]) * (f[1] if b else 1 - f[1])
                     * (f[2] if c else 1 - f[2]))
                ii, jj, kk = i0[0] + a, i0[1] + b, i0[2] + c
                ok = ((ii >= 0) & (ii < n[0]) & (jj >= 0) & (jj < n[1])
                      & (kk >= 0) & (kk < n[2]))
                lin = ((ii.clamp(0, n[0] - 1) * n[1] + jj.clamp(0, n[1] - 1))
                       * n[2] + kk.clamp(0, n[2] - 1))
                out += torch.where(ok, w * torch.take(flat, lin), 0.0)
                del w, ii, jj, kk, ok, lin
    return torch.where(inside, out, 0.0)


def push(vals, M, vol_dim):
    """The adjoint of :func:`pull`: each sample's value added to its corners
    with the same weights."""
    dev, dt = vals.device, vals.dtype
    out_dim = tuple(vals.shape)
    g = sample_points(M, out_dim, dev, dt)
    n = tuple(vol_dim)
    inside = torch.ones(out_dim, dtype=torch.bool, device=dev)
    for d in range(3):
        inside &= (g[d] >= -0.5) & (g[d] <= n[d] - 0.5)
    vals = torch.where(inside, vals, 0.0)
    i0 = [torch.floor(gd) for gd in g]
    f = [gd - i for gd, i in zip(g, i0)]
    i0 = [i.to(torch.int64) for i in i0]
    out = torch.zeros(n[0] * n[1] * n[2], dtype=dt, device=dev)
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                w = ((f[0] if a else 1 - f[0]) * (f[1] if b else 1 - f[1])
                     * (f[2] if c else 1 - f[2]))
                ii, jj, kk = i0[0] + a, i0[1] + b, i0[2] + c
                ok = ((ii >= 0) & (ii < n[0]) & (jj >= 0) & (jj < n[1])
                      & (kk >= 0) & (kk < n[2]))
                lin = ((ii.clamp(0, n[0] - 1) * n[1] + jj.clamp(0, n[1] - 1))
                       * n[2] + kk.clamp(0, n[2] - 1))
                out.index_add_(0, lin.reshape(-1),
                               torch.where(ok, w * vals, 0.0).reshape(-1))
    return out.reshape(n)


def even_odd(vol, scl, axis):
    """Slices of even index along ``axis`` times exp(scl), odd exp(-scl)."""
    n = vol.shape[axis]
    sgn = torch.where(torch.arange(n, device=vol.device) % 2 == 0, 1.0, -1.0)
    shape = [1, 1, 1]
    shape[axis] = n
    return vol * torch.exp(float(scl) * sgn.to(vol.dtype)).reshape(shape)


def project(y, mat_y, rigid, geom, scl, tf32=False):
    """A y: the recon ``y`` (on the grid of ``mat_y``) seen by an observation
    of geometry ``geom`` (:func:`obs_geometry`) at world pose ``rigid`` with
    even / odd scaling ``scl``, in ``y``'s dtype."""
    M = np.linalg.solve(np.asarray(mat_y, np.float64),
                        np.asarray(rigid, np.float64) @ geom["mat_yx"])
    out = pull(y, M, geom["dim_yx"])
    for d in range(3):
        if geom["ratio"][d] > 1 or len(geom["kers"][d]) > 1:
            B = decimation_matrix(geom["kers"][d], geom["ratio"][d],
                                  geom["dim_x"][d], y.device, y.dtype)
            out = along(out, B, d, tf32)
    return even_odd(out, scl, geom["thick"])


def backproject(x, mat_y, rigid, geom, scl):
    """A^T x: the adjoint of :func:`project`, onto the recon grid
    ``geom["dim_y"]``."""
    M = np.linalg.solve(np.asarray(mat_y, np.float64),
                        np.asarray(rigid, np.float64) @ geom["mat_yx"])
    out = even_odd(x, scl, geom["thick"])
    for d in range(3):
        if geom["ratio"][d] > 1 or len(geom["kers"][d]) > 1:
            B = decimation_matrix(geom["kers"][d], geom["ratio"][d],
                                  geom["dim_x"][d], x.device, x.dtype)
            out = along(out, B.T, d)
    return push(out, M, geom["dim_y"])


def difference_matrix(n, vx, device, dtype):
    """Forward differences with a zero bound, over the voxel size: (n, n)."""
    D = -torch.eye(n, dtype=torch.float64)
    D[torch.arange(n - 1), torch.arange(1, n)] = 1.0
    return (D / float(vx)).to(device=device, dtype=dtype)


def objective(ys, lams, mat_y, obs, dtype, tf32=False):
    """(data term, prior term) in float64 of the recon channels ``ys``
    (C, X, Y, Z) with weights ``lams`` (C,), computed in ``dtype``: the data
    term sums 0.5 tau |x - A y|^2 over every observation's nonzero voxels
    (``obs``: dicts of channel ``c``, data ``x``, ``geom``, ``rigid``,
    ``scl`` and ``tau``); the prior sums, over voxels, the root of the sum
    over channels and axes of (lam_c D_d y_c)^2. ``tf32``: every matrix
    product with TF32 operands (``dtype`` float32)."""
    dev = ys.device
    data = 0.0
    for o in obs:
        x = o["x"].to(dtype)
        res = torch.where(x != 0, x - project(ys[o["c"]].to(dtype), mat_y,
                                              o["rigid"], o["geom"],
                                              o["scl"], tf32), 0.0)
        data += 0.5 * float(o["tau"]) * float(torch.sum(res * res,
                                                        dtype=torch.float64))
        del x, res
    vx = voxel_size(mat_y)
    sq = torch.zeros(ys.shape[1:], dtype=dtype, device=dev)
    for c in range(ys.shape[0]):
        yc = ys[c].to(dtype)
        for d in range(3):
            D = difference_matrix(yc.shape[d], vx[d], dev, dtype)
            g = float(lams[c]) * along(yc, D, d, tf32)
            sq += g * g
            del g
    prior = float(torch.sum(torch.sqrt(sq), dtype=torch.float64))
    return data, prior
