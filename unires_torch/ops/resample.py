"""Affine resampling: pull (gather), push (its exact adjoint), pull_grad.

Semantics of ``unires_tpu.ops.resample`` (zero bound, ``extrapolate=False``
over the FOV [-0.5, n-0.5]^3, trilinear or nearest), written twice:

* the plain PyTorch versions ``pull_plain`` / ``push_plain`` /
  ``pull_grad_plain``, tensor ops transcribed from the XLA oracles; and
* hand-written CUDA kernels (``unires_torch/csrc/resample.cu``) for pull and
  push, which replace the six Pallas kernels of
  ``unires_tpu/ops/pallas_resample.py`` that the card cannot run.

The public ``pull`` / ``push`` take the tensor's device as the dispatch rule:
a CPU tensor goes through the plain version, a CUDA tensor through the kernel
(or an error). There is no fallback from one to the other. Each wrapper counts
its kernel launches in ``pull.launches`` / ``push.launches``.

Maps: ``M`` is the (3, 4) float32 map from output voxel to input voxel, held
on the host (numpy) — it is 12 numbers that reach the kernel as launch
arguments, the CUDA counterpart of the Pallas kernels' scalar prefetch.
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda_build import check, kernels


def affine_to_M(mat) -> np.ndarray:
    """4x4 host affine (float64) -> (3, 4) float32 host map."""
    mat = np.asarray(mat, dtype=np.float64)
    return np.ascontiguousarray(mat[:3, :4], dtype=np.float32)


def _as_map(M) -> np.ndarray:
    if isinstance(M, torch.Tensor):
        M = M.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(M, np.float32).reshape(3, 4))


def inverse_map(M) -> np.ndarray:
    """(3, 4) float32 inverse of a (3, 4) map, inverted in float64."""
    M4 = np.eye(4)
    M4[:3, :4] = _as_map(M)
    return np.ascontiguousarray(np.linalg.inv(M4)[:3, :4], dtype=np.float32)


def push_window(M) -> tuple:
    """Per-axis half-window of the gather-form adjoint (as the JAX package's).

    Every source point o with a nonzero trilinear weight onto target voxel v
    satisfies |M o - v|_inf < 1, hence |o - M^{-1} v|_inf < L_d where L_d is
    the L1 row norm of M^{-1}'s linear part. Anchoring at round(M^{-1} v), the
    offsets needed are {-n_d..n_d} with n_d = floor(1.25 L_d + 0.5) (25 %
    slack, as the JAX package).
    A window that is too small silently drops mass; the adjointness tests
    catch that.
    """
    M4 = np.eye(4)
    M4[:3, :4] = np.asarray(M, dtype=np.float64).reshape(3, 4)
    Minv = np.linalg.inv(M4)
    L = np.abs(Minv[:3, :3]).sum(axis=1) * 1.25
    return tuple(int(np.floor(Ld + 0.5)) for Ld in L)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path, and the card's reference)
# ---------------------------------------------------------------------------

def _sample_coords(M: np.ndarray, out_dim, device):
    """g_d(i,j,k) = M[d,0] i + M[d,1] j + M[d,2] k + M[d,3], left to right."""
    ii, jj, kk = (torch.arange(n, dtype=torch.float32, device=device)
                  for n in out_dim)
    ii = ii[:, None, None]
    jj = jj[None, :, None]
    kk = kk[None, None, :]
    return [float(M[d, 0]) * ii + float(M[d, 1]) * jj + float(M[d, 2]) * kk
            + float(M[d, 3]) for d in range(3)]


def _map_points(M: np.ndarray, o):
    """g_d(o) for a full grid of source points o (same expression and order
    as :func:`_sample_coords`, hence bitwise-equal sample points)."""
    return [float(M[d, 0]) * o[0] + float(M[d, 1]) * o[1]
            + float(M[d, 2]) * o[2] + float(M[d, 3]) for d in range(3)]


def _fov_mask(g, in_dim):
    m = None
    for d in range(3):
        md = (g[d] >= -0.5) & (g[d] <= in_dim[d] - 0.5)
        m = md if m is None else (m & md)
    return m


def _corner_data(g, in_dim, order):
    """(flat index, weight) per interpolation corner; out-of-range corners
    get weight 0 and a clipped (valid) index."""
    X, Y, Z = in_dim
    if order == 0:
        idx = [torch.floor(g[d] + 0.5).to(torch.int64) for d in range(3)]
        inb = ((idx[0] >= 0) & (idx[0] < X) & (idx[1] >= 0) & (idx[1] < Y)
               & (idx[2] >= 0) & (idx[2] < Z))
        ic = [idx[d].clamp(0, in_dim[d] - 1) for d in range(3)]
        yield (ic[0] * Y + ic[1]) * Z + ic[2], inb.to(torch.float32)
        return
    i0 = [torch.floor(g[d]).to(torch.int64) for d in range(3)]
    f = [g[d] - i0[d].to(torch.float32) for d in range(3)]
    for a in (0, 1):
        wa = f[0] if a else 1.0 - f[0]
        ia = i0[0] + a
        oka = (ia >= 0) & (ia < X)
        ia = ia.clamp(0, X - 1)
        for b in (0, 1):
            wb = f[1] if b else 1.0 - f[1]
            ib = i0[1] + b
            okb = (ib >= 0) & (ib < Y)
            ib = ib.clamp(0, Y - 1)
            for c in (0, 1):
                wc = f[2] if c else 1.0 - f[2]
                ic = i0[2] + c
                okc = (ic >= 0) & (ic < Z)
                ic = ic.clamp(0, Z - 1)
                w = wa * wb * wc * (oka & okb & okc).to(torch.float32)
                yield (ia * Y + ib) * Z + ic, w


def pull_plain(vol: torch.Tensor, M, out_dim, order: int = 1) -> torch.Tensor:
    """Plain PyTorch pull (``unires_tpu.ops.resample._pull_gather``)."""
    M = _as_map(M)
    out_dim = tuple(int(d) for d in out_dim)
    in_dim = tuple(vol.shape)
    g = _sample_coords(M, out_dim, vol.device)
    mask = _fov_mask(g, in_dim).to(vol.dtype)
    flat = vol.reshape(-1)
    out = torch.zeros(out_dim, dtype=vol.dtype, device=vol.device)
    for idx, w in _corner_data(g, in_dim, order):
        out = out + w * torch.take(flat, idx)
    return out * mask


def push_plain(vals: torch.Tensor, M, vol_dim, order: int = 1,
               Minv=None) -> torch.Tensor:
    """Plain PyTorch push, the gather form of pull^T
    (``unires_tpu.ops.resample._push_gather``)."""
    M = _as_map(M)
    Minv = inverse_map(M) if Minv is None else _as_map(Minv)
    window = push_window(M)
    vol_dim = tuple(int(d) for d in vol_dim)
    in_dim = tuple(vals.shape)  # source grid (pull's output grid)
    dev = vals.device
    c = _sample_coords(Minv, vol_dim, dev)
    anchor = [torch.floor(c[d] + 0.5).clamp(-2.0 ** 20, 2.0 ** 20)
              .to(torch.int64) for d in range(3)]
    v = [torch.arange(n, dtype=torch.int64, device=dev) for n in vol_dim]
    v = [v[0][:, None, None], v[1][None, :, None], v[2][None, None, :]]
    flat = vals.reshape(-1)
    out = torch.zeros(vol_dim, dtype=vals.dtype, device=dev)
    for da in range(-window[0], window[0] + 1):
        for db in range(-window[1], window[1] + 1):
            for dc in range(-window[2], window[2] + 1):
                o = [anchor[0] + da, anchor[1] + db, anchor[2] + dc]
                ok = ((o[0] >= 0) & (o[0] < in_dim[0]) & (o[1] >= 0)
                      & (o[1] < in_dim[1]) & (o[2] >= 0) & (o[2] < in_dim[2]))
                g = _map_points(M, [o[d].to(torch.float32) for d in range(3)])
                fovm = _fov_mask(g, vol_dim)
                w = None
                for d in range(3):
                    if order == 0:
                        nd = torch.floor(g[d] + 0.5).to(torch.int64)
                        wd = (nd == v[d]).to(torch.float32)
                    else:
                        a = torch.floor(g[d])
                        f = g[d] - a
                        ai = a.to(torch.int64)
                        wd = torch.where(v[d] == ai, 1.0 - f,
                                         torch.where(v[d] == ai + 1, f, 0.0))
                    w = wd if w is None else w * wd
                w = w * (ok & fovm).to(torch.float32)
                oc = [o[d].clamp(0, in_dim[d] - 1) for d in range(3)]
                idx = (oc[0] * in_dim[1] + oc[1]) * in_dim[2] + oc[2]
                out = out + w * torch.take(flat, idx)
    return out


def pull_grad_plain(vol: torch.Tensor, M, out_dim) -> torch.Tensor:
    """d pull / d g (trilinear): shape out_dim + (3,)
    (``unires_tpu.ops.resample._pull_grad_gather``)."""
    M = _as_map(M)
    out_dim = tuple(int(d) for d in out_dim)
    in_dim = tuple(vol.shape)
    X, Y, Z = in_dim
    g = _sample_coords(M, out_dim, vol.device)
    mask = _fov_mask(g, in_dim).to(vol.dtype)
    flat = vol.reshape(-1)
    i0 = [torch.floor(g[d]).to(torch.int64) for d in range(3)]
    f = [g[d] - i0[d].to(torch.float32) for d in range(3)]
    grads = [torch.zeros(out_dim, dtype=vol.dtype, device=vol.device)
             for _ in range(3)]
    for a in (0, 1):
        wa = f[0] if a else 1.0 - f[0]
        da = 1.0 if a else -1.0
        ia = i0[0] + a
        oka = (ia >= 0) & (ia < X)
        ia = ia.clamp(0, X - 1)
        for b in (0, 1):
            wb = f[1] if b else 1.0 - f[1]
            db = 1.0 if b else -1.0
            ib = i0[1] + b
            okb = (ib >= 0) & (ib < Y)
            ib = ib.clamp(0, Y - 1)
            for c in (0, 1):
                wc = f[2] if c else 1.0 - f[2]
                dc = 1.0 if c else -1.0
                ic = i0[2] + c
                okc = (ic >= 0) & (ic < Z)
                ic = ic.clamp(0, Z - 1)
                ok = (oka & okb & okc).to(torch.float32)
                val = torch.take(flat, (ia * Y + ib) * Z + ic) * ok
                grads[0] = grads[0] + da * wb * wc * val
                grads[1] = grads[1] + wa * db * wc * val
                grads[2] = grads[2] + wa * wb * dc * val
    return torch.stack([gd * mask for gd in grads], dim=-1)


# ---------------------------------------------------------------------------
# Public wrappers: plain version on the CPU, CUDA kernel on the card
# ---------------------------------------------------------------------------

def _on_cpu(t: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor; checks a CUDA tensor for the kernel; raises
    for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if t.dim() != 3:
        raise ValueError(f"{name}: expected a 3D volume, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel needs a contiguous volume")
    return False


def _check_size(*dims) -> None:
    # the kernels index in int32: every volume must hold < 2**31 voxels
    for dim in dims:
        if int(np.prod(np.asarray(dim, np.int64))) >= 2 ** 31:
            raise ValueError(f"volume {tuple(dim)} too large for int32 indexing")


def _check_order(order: int) -> int:
    if order not in (0, 1):
        raise ValueError(f"interpolation order {order} (use 0 or 1)")
    return int(order)


def pull(vol: torch.Tensor, M, out_dim, order: int = 1) -> torch.Tensor:
    """Sample ``vol`` at g = M @ (i,j,k,1) for every output voxel.

    Zero bound, no extrapolation; ``order`` 0 (nearest) or 1 (trilinear).
    ``M`` is the (3, 4) map from output voxel to input voxel (host array).
    """
    order = _check_order(order)
    out_dim = tuple(int(d) for d in out_dim)
    if _on_cpu(vol, "pull"):
        return pull_plain(vol, M, out_dim, order)
    M = _as_map(M)
    _check_size(vol.shape, out_dim)
    out = torch.empty(out_dim, dtype=torch.float32, device=vol.device)
    with torch.cuda.device(vol.device):
        err = kernels.get().unires_pull(
            vol.data_ptr(), out.data_ptr(), M.ctypes.data, *vol.shape,
            *out_dim, order, torch.cuda.current_stream().cuda_stream)
    check(err, "pull")
    pull.launches += 1
    return out


pull.launches = 0


def push(vals: torch.Tensor, M, vol_dim, order: int = 1,
         Minv=None) -> torch.Tensor:
    """Exact adjoint of :func:`pull` (gather form, no atomics).

    ``M`` is the SAME (3, 4) map given to pull (source voxel -> target
    voxel). ``Minv`` (its inverse) is derived from ``M`` on the host when
    not given; the candidate window (:func:`push_window`) always is.
    """
    order = _check_order(order)
    vol_dim = tuple(int(d) for d in vol_dim)
    if _on_cpu(vals, "push"):
        return push_plain(vals, M, vol_dim, order, Minv)
    M = _as_map(M)
    Minv = inverse_map(M) if Minv is None else _as_map(Minv)
    window = push_window(M)
    _check_size(vals.shape, vol_dim)
    out = torch.empty(vol_dim, dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        err = kernels.get().unires_push(
            vals.data_ptr(), out.data_ptr(), M.ctypes.data, Minv.ctypes.data,
            *vals.shape, *vol_dim, *window, order,
            torch.cuda.current_stream().cuda_stream)
    check(err, "push")
    push.launches += 1
    return out


push.launches = 0


def pull_grad(vol: torch.Tensor, M, out_dim) -> torch.Tensor:
    """Spatial derivative of the pulled image w.r.t. the sample coordinates,
    shape out_dim + (3,) (trilinear). CPU only so far: its kernel (the port
    of ``_pull_grad_shear_kernel`` / ``_pull_grad_kernel``) is ROADMAP
    queue 2, item 3."""
    if vol.device.type != "cpu":
        raise NotImplementedError(
            "pull_grad has no CUDA kernel yet (ROADMAP queue 2, item 3)")
    return pull_grad_plain(vol, M, out_dim)
