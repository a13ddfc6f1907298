"""Affine resampling: pull (gather), push (its exact adjoint), pull_grad.

Semantics of ``unires_tpu.ops.resample`` (zero bound, ``extrapolate=False``
over the FOV [-0.5, n-0.5]^3 or the caller's ``fov`` bounds, trilinear or
nearest), written twice:

* the plain PyTorch versions ``pull_plain`` / ``push_plain`` /
  ``pull_grad_plain``, tensor ops transcribed from the XLA oracles; and
* hand-written CUDA kernels (``unires_torch/csrc/resample.cu``) for pull,
  push and pull_grad, which replace the six Pallas kernels of
  ``unires_tpu/ops/pallas_resample.py`` that the card cannot run.

The public ``pull`` / ``push`` / ``pull_grad`` take the tensor's device as
the dispatch rule: a CPU tensor goes through the plain version, a CUDA tensor
through the kernel (or an error). There is no fallback from one to the other.
Each wrapper counts its kernel launches in ``pull.launches`` /
``push.launches`` / ``pull_grad.launches``, and pull and push those of the
kernels' ``fov`` instantiation also in ``pull.fov_launches`` /
``push.fov_launches``; the three form the launch group "resamples"
(``cuda_build.GROUPS``; :data:`RESAMPLES` lists them).

Batches: every wrapper also takes a leading batch axis, volumes (B, X, Y,
Z) with maps (B, 3, 4) (push: plans (B, :data:`PLAN_SIZE`)), and gives
(B, ...) outputs: the counterpart of ``vmap`` over a ``pallas_call`` (the
batched fit chunk, ``solvers.fitloop``). On the card one launch covers the
batch (one count), each output computed as the unbatched launch computes
it, so the two agree to the bit; a batch of one takes the unbatched launch.
Each volume of a batch must be C-contiguous, the stride between volumes is
free (a channel of a stacked (B, C, X, Y, Z) state, or 0 for one volume
read B times). The plain versions run a batch volume by volume.

Maps: ``M`` is the (3, 4) float32 map from output voxel to input voxel. The
kernels read it from DEVICE memory, so that a map may change between two
replays of a captured CUDA graph: a CUDA tensor is passed as it is, and a
host (numpy) map is staged through pinned memory with ``non_blocking=True``
(never inside a capture). Push reads its plan from one 32-float device
buffer (:func:`push_plan`: M, Minv, the reach and the window, computed in
float64 torch ops on the maps' device, nothing read back); ``Minv`` may be
given as that plan. The ``fov`` override of pull and push, a (3, 2) array of
per-axis bounds [lo_d, hi_d] in place of [-0.5, n_d - 0.5] (the slab
decomposition of ``parallel.spatial`` passes the global field of view in a
slab's frame), is a host array passed by value: it is fixed for a solver.

push visits, for each target, only the sources within :func:`push_reach` of
``Minv . v``. The launch counts are kept by the kernels themselves, on the
device (:class:`.cuda_build.KernelCount`), so that the launches of a graph's replays
count as the eager ones do.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_build import Counted, check, check_size, kernels
from .lie import inv33, matvec3

PLAN_SIZE = 32  # floats of a push plan: M, Minv, reach (3), window (3), pad


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


def push_reach(M, Minv, order, src_dim, tgt_dim) -> np.ndarray:
    """Per-axis reach of the push kernel's candidates: every source o that
    weighs on target v satisfies |o_d - c_d| <= reach_d, with c = Minv . v as
    the kernel computes it in float32 (3 floats, a host array).

    A weight needs |M o + m - v|_inf < h (h = 1 trilinear, 1/2 nearest), so
    |o - A^-1 (v - m)|_d <= h * R_d with R_d the L1 norm of row d of the
    inverse of M's linear part A. The margins cover float32 rounding: of the
    sample point g (relative 2^-20 of its magnitude), of the kernel's c
    against the exact inverse (the given ``Minv`` against A^-1, and 2^-20 of
    c's magnitude), and 2^-10 absolute for the kernel's own ``c -+ reach``.
    ``src_dim`` is the source grid (pull's output), ``tgt_dim`` the target
    grid (pull's input).
    """
    M64 = _as_map(M).astype(np.float64)
    A, m = M64[:, :3], M64[:, 3]
    Ainv = np.linalg.inv(A)
    exact = np.concatenate([Ainv, (-Ainv @ m)[:, None]], axis=1)
    tgt = np.asarray(tgt_dim, np.float64)
    mag_g = float((np.abs(A) @ np.asarray(src_dim, np.float64)
                   + np.abs(m)).max())
    Mi = _as_map(Minv).astype(np.float64)
    dev = np.abs(Mi - exact)
    mag_c = np.abs(Mi[:, :3]) @ tgt + np.abs(Mi[:, 3])
    h = 1.0 if order else 0.5
    reach = (h * np.abs(Ainv).sum(axis=1) * (1.0 + 2.0 ** -20 * mag_g)
             + dev[:, :3] @ tgt + dev[:, 3] + 2.0 ** -20 * mag_c + 2.0 ** -10)
    return np.ascontiguousarray(reach, np.float32)


@functools.lru_cache(maxsize=64)
def _push_plan(m: bytes, minv: bytes | None, order: int, src_dim: tuple,
               tgt_dim: tuple) -> np.ndarray:
    """The packed plan (:data:`PLAN_SIZE` floats, :func:`push_plan`'s
    layout) of a push at a host map, from the maps' bytes, on the host.
    Cached: a pose's plan is computed once however many pushes run at it.
    The array is shared: callers only read it."""
    M = np.frombuffer(m, np.float32).reshape(3, 4)
    Minv = (inverse_map(M) if minv is None
            else np.frombuffer(minv, np.float32).reshape(3, 4))
    return np.concatenate([
        M.ravel(), Minv.ravel(), push_reach(M, Minv, order, src_dim, tgt_dim),
        np.asarray(push_window(M), np.float32), np.zeros(2, np.float32)])


def _rowdot(A: torch.Tensor, v) -> torch.Tensor:
    """A (..., 3, 3) times the host 3-vector v, summed left to right."""
    return A[..., 0] * float(v[0]) + A[..., 1] * float(v[1]) \
        + A[..., 2] * float(v[2])


def push_plan(M: torch.Tensor, Minv=None, order: int = 1, src_dim=None,
              tgt_dim=None) -> torch.Tensor:
    """The plan of a push at device maps, on their device: a (...,
    :data:`PLAN_SIZE`) float32 tensor = (M, Minv, reach (3), window (3), 0,
    0) per leading index of ``M`` (..., 3, 4) float32.

    :func:`push_window` and :func:`push_reach` in float64 torch ops: the
    window from the inverse of M's float64 value, floor(1.25 L + 0.5); the
    reach with its 2^-20 and 2^-10 margins. ``Minv`` None: the float32 of
    M's float64 inverse (:func:`inverse_map`). Nothing is read back, so the
    plan can be computed inside a captured graph. ``src_dim`` is the source
    grid (pull's output), ``tgt_dim`` the target grid (pull's input).
    """
    M64 = M.to(torch.float64)
    A, m = M64[..., :3], M64[..., 3]
    Ainv = inv33(A)
    exact = torch.cat([Ainv, -matvec3(Ainv, m)[..., None]], dim=-1)
    if Minv is None:
        Minv = (exact + 0.0).to(torch.float32)  # no -0 where numpy has 0
    Mi = Minv.to(torch.float64)
    absAinv = Ainv.abs()
    window = torch.floor(absAinv.sum(dim=-1) * 1.25 + 0.5)
    mag_g = (_rowdot(A.abs(), src_dim) + m.abs()).amax(dim=-1, keepdim=True)
    dev = (Mi - exact).abs()
    mag_c = _rowdot(Mi[..., :3].abs(), tgt_dim) + Mi[..., 3].abs()
    h = 1.0 if order else 0.5
    reach = (h * absAinv.sum(dim=-1) * (1.0 + 2.0 ** -20 * mag_g)
             + _rowdot(dev[..., :3], tgt_dim) + dev[..., 3]
             + 2.0 ** -20 * mag_c + 2.0 ** -10)
    pad = torch.zeros(M.shape[:-2] + (2,), dtype=torch.float32,
                      device=M.device)
    return torch.cat([M.reshape(M.shape[:-2] + (12,)),
                      Minv.reshape(M.shape[:-2] + (12,)),
                      reach.to(torch.float32), window.to(torch.float32), pad],
                     dim=-1)


def _is_plan(Minv) -> bool:
    return isinstance(Minv, torch.Tensor) and Minv.shape[-1:] == (PLAN_SIZE,)


def _plan_parts(plan: torch.Tensor):
    """(Minv (3, 4) numpy, window) of a plan, for the plain version."""
    p = plan.detach().cpu().numpy().astype(np.float32)
    return (np.ascontiguousarray(p[12:24].reshape(3, 4)),
            tuple(int(w) for w in p[27:30]))


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


def _as_fov(fov):
    """None, or the (3, 2) float32 host bounds of a ``fov`` override."""
    if fov is None:
        return None
    if isinstance(fov, torch.Tensor):
        fov = fov.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(fov, np.float32).reshape(3, 2))


def _fov_mask(g, in_dim, fov=None):
    """extrapolate=False: g within [-0.5, n_d - 0.5], or within
    [fov[d, 0], fov[d, 1]] when the (3, 2) float32 host bounds are given
    (compared in float32, as the JAX package's ``_fov_mask``)."""
    m = None
    for d in range(3):
        if fov is None:
            lo, hi = -0.5, in_dim[d] - 0.5
        else:
            lo, hi = float(fov[d, 0]), float(fov[d, 1])
        md = (g[d] >= lo) & (g[d] <= hi)
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


def pull_plain(vol: torch.Tensor, M, out_dim, order: int = 1,
               fov=None) -> torch.Tensor:
    """Plain PyTorch pull (``unires_tpu.ops.resample._pull_gather``); a
    batch (B, X, Y, Z) at maps (B, 3, 4) volume by volume."""
    if _batched(vol):
        return _per_volume(pull_plain, vol, M, out_dim, order, fov)
    M = _as_map(M)
    out_dim = tuple(int(d) for d in out_dim)
    in_dim = tuple(vol.shape)
    g = _sample_coords(M, out_dim, vol.device)
    mask = _fov_mask(g, in_dim, _as_fov(fov)).to(vol.dtype)
    flat = vol.reshape(-1)
    out = torch.zeros(out_dim, dtype=vol.dtype, device=vol.device)
    for idx, w in _corner_data(g, in_dim, order):
        out = out + w * torch.take(flat, idx)
    return out * mask


def push_plain(vals: torch.Tensor, M, vol_dim, order: int = 1, Minv=None,
               window=None, fov=None) -> torch.Tensor:
    """Plain PyTorch push, the gather form of pull^T
    (``unires_tpu.ops.resample._push_gather``). ``Minv`` may be a
    :func:`push_plan`: its inverse map and its window are taken. A batch
    (B, X, Y, Z) takes (B, 3, 4) maps and (B, ...) ``Minv``, volume by
    volume."""
    if _batched(vals):
        return torch.stack([push_plain(
            vals[b], M[b], vol_dim, order, None if Minv is None else Minv[b],
            window, fov) for b in range(len(vals))])
    M = _as_map(M)
    if _is_plan(Minv):
        Minv, plan_window = _plan_parts(Minv)
        window = plan_window if window is None else window
    Minv = inverse_map(M) if Minv is None else _as_map(Minv)
    window = push_window(M) if window is None else _check_window(window)
    fov = _as_fov(fov)
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
                fovm = _fov_mask(g, vol_dim, fov)
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
    (``unires_tpu.ops.resample._pull_grad_gather``); a batch as
    :func:`pull_plain`'s."""
    if _batched(vol):
        return _per_volume(pull_grad_plain, vol, M, out_dim)
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
    """True for a CPU tensor; checks a CUDA tensor for the kernel (a volume,
    or a batch of volumes each C-contiguous, the batch's stride free);
    raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if t.dim() not in (3, 4):
        raise ValueError(f"{name}: expected a 3D volume or a batch of them, "
                         f"got {tuple(t.shape)}")
    if not t[(0,) * (t.dim() - 3)].is_contiguous():
        raise ValueError(f"{name}: the kernel needs contiguous volumes")
    return False


def _batched(t: torch.Tensor) -> bool:
    """A batch (B, X, Y, Z) of volumes rather than one (X, Y, Z)."""
    return t.dim() == 4


def _per_volume(fn, t: torch.Tensor, M, *args, **kw) -> torch.Tensor:
    """A plain version over a batch: ``fn`` of each volume at its map,
    stacked."""
    return torch.stack([fn(t[b], M[b], *args, **kw) for b in range(len(t))])


def _check_order(order: int) -> int:
    if order not in (0, 1):
        raise ValueError(f"interpolation order {order} (use 0 or 1)")
    return int(order)


def _check_window(window) -> tuple:
    window = tuple(int(w) for w in window)
    if len(window) != 3 or min(window) < 0:
        raise ValueError(f"push window {window} (three half-widths >= 0)")
    return window


def _fov_ptr(fov):
    # null: the kernel's default bounds [-0.5, n - 0.5]
    return None if fov is None else fov.ctypes.data


def _stage(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` through pinned memory, without waiting."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a host map cannot enter a captured graph: pass "
                           "the map as a device tensor")
    return torch.from_numpy(np.ascontiguousarray(host)).pin_memory().to(
        device, non_blocking=True)


def _device_buffer(t, numel: int, device: torch.device, name: str):
    """``t`` as the kernel reads it: float32, contiguous, 16-byte aligned,
    ``numel`` values on ``device``; else raises."""
    if (t.device != device or t.dtype != torch.float32
            or t.numel() != numel or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: a device map must be a contiguous, "
                         f"16-byte aligned float32 tensor of {numel} values "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t


def _device_map(M, device: torch.device, name: str,
                batch: int = 0) -> torch.Tensor:
    """The (3, 4) map, or the (batch, 3, 4) maps of a batch, in device
    memory: a CUDA tensor as it is, host maps staged."""
    if isinstance(M, torch.Tensor) and M.device.type == "cuda":
        return _device_buffer(M, 12 * max(batch, 1), device, name)
    if batch:
        return _stage(np.stack([_as_map(M[b]) for b in range(batch)]),
                      device)
    return _stage(_as_map(M), device)


def pull(vol: torch.Tensor, M, out_dim, order: int = 1,
         fov=None) -> torch.Tensor:
    """Sample ``vol`` at g = M @ (i,j,k,1) for every output voxel.

    Zero bound, no extrapolation; ``order`` 0 (nearest) or 1 (trilinear).
    ``M`` is the (3, 4) map from output voxel to input voxel (a host array,
    or a tensor on the volume's device). ``fov`` (3, 2), optional, overrides
    the no-extrapolation bounds.
    """
    order = _check_order(order)
    out_dim = tuple(int(d) for d in out_dim)
    if _on_cpu(vol, "pull"):
        return pull_plain(vol, M, out_dim, order, fov)
    B = len(vol) if _batched(vol) else 0
    Md = _device_map(M, vol.device, "pull", B)
    fov = _as_fov(fov)
    check_size(vol.shape[-3:], out_dim)
    out = torch.empty(vol.shape[:-3] + out_dim, dtype=torch.float32,
                      device=vol.device)
    lib = kernels.get()
    with torch.cuda.device(vol.device):
        args = (vol.data_ptr(), out.data_ptr(), Md.data_ptr(), _fov_ptr(fov),
                *vol.shape[-3:], *out_dim, order)
        tail = (pull.count.ptr(vol.device),
                torch.cuda.current_stream().cuda_stream)
        if B > 1:
            err = lib.unires_pull_batch(*args, B, vol.stride(0), *tail)
        else:
            err = lib.unires_pull(*args, *tail)
    check(err, "pull")
    return out


pull = Counted(pull, group="resamples")


def push(vals: torch.Tensor, M, vol_dim, order: int = 1, Minv=None,
         window=None, fov=None) -> torch.Tensor:
    """Exact adjoint of :func:`pull` (gather form, no atomics).

    ``M`` is the SAME (3, 4) map given to pull (source voxel -> target
    voxel), and ``fov`` the same bounds. ``Minv`` is its inverse, or the
    maps' :func:`push_plan`; when not given it is derived from ``M`` (in
    float64). The candidate window is :func:`push_window`'s unless
    ``window`` names its three half-widths (a window smaller than the
    footprint drops mass, as the JAX package's). On the card the kernel
    reads M, Minv, the reach and the window from the plan: given, computed
    on the device for device maps (:func:`push_plan`), or on the host for
    host maps (cached per map, :func:`_push_plan`) and staged.
    """
    order = _check_order(order)
    vol_dim = tuple(int(d) for d in vol_dim)
    if _on_cpu(vals, "push"):
        return push_plain(vals, M, vol_dim, order, Minv, window, fov)
    dev = vals.device
    B = len(vals) if _batched(vals) else 0
    n = max(B, 1)
    src_dim = tuple(vals.shape[-3:])
    if _is_plan(Minv):
        plan = _device_buffer(Minv, PLAN_SIZE * n, dev, "push")
    elif isinstance(M, torch.Tensor) and M.device.type == "cuda":
        plan = push_plan(_device_buffer(M, 12 * n, dev, "push"),
                         None if Minv is None
                         else _device_map(Minv, dev, "push", B),
                         order, src_dim, vol_dim)
    else:
        def host_plan(m, mi):
            return _push_plan(_as_map(m).tobytes(), None if mi is None
                              else _as_map(mi).tobytes(), order, src_dim,
                              vol_dim)

        plan = _stage(np.stack([host_plan(
            M[b], None if Minv is None else Minv[b]) for b in range(B)])
            if B else host_plan(M, Minv), dev)
    window = (-1, -1, -1) if window is None else _check_window(window)
    fov = _as_fov(fov)
    check_size(src_dim, vol_dim)
    out = torch.empty(vals.shape[:-3] + vol_dim, dtype=torch.float32,
                      device=dev)
    lib = kernels.get()
    with torch.cuda.device(dev):
        args = (vals.data_ptr(), out.data_ptr(), plan.data_ptr(),
                _fov_ptr(fov), *src_dim, *vol_dim, *window, order)
        tail = (push.count.ptr(dev), torch.cuda.current_stream().cuda_stream)
        if B > 1:
            err = lib.unires_push_batch(*args, B, vals.stride(0), *tail)
        else:
            err = lib.unires_push(*args, *tail)
    check(err, "push")
    return out


push = Counted(push, group="resamples")


def pull_grad(vol: torch.Tensor, M, out_dim) -> torch.Tensor:
    """Spatial derivative of the pulled image w.r.t. the sample coordinates,
    shape out_dim + (3,) in C order (trilinear, zero bound, 0 outside the
    FOV). ``M`` is the (3, 4) map given to :func:`pull`."""
    out_dim = tuple(int(d) for d in out_dim)
    if _on_cpu(vol, "pull_grad"):
        return pull_grad_plain(vol, M, out_dim)
    B = len(vol) if _batched(vol) else 0
    Md = _device_map(M, vol.device, "pull_grad", B)
    check_size(vol.shape[-3:], out_dim + (3,))
    out = torch.empty(vol.shape[:-3] + out_dim + (3,), dtype=torch.float32,
                      device=vol.device)
    lib = kernels.get()
    with torch.cuda.device(vol.device):
        args = (vol.data_ptr(), out.data_ptr(), Md.data_ptr(),
                *vol.shape[-3:], *out_dim)
        tail = (pull_grad.count.ptr(vol.device),
                torch.cuda.current_stream().cuda_stream)
        if B > 1:
            err = lib.unires_pull_grad_batch(*args, B, vol.stride(0), *tail)
        else:
            err = lib.unires_pull_grad(*args, *tail)
    check(err, "pull_grad")
    return out


pull_grad = Counted(pull_grad, group="resamples")
RESAMPLES = (pull, push, pull_grad)
