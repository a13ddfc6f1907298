"""Slice-profile blur + integer decimation (and its exact adjoint).

The polyphase separable formulation of ``unires_tpu.ops.conv``
(``blur_down_sep`` / ``blur_up_sep``): the slice-profile kernel is an outer
product of short per-axis 1D kernels, so the strided blur is K strided slices
and weighted adds per axis, in float32. It is deliberately not ``conv3d``:
cuDNN runs float32 convolutions in TF32 by default, which keeps about three
decimal digits.

Semantics (pinned by the reference, unires/_project.py:153-157):
  * ``blur_down_sep``: VALID cross-correlation at integer stride ``ratio``.
  * ``blur_up_sep``: its exact adjoint (zero-stuff by ``ratio``, then full
    correlation with the kernel).
``blur_down`` / ``blur_up`` take the dense (non-separable) kernel instead,
one strided slice per kernel tap, for 2D or 3D volumes.

Two implementations of the separable pair. The plain one
(``blur_down_plain`` / ``blur_up_plain``: ``_down_1d`` / ``_up_1d`` axis by
axis) is what a CPU tensor takes. A
CUDA tensor takes one hand-written launch per pass instead
(``unires_torch/csrc/blur.cu``; the up pass gathers, with no zero-stuffed or
padded intermediate), which reads its input once and writes its output once
and rounds as the plain chain on the card does, so the two agree to the bit.
A pass whose kernel is a single tap of 1 at ratio 1 (a dirac axis) launches
nothing and returns its input. The kernels take float32 volumes, each
C-contiguous, with any stride between the volumes of a batch; for any other
CUDA tensor the functions raise (TypeError for the dtype, ValueError for
the layout, or a down pass along an axis shorter than its taps), as the
other kernel wrappers do. Each counts its passes'
launches on the device (``blur_down_sep.launches``,
``blur_up_sep.launches``), both in the launch group "blurs"
(``cuda_build.GROUPS``; :data:`BLURS` lists them).
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Counted, check, check_size, kernels, volume_batch

MAX_TAPS = 64  # the most taps a pass of csrc/blur.cu takes (kMaxTaps)


def _axis_slice(ndim: int, axis: int, sl: slice):
    out = [slice(None)] * ndim
    out[axis] = sl
    return tuple(out)


def _down_1d(dat: torch.Tensor, k: np.ndarray, r: int, axis: int) -> torch.Tensor:
    """out[i] = sum_t k[t] * dat[r*i + t] (VALID strided correlation)."""
    K = k.shape[0]
    if K == 1 and r == 1:
        return dat * float(k[0])
    n = dat.shape[axis]
    n_out = (n - K) // r + 1
    out = None
    for t in range(K):
        sl = _axis_slice(dat.dim(), axis, slice(t, t + (n_out - 1) * r + 1, r))
        term = float(k[t]) * dat[sl]
        out = term if out is None else out + term
    return out


def _pad_axis(dat: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    shape = list(dat.shape)
    parts = []
    if lo:
        shape[axis] = lo
        parts.append(dat.new_zeros(shape))
    parts.append(dat)
    if hi:
        shape[axis] = hi
        parts.append(dat.new_zeros(shape))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else dat


def _up_1d(dat: torch.Tensor, k: np.ndarray, r: int, axis: int) -> torch.Tensor:
    """Exact adjoint of :func:`_down_1d`: out[r*i + t] += k[t] * dat[i]."""
    K = k.shape[0]
    if K == 1 and r == 1:
        return dat * float(k[0])
    n = dat.shape[axis]
    n_out = (n - 1) * r + K
    if r > 1:  # dilate by r along axis: interleave with zeros
        dil = torch.stack([dat] + [torch.zeros_like(dat)] * (r - 1),
                          dim=axis + 1)
        shape = list(dat.shape)
        shape[axis] = n * r
        dil = dil.reshape(shape)
        dil = dil[_axis_slice(dat.dim(), axis, slice(0, (n - 1) * r + 1))]
    else:
        dil = dat
    # full correlation with the kernel: out[j] = sum_t k[t] * dil[j - t]
    dp = _pad_axis(dil, axis, K - 1, K - 1)
    out = None
    for t in range(K):
        sl = _axis_slice(dat.dim(), axis, slice(K - 1 - t, K - 1 - t + n_out))
        term = float(k[t]) * dp[sl]
        out = term if out is None else out + term
    return out


def _plain_sep(dat, kers_1d, ratio, one_d):
    lead = dat.dim() - 3
    for axis, (k, r) in enumerate(zip(kers_1d, ratio)):
        dat = one_d(dat, np.asarray(k), int(r), lead + axis)
    return dat


def blur_down_plain(dat: torch.Tensor, kers_1d, ratio) -> torch.Tensor:
    """:func:`blur_down_sep` as the plain per-axis chain, on any device."""
    return _plain_sep(dat, kers_1d, ratio, _down_1d)


def blur_up_plain(dat: torch.Tensor, kers_1d, ratio) -> torch.Tensor:
    """:func:`blur_up_sep` as the plain per-axis chain, on any device."""
    return _plain_sep(dat, kers_1d, ratio, _up_1d)


def _kernel_sep(fn, entry: str, v: torch.Tensor, kers_1d, ratio,
                up: bool) -> torch.Tensor:
    """The passes of ``entry`` over the batch ``v`` (B, X, Y, Z), axis by
    axis, each one launch counted in ``fn``'s launches (none for a dirac
    axis)."""
    lib = kernels.get()
    dev = v.device
    for axis, (k, r) in enumerate(zip(kers_1d, ratio)):
        k = np.ascontiguousarray(k, dtype=np.float32).reshape(-1)
        K, r = k.shape[0], int(r)
        if K == 1 and r == 1 and k[0] == 1.0:
            continue
        if K > MAX_TAPS:
            raise ValueError(f"{entry}: {K} taps, the kernel takes at most "
                             f"{MAX_TAPS}")
        dim = tuple(v.shape[1:])
        n = dim[axis]
        if not up and n < K:
            raise ValueError(f"{entry}: axis {axis} has {n} voxels, fewer "
                             f"than the {K} taps of a VALID pass")
        m = (n - 1) * r + K if up else (n - K) // r + 1
        out_dim = dim[:axis] + (m,) + dim[axis + 1:]
        out = torch.empty((v.shape[0],) + out_dim, dtype=torch.float32,
                          device=dev)
        check_size(dim, out_dim)
        with torch.cuda.device(dev):
            err = getattr(lib, entry)(
                v.data_ptr(), out.data_ptr(), int(np.prod(dim[:axis])), n,
                int(np.prod(dim[axis + 1:])), r, k.ctypes.data, K,
                v.shape[0], v.stride(0), fn.count.ptr(dev),
                torch.cuda.current_stream().cuda_stream)
        check(err, entry)
        v = out
    return v


def blur_down_sep(dat: torch.Tensor, kers_1d, ratio) -> torch.Tensor:
    """Separable strided blur: per-axis polyphase passes over the last three
    axes (leading axes, a batch of volumes, ride along)."""
    v = volume_batch(dat, 3, "blur_down_sep")
    if v is None:
        return blur_down_plain(dat, kers_1d, ratio)
    out = _kernel_sep(blur_down_sep, "unires_blur_down", v, kers_1d, ratio,
                      up=False)
    return dat if out is v else out.view(dat.shape[:-3] + out.shape[1:])


def blur_up_sep(dat: torch.Tensor, kers_1d, ratio) -> torch.Tensor:
    """Exact adjoint of :func:`blur_down_sep`."""
    v = volume_batch(dat, 3, "blur_up_sep")
    if v is None:
        return blur_up_plain(dat, kers_1d, ratio)
    out = _kernel_sep(blur_up_sep, "unires_blur_up", v, kers_1d, ratio,
                      up=True)
    return dat if out is v else out.view(dat.shape[:-3] + out.shape[1:])


def _tap_slices(ker_shape, ratio, n_out):
    """(tap, slices) for every tap t of a dense kernel: the input positions
    r * i + t of the output i = 0 .. n_out - 1 on every axis."""
    for t in np.ndindex(*ker_shape):
        yield t, tuple(slice(a, a + (n - 1) * r + 1, r)
                       for a, r, n in zip(t, ratio, n_out))


def blur_down(dat: torch.Tensor, ker, ratio) -> torch.Tensor:
    """VALID strided correlation of a bare 2D / 3D volume with a dense
    kernel of the same rank: out[i] = sum_t ker[t] * dat[ratio * i + t]."""
    ker = np.asarray(ker, np.float32)
    ratio = tuple(int(r) for r in ratio)
    n_out = tuple((n - k) // r + 1
                  for n, k, r in zip(dat.shape, ker.shape, ratio))
    out = None
    for t, sl in _tap_slices(ker.shape, ratio, n_out):
        term = float(ker[t]) * dat[sl]
        out = term if out is None else out + term
    return out


def blur_up(dat: torch.Tensor, ker, ratio) -> torch.Tensor:
    """Exact adjoint of :func:`blur_down`: out[ratio * i + t] +=
    ker[t] * dat[i], on a grid of (n - 1) * ratio + k voxels per axis."""
    ker = np.asarray(ker, np.float32)
    ratio = tuple(int(r) for r in ratio)
    dim_in = tuple((n - 1) * r + k
                   for n, k, r in zip(dat.shape, ker.shape, ratio))
    out = dat.new_zeros(dim_in)
    for t, sl in _tap_slices(ker.shape, ratio, tuple(dat.shape)):
        out[sl] += float(ker[t]) * dat
    return out


blur_down_sep = Counted(blur_down_sep, group="blurs")
blur_up_sep = Counted(blur_up_sep, group="blurs")
BLURS = (blur_down_sep, blur_up_sep)
