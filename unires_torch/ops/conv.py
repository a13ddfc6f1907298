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
"""
from __future__ import annotations

import numpy as np
import torch


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


def blur_down_sep(dat: torch.Tensor, kers_1d, ratio) -> torch.Tensor:
    """Separable strided blur: per-axis polyphase passes."""
    for axis, (k, r) in enumerate(zip(kers_1d, ratio)):
        dat = _down_1d(dat, np.asarray(k), int(r), axis)
    return dat


def blur_up_sep(dat: torch.Tensor, kers_1d, ratio) -> torch.Tensor:
    """Exact adjoint of :func:`blur_down_sep`."""
    for axis, (k, r) in enumerate(zip(kers_1d, ratio)):
        dat = _up_1d(dat, np.asarray(k), int(r), axis)
    return dat
