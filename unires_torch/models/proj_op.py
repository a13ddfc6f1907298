"""Projection-operator geometry: the frozen ``ProjOp`` and ``proj_info``.

A numpy copy of ``unires_tpu.models.proj_op``.

Faithful re-derivation of the reference ``_proj_info`` (unires/_project.py:
193-297): all geometry (dims, decimation ratios, slice-profile kernels,
intermediate 'yx' space) is computed ONCE on host in float64 numpy so every
device computation downstream has static shapes.

The only *dynamic* pieces of an operator during fitting are the rigid
transform (updated by Gauss-Newton, unires/_update.py:198-267) and the
even/odd scaling scalar (unires/_update.py:270-393); they enter each
operator call as small host operands (a (3,4) affine and a scalar).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..geometry import voxel_size
from ..kernels import smooth_kernel


@dataclasses.dataclass
class ProjOp:
    """Static geometry of one observation's projection operator A.

    Mirrors the reference ``_proj_op`` struct (unires/struct.py:36-54).
    """

    dim_x: Tuple[int, int, int]
    mat_x: np.ndarray  # (4,4) f64
    vx_x: np.ndarray  # (3,) f64
    dim_y: Tuple[int, int, int]
    mat_y: np.ndarray
    vx_y: np.ndarray
    dim_yx: Tuple[int, int, int]
    mat_yx: np.ndarray
    ratio: Tuple[int, int, int]
    smo_ker: np.ndarray  # (kx,ky,kz) f32 (full ND kernel, = outer(smo_ker_1d))
    smo_ker_1d: Tuple[np.ndarray, ...]  # per-axis 1D factors (f32)
    dim_thick: int
    rigid: np.ndarray  # (4,4) f64 — dynamic during fit
    scl: float = 0.0  # even/odd scaling — dynamic during fit
    D_x: Optional[np.ndarray] = None  # sub-sampling modulations (samp>0)
    D_y: Optional[np.ndarray] = None

    # --- derived device-facing helpers -----------------------------------

    def M_sr(self, rigid: Optional[np.ndarray] = None) -> np.ndarray:
        """(3,4) map: yx-grid voxel -> y voxel (super-resolution path).

        mat = mat_y \\ rigid @ mat_yx  (reference unires/_project.py:147).
        """
        R = self.rigid if rigid is None else rigid
        M = np.linalg.solve(self.mat_y, R @ self.mat_yx)
        return M[:3, :4].astype(np.float32)

    def M_den(self, rigid: Optional[np.ndarray] = None) -> np.ndarray:
        """(3,4) map: x-grid voxel -> y voxel (denoising path).

        mat = mat_y \\ rigid @ mat_x  (reference unires/_project.py:150).
        """
        R = self.rigid if rigid is None else rigid
        M = np.linalg.solve(self.mat_y, R @ self.mat_x)
        return M[:3, :4].astype(np.float32)


def _lift_mat_2d(m: np.ndarray) -> np.ndarray:
    """Embed a 2D affine ((3,3), or an already-(4,4) plane transform) into a
    4x4 3D affine acting trivially on the degenerate z axis."""
    m = np.asarray(m, np.float64)
    if m.shape == (4, 4):
        return m
    if m.shape != (3, 3):
        raise ValueError(f"2D affine must be (3,3) or (4,4), got {m.shape}")
    out = np.eye(4)
    out[:2, :2] = m[:2, :2]
    out[:2, 3] = m[:2, 2]
    return out


def proj_info(
    dim_y,
    mat_y,
    dim_x,
    mat_x,
    rigid: Optional[np.ndarray] = None,
    prof_ip: int = 0,
    prof_tp: int = 0,
    gap: float = 0.0,
    scl: float = 0.0,
    samp: int = 0,
) -> ProjOp:
    """Build the projection operator geometry (reference _proj_info).

    Args mirror unires/_project.py:193-297; all matrices are host float64.
    """
    mat_y = np.asarray(mat_y, dtype=np.float64)
    mat_x = np.asarray(mat_x, dtype=np.float64)
    dim_y = np.asarray(dim_y, dtype=np.float64).ravel()
    dim_x = np.asarray(dim_x, dtype=np.float64).ravel()
    if dim_y.size == 2:
        # 2D operator path (reference _proj_apply's conv2d branches,
        # unires/_project.py:156-157): lift to degenerate-Z 3D — dirac
        # profile and ratio 1 on the singleton axis make the 3D chain
        # EXACTLY the 2D operator on (X, Y, 1) volumes. Callers apply it
        # via proj_apply(dat[..., None], ...).
        dim_y = np.concatenate([dim_y, [1.0]])
        dim_x = np.concatenate([dim_x, [1.0]])
        mat_y = _lift_mat_2d(mat_y)
        mat_x = _lift_mat_2d(mat_x)
        if rigid is not None:
            rigid = _lift_mat_2d(np.asarray(rigid, np.float64))
    ndim = dim_y.size
    vx_y = voxel_size(mat_y)
    vx_x = voxel_size(mat_x)
    if rigid is None:
        rigid = np.eye(ndim + 1, dtype=np.float64)
    else:
        rigid = np.asarray(rigid, dtype=np.float64)

    # Slice profile per axis: in-plane everywhere, through-plane on the thick
    # axis (thick = largest input voxel size; reference :239-244).
    gap_cn = np.zeros(ndim)
    profile = np.full(ndim, prof_ip, dtype=np.int64)
    dim_thick = int(np.argmax(vx_x))
    gap_cn[dim_thick] = gap
    profile[dim_thick] = prof_tp

    D_x = None
    D_y = None
    if samp > 0:
        # Sub-sampled geometry for fast registration (reference :245-264).
        one = np.ones(ndim)
        sk = np.maximum(one, np.floor(samp * one / vx_x + 0.5))
        D_x = np.diag(np.concatenate([sk, [1.0]]))
        mat_x = mat_x @ D_x
        dim_x = np.floor(np.linalg.inv(D_x)[:ndim, :ndim] @ dim_x)
        # NOTE: the reference's high-res modulation branch is dead code — its
        # guard compares vx_x with itself (unires/_project.py:255), so D_y is
        # never set. We mirror the shipped behaviour (D_y stays None).
        vx_x = voxel_size(mat_x)

    # Intermediate 'yx' space: integer decimation ratio (reference :266-271).
    # The 1e-4 guard keeps rotation-induced float noise (column norms are
    # rotation-invariant, so e.g. 1+1e-9 is really 1) from bumping the ceil
    # to the next integer, which would double dim_yx for nothing.
    ratio = np.linalg.solve(mat_y, mat_x)
    ratio = np.sqrt((ratio[:ndim, :ndim] ** 2).sum(axis=0))
    ratio = np.maximum(np.ceil(ratio - 1e-4), 1.0)
    mat_ratio = np.diag(np.concatenate([ratio, [1.0]]))
    mat_yx = mat_x @ np.linalg.inv(mat_ratio)
    dim_yx = (dim_x - 1.0) * ratio + 1.0

    # Axes that are not decimated use a dirac profile (reference :273).
    profile = np.where(ratio == 1.0, -1, profile)

    # Slice-profile kernel (reference :276-278). The ND kernel is the outer
    # product of per-axis 1D kernels; the factors drive the polyphase blur.
    fwhm = (1.0 - gap_cn) * ratio
    smo_ker = smooth_kernel(profile, fwhm, dtype=np.float32)
    from ..kernels import kernel_1d

    smo_ker_1d = tuple(kernel_1d(int(profile[d]), float(fwhm[d])).astype(np.float32)
                       for d in range(ndim))

    # Pad the intermediate space by the kernel support so the VALID strided
    # conv lands exactly on dim_x (reference :279-285).
    ksz = np.asarray(smo_ker.shape[-ndim:], dtype=np.float64)
    off = np.floor(-(ksz - 1.0) / 2.0)
    mat_off = np.eye(ndim + 1)
    mat_off[:ndim, -1] = off
    dim_yx = dim_yx + 2.0 * np.abs(off)
    mat_yx = mat_yx @ mat_off

    return ProjOp(
        dim_x=tuple(int(v) for v in dim_x),
        mat_x=mat_x,
        vx_x=vx_x,
        dim_y=tuple(int(v) for v in dim_y),
        mat_y=mat_y,
        vx_y=vx_y,
        dim_yx=tuple(int(v) for v in dim_yx),
        mat_yx=mat_yx,
        ratio=tuple(int(v) for v in ratio),
        smo_ker=smo_ker,
        smo_ker_1d=smo_ker_1d,
        dim_thick=dim_thick,
        rigid=rigid,
        scl=float(scl),
        D_x=D_x,
        D_y=D_y,
    )
