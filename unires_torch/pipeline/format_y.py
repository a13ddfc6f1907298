"""Output-space formatting: method selection, mean space, lambda init.

Mirrors the reference ``_format_y``/``_all_mat_dim_vx``/``_proj_info_add``/
``_init_y_dat`` (unires/_core.py:27-50, 171-285, 371-454), as
``unires_tpu.pipeline.format_y`` does. Labels (``_init_y_label``) are not
ported yet (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..geometry import (affine_diag, affine_matrix_classic, bb_atlas,
                        ceil_pow, expm, mean_space, voxel_size)
from ..models.proj_op import proj_info
from ..ops.resample import affine_to_M, pull
from ..utils.log import info
from .structs import Chan, XData, YData


def all_mat_dim_vx(x: XData):
    mats, dims, vxs = [], [], []
    for xc in x:
        for o in xc:
            mats.append(np.asarray(o.mat, np.float64))
            dims.append(np.asarray(o.dim, np.float64))
            vxs.append(voxel_size(o.mat))
    return np.stack(mats), np.stack(dims), np.stack(vxs)


def format_y(x: XData, sett):
    """Build output channel structs; decide method (reference :171-285)."""
    vx_y = sett.vx
    if vx_y == 0:
        vx_y = None
    if vx_y is not None:
        if isinstance(vx_y, (int, float)):
            vx_y = (float(vx_y),) * 3
        vx_y = np.asarray(vx_y, np.float64)

    all_mat, all_dim, all_vx = all_mat_dim_vx(x)
    N = all_mat.shape[0]

    if N == 1:
        sett.unified_rigid = False
        sett.clean_fov = True

    def _req(a, b):
        return np.array_equal(np.round(a, 3), np.round(b, 3))

    mat_same = all(_req(all_mat[n - 1], all_mat[n]) for n in range(1, N))
    dim_same = all(_req(all_dim[n - 1], all_dim[n]) for n in range(1, N))
    vx_same = all(_req(all_vx[n - 1], all_vx[n]) for n in range(1, N))

    do_sr = True
    sett.do_proj = True
    if vx_y is None and (N == 1 or vx_same):
        vx_y = all_vx[0]

    do_pow = (isinstance(sett.pow, (tuple, list)) and len(sett.pow) == 3) or (
        isinstance(sett.pow, int) and sett.pow > 0)

    mat = all_mat[0]
    dim = all_dim[0]
    if vx_same and (np.abs(all_vx[0] - vx_y) < 1e-3).all():
        do_sr = False
        if mat_same and dim_same and not sett.unified_rigid and not sett.crop \
                and not do_pow:
            sett.do_proj = False

    if do_sr or sett.do_proj:
        mat, dim, vx_y = mean_space(all_mat, all_dim, vx_y)
        dim = dim.astype(np.float64)

        if sett.crop:
            # crop output FOV to the atlas box (reference :230-239)
            vx_y = voxel_size(mat)
            mat_mu, dim = bb_atlas(fov=sett.fov)
            mat_vx = affine_diag(vx_y)
            mat = mat_mu @ mat_vx
            dim = np.floor(np.linalg.inv(mat_vx[:3, :3]) @ dim.reshape(3, 1)).ravel()

        if do_pow:
            if isinstance(sett.pow, int):
                dim2 = ceil_pow(dim, p=2.0, l=2.0, mx=sett.pow)
                dim3 = ceil_pow(dim, p=2.0, l=3.0, mx=sett.pow)
                ndim = np.minimum(dim2, dim3)
            else:
                ndim = np.asarray(sett.pow, np.float64)
            mat_bb = affine_matrix_classic(-np.round((ndim - dim) / 2.0))
            mat = mat @ mat_bb
            dim = ndim

    if getattr(sett, "force_y_space", None) is not None:
        # explicit output space (batch mode: every subject reconstructs on
        # subject 0's grid so the batch is geometry-homogeneous; the
        # reference's cross-subject analog is common_output via the atlas)
        mat, dim = sett.force_y_space
        mat = np.asarray(mat, np.float64)
        dim = np.asarray(dim, np.float64)

    sett.method = "super-resolution" if do_sr else "denoising"

    # disable even/odd scaling when it cannot be estimated (reference :262-264)
    if sett.method == "denoising" or (N == 1 and x[0][0].ct):
        sett.scaling = False

    dim = tuple(int(d) for d in dim)
    info(sett, "mean-space", dim, mat)

    y: YData = []
    for c in range(len(x)):
        ch = Chan()
        mu_c = []
        for o in x[c]:
            mu = o.mu
            if o.ct and sett.method == "super-resolution":
                mu = mu / 4.0
            mu_c.append(mu)
        ch.lam0 = math.sqrt(1.0 / len(x)) / float(np.mean(mu_c))
        ch.lam = ch.lam0
        ch.dim = dim
        ch.mat = np.asarray(mat, np.float64)
        y.append(ch)
    return y, sett


def proj_info_add(x: XData, y: YData, sett):
    """Build each observation's projection operator (reference :439-454)."""
    for c in range(len(x)):
        for o in x[c]:
            rigid = expm(o.rigid_q, sett.rigid_basis) \
                if o.rigid_q is not None and sett.rigid_basis is not None \
                else np.eye(4)
            o.po = proj_info(y[c].dim, y[c].mat, o.dim, o.mat,
                             rigid=rigid, prof_ip=sett.profile_ip,
                             prof_tp=sett.profile_tp, gap=sett.gap,
                             scl=0.0)
    return x


def init_y_dat(x: XData, y: YData, sett):
    """Initial y: clamped average of linearly resliced repeats (ref :371-399).

    Every reslice goes through ``ops.resample.pull`` (the pull kernel on the
    card); the JAX package's separable matmul special case has no
    counterpart here.
    """
    dim_y = tuple(int(d) for d in y[0].dim)
    mat_y = y[0].mat
    for c in range(len(x)):
        dev = x[c][0].dat.device
        dat_y = torch.zeros(dim_y, dtype=torch.float32, device=dev)
        sm = torch.zeros(dim_y, dtype=torch.float32, device=dev)
        for o in x[c]:
            Mv = np.linalg.solve(np.asarray(o.mat, np.float64), mat_y)
            dat = pull(o.dat, affine_to_M(Mv), dim_y, order=1)
            dat = torch.clamp(dat, torch.min(o.dat), torch.max(o.dat))
            sm = sm + (dat > 0)
            dat_y = dat_y + dat
        sm = torch.where(sm == 0, 1.0, sm)
        y[c].dat = dat_y / sm
    return y
