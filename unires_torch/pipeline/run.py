"""Pipeline entry points: init / fit / preproc (reference unires/run.py) and
their batch-of-subjects forms, fit_batch / preproc_batch.

Data flow as ``unires_tpu.pipeline.run``: read NIfTI (host) -> volumes on
``Settings.device`` -> hyper-parameter estimation -> registration init ->
output-space formatting -> projection operators -> initial y -> ADMM fit ->
write NIfTI.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..geometry import affine_basis, voxel_size
from ..ops.resample import affine_to_M, pull
from ..settings import Settings
from ..utils import trace
from ..utils.log import info
from .fit import fit as _fit
from .format_y import (format_y, init_y_dat, init_y_label, proj_info_add,
                       warp_label)
from .hyperpar import estimate_hyperpar
from .nifti import load as nifti_load, save as nifti_save
from .registration import affine_align, atlas_align, reset_origin
from .structs import Obs, XData, YData


def get_device(sett) -> torch.device:
    """The torch device of ``Settings.device``; raises when it is a CUDA
    device and there is no CUDA (the port never falls back to the CPU).

    On a card it also pins float32 products to full float32, once, before
    the pipeline's first product there (coreg's histogram matmuls in
    ``init``, the DCT preconditioner in ``fit``), as the JAX package's
    Precision.HIGHEST: no TF32 in cuBLAS, nor in cuDNN (the port runs no
    convolution through cuDNN, but a user's process might).
    """
    dev = torch.device(sett.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"Settings.device={sett.device!r} but CUDA is not available "
                "(pass device='cpu' to run the plain PyTorch path)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return dev


def _read_image(item, device, is_ct: bool = False) -> Obs:
    """One observation from a path or an [array, affine] pair
    (reference _util.py:134-197)."""
    o = Obs()
    if isinstance(item, str):
        dat, hdr = nifti_load(item)
        dat = np.squeeze(dat)
        o.mat = np.asarray(hdr.affine, np.float64)
        o.fname = os.path.abspath(item)
        o.direc, o.nam = os.path.split(o.fname)
        o.header = hdr
    else:
        dat, mat = item
        dat = np.squeeze(np.asarray(dat, np.float32))
        o.mat = np.asarray(mat, np.float64)
    # a C-ordered copy: inputs may be read-only buffers, or Fortran-ordered
    # as a NIfTI loader can hand them, and the kernels take C order
    dat = np.array(dat, np.float32, order="C")
    dat[~np.isfinite(dat)] = 0.0
    if dat.ndim != 3:
        raise ValueError(
            f"Input image dimension required to be 3D, received {dat.ndim}D!")
    o.dat = torch.from_numpy(dat).to(device)
    o.dim = tuple(dat.shape)
    o.ct = bool(is_ct)
    return o


def read_data(data, sett) -> XData:
    """Parse nested path/array input into x[c][n] (reference _core.py:495-584)."""
    device = get_device(sett)
    mat_vol = sett.mat
    if isinstance(data, str):
        dat, hdr = nifti_load(data)
        if dat.ndim > 3:
            mat_vol = hdr.affine
            data = dat
    if hasattr(data, "shape") and mat_vol is None and not isinstance(data, str):
        raise ValueError("Image data given as array, please also provide "
                         "affine matrix in sett.mat!")
    if isinstance(data, str):
        data = [data]

    x: XData = []
    if mat_vol is not None:
        arr = np.asarray(data)
        if arr.ndim == 3:
            arr = arr[..., None]
        for c in range(arr.shape[3]):
            x.append([_read_image([arr[..., c], mat_vol], device,
                                  is_ct=sett.ct)])
    else:
        for c, item in enumerate(data):
            x.append([])
            if isinstance(item, list) and item and isinstance(item[0], (str, list)):
                for sub in item:
                    x[c].append(_read_image(sub, device, is_ct=sett.ct))
            else:
                x[c].append(_read_image(item, device, is_ct=sett.ct))

    if sett.label is not None:
        pth, (ci, ni) = sett.label
        dat, hdr = nifti_load(pth)
        if tuple(dat.shape) != tuple(x[ci][ni].dim):
            raise ValueError("Incorrect label dimensions.")
        x[ci][ni].label = [torch.from_numpy(dat).to(device), hdr]

    info(sett, "filenames", x)
    return x


def init_reg(x: XData, sett):
    """Registration init (reference _core.py:310-368): NMI co-registration
    of all images when ``do_coreg`` and N > 1, alignment of image ``fix`` to
    the atlas when ``do_atlas_align`` (every image then moves by that one
    transform), then the rigid basis and zero poses."""
    N = sum(len(xc) for xc in x)
    sett.rigid_basis = affine_basis("SE")
    if sett.do_coreg and N > 1:
        t0 = info(sett, "init-reg-begin", "co", N)
        imgs = [(o.dat, o.mat) for xc in x for o in xc]
        with trace.span("registration.coreg", movers=N - 1):
            mat_a = affine_align(imgs, fix=sett.fix,
                                 gauge=getattr(sett, "coreg_gauge", "mean"),
                                 **sett.coreg_params)
        sett.mat_coreg = mat_a
        i = 0
        for xc in x:
            for o in xc:
                o.mat = np.linalg.solve(mat_a[i], o.mat)
                i += 1
        info(sett, "init-reg-done", t0)
    if sett.do_atlas_align:
        t0 = info(sett, "init-reg-begin", "atlas", N)
        imgs = [(o.dat, o.mat) for xc in x for o in xc]
        with trace.span("registration.atlas", movers=1):
            mat_a = atlas_align(imgs[sett.fix], rigid=sett.atlas_rigid)
        sett.mat_atlas = mat_a
        for xc in x:
            for o in xc:
                o.mat = np.linalg.solve(mat_a, o.mat)
        info(sett, "init-reg-done", t0)
    for xc in x:
        for o in xc:
            o.rigid_q = np.zeros(sett.rigid_basis.shape[0], np.float64)
    return x, sett


def resample_inplane(x: XData, sett):
    """Downsample in-plane axes finer than the recon voxel size
    (reference _core.py:457-493, force_inplane_res): a nearest-neighbour
    pull of the data, a majority vote of the label."""
    if not (sett.force_inplane_res and sett.max_iter > 0):
        return x
    for xc in x:
        for o in xc:
            vx_x = voxel_size(o.mat)
            D = np.eye(4)
            for i in range(3):
                tgt = sett.vx[i] if isinstance(sett.vx, (list, tuple)) else sett.vx
                D[i, i] = max(1.0, float(tgt) / vx_x[i])
            if np.abs(np.eye(4) - D).sum() < 1e-4:
                continue
            new_dim = tuple(int(v) for v in np.floor(
                np.linalg.inv(D[:3, :3]) @ np.asarray(o.dim, float)))
            M = affine_to_M(D)
            o.dat = pull(o.dat, M, new_dim, order=0)
            if o.label is not None:
                o.label[0] = warp_label(o.label[0], M, new_dim)
            o.mat = o.mat @ D
            o.dim = new_dim
    return x


def fix_affine(x: XData, sett):
    """Reset the origin of CT volumes, and of their labels (reference
    _core.py:145-168)."""
    if not sett.do_res_origin:
        return x
    cnt = 0
    for xc in x:
        for o in xc:
            if o.ct:
                omat = o.mat
                o.dat, o.mat = reset_origin(o.dat, omat)
                if o.label is not None:
                    o.label[0], _ = reset_origin(o.label[0], omat,
                                                 interpolation=0)
                o.dim = tuple(o.dat.shape)
                cnt += 1
    info(sett, "fix-affine", cnt)
    return x


def init(data, sett: Optional[Settings] = None):
    """Model initialiser (reference run.py:210-282). The subject gets a
    new trace id (``utils.trace``), carried on its ``y`` structs; the
    ``init.grid`` span carries the method format_y chose (``method``) and
    whether the fit projects (``proj``, ``Settings.do_proj``)."""
    sett = sett if sett is not None else Settings()
    get_device(sett)
    info(sett, "init")
    if sett.common_output:
        sett.do_atlas_align = True
        sett.crop = True
        if sett.pow == 0:
            sett.pow = 256
    tid = trace.new_id()
    with trace.span("init", ids=(tid,)):
        with trace.span("init.read"):
            x = read_data(data, sett)
        if sett.max_iter > 0:
            with trace.span("init.hyperpar"):
                x = estimate_hyperpar(x, sett)
        with trace.span("init.inputs"):
            x = fix_affine(x, sett)
            x = resample_inplane(x, sett)
        x, sett = init_reg(x, sett)
        with trace.span("init.grid") as grid:
            y, sett = format_y(x, sett)
            grid.attrs.update(method=sett.method, proj=bool(sett.do_proj))
        with trace.span("init.reslice"):
            x = proj_info_add(x, y, sett)
            y = init_y_dat(x, y, sett)
            y = init_y_label(x, y, sett)
    for yc in y:
        yc.trace_id = tid
    return x, y, sett


def write_data(x: XData, y: YData, sett, jtv=None):
    """Clip to the input range and write reconstructions (reference
    _core.py:587-670). Returns (dat_y, pth_y, label, pth_label). The
    span ``run.output`` holds the clamp and the copies to the host."""
    with trace.span("run.output"):
        return _write_data(x, y, sett, jtv)


def _write_data(x: XData, y: YData, sett, jtv=None):
    """:func:`write_data` inside its span."""
    mat = y[0].mat
    dir_out = sett.dir_out
    if dir_out is None:
        dir_out = x[0][0].direc if x[0][0].direc else "UniRes-output"
    if sett.write_out and not os.path.isdir(dir_out):
        os.makedirs(dir_out, exist_ok=True)

    pth_y: List[str] = []
    pth_label = None
    label = None
    dat_stack = []
    for c in range(len(x)):
        mn = min(float(torch.min(o.dat)) for o in x[c])
        mx = max(float(torch.max(o.dat)) for o in x[c])
        dat = torch.clamp(y[c].dat, mn, mx).cpu().numpy()
        dat_stack.append(dat)
        if sett.write_out and sett.mat is None:
            nam = x[c][0].nam if x[c][0].nam else f"{c}.nii.gz"
            fname = os.path.join(dir_out, _tag(sett, sett.prefix + nam))
            pth_y.append(fname)
            nifti_save(dat, fname, affine=mat)
            info(sett, "saved", fname)
            if y[c].label is not None:
                pth_label = os.path.join(
                    dir_out, _tag(sett, sett.prefix + "label_" + nam))
                label = y[c].label
                nifti_save(label.cpu().numpy(), pth_label, affine=mat)

    dat_y = np.stack(dat_stack, axis=-1)
    if sett.write_out and sett.mat is not None:
        nam = x[0][0].nam if x[0][0].nam else "0.nii.gz"
        fname = os.path.join(dir_out, _tag(sett, sett.prefix + nam))
        pth_y.append(fname)
        nifti_save(dat_y, fname, affine=mat)
        info(sett, "saved", fname)

    if sett.write_jtv and jtv is not None:
        nam = x[0][0].nam if x[0][0].nam else "0.nii.gz"
        fname = os.path.join(dir_out, _tag(sett, "jtv_" + sett.prefix + nam))
        nifti_save(jtv.cpu().numpy(), fname, affine=mat)
        info(sett, "saved", fname)

    return dat_y, pth_y, label, pth_label


def _tag(sett, nam: str) -> str:
    """BIDS '_space-unires_' tag (reference _util.py:215-222)."""
    if not sett.bids:
        return nam
    s = nam.split("_")
    return "_".join(s[:-1] + ["space-unires"] + [s[-1]])


def fit(x: XData, y: YData, sett):
    """Fit + write (reference run.py:24-207 public behavior).

    Returns (dat_y, mat_y, pth_y, R, label, pth_label).
    """
    y, R, jtv, obj, n_iter = _fit(x, y, sett)
    dat_y, pth_y, label, pth_label = write_data(x, y, sett, jtv=jtv)
    return dat_y, y[0].mat, pth_y, R, label, pth_label


def preproc(data, sett: Optional[Settings] = None):
    """One-call API (reference run.py:285-318); the span ``run.unit``
    holds the whole call."""
    with trace.span("run.unit", B=1) as unit:
        x, y, sett = init(data, sett)
        unit.ids = (trace.subject(y),)
        dat_y, mat_y, pth_y, _, _, _ = fit(x, y, sett)
    return dat_y, mat_y, pth_y


def fit_batch(xs, ys, setts):
    """Multi-subject fit + write (no reference analog: the reference fits
    one subject at a time).

    ``xs``/``ys``/``setts``: per-subject struct lists from :func:`init`.
    The solve runs data-parallel over the CUDA devices
    (``parallel.fit_batch``), each subject through the full per-subject
    algorithm, so results match per-subject :func:`fit` runs. Returns a list
    of (dat_y, mat_y, pth_y, R, label, pth_label) per subject.
    """
    from ..parallel.fit_batch import fit_batch as _fit_batch

    results = _fit_batch(xs, ys, setts[0])
    out = []
    for x, sett, (y, R, jtv, obj, n_iter) in zip(xs, setts, results):
        dat_y, pth_y, label, pth_label = write_data(x, y, sett, jtv=jtv)
        out.append((dat_y, y[0].mat, pth_y, R, label, pth_label))
    return out


def preproc_batch(subjects, sett: Optional[Settings] = None):
    """One-call batch API: init every subject, fit the batch, write every.

    ``subjects``: list of per-subject inputs (each as :func:`preproc`'s
    ``data``). Requires a geometry-homogeneous batch (same acquisition
    protocol; ``parallel.fit_batch.check_homogeneous`` raises otherwise).
    Returns a list of (dat_y, mat_y, pth_y) per subject.
    """
    sett = sett if sett is not None else Settings()
    if not sett.shard:
        sett.shard = "batch"
    inits = []
    with trace.span("run.unit", B=len(subjects)) as unit:
        for data in subjects:
            # init mutates settings (method, schedule, rigid basis): one
            # copy per subject. Subjects 1.. reconstruct on subject 0's
            # output grid so the batch is geometry-homogeneous (with
            # common_output all subjects land on the atlas grid already).
            sb = sett.copy()
            if inits and not sett.common_output:
                y0 = inits[0][1]
                sb.force_y_space = (y0[0].mat, y0[0].dim)
            inits.append(init(data, sb))
        unit.ids = trace.subjects([y for _, y, _ in inits])
        res = fit_batch(*(list(t) for t in zip(*inits)))
    return [(dat_y, mat_y, pth_y) for dat_y, mat_y, pth_y, _, _, _ in res]
