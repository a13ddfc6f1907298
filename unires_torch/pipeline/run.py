"""Pipeline entry points: init / fit / preproc (reference unires/run.py).

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

from ..geometry import affine_basis
from ..settings import Settings, check_supported
from ..utils.log import info
from .fit import fit as _fit
from .format_y import format_y, init_y_dat, proj_info_add
from .hyperpar import estimate_hyperpar
from .nifti import load as nifti_load, save as nifti_save
from .structs import Obs, XData, YData


def get_device(sett) -> torch.device:
    """The torch device of ``Settings.device``; raises when it is a CUDA
    device and there is no CUDA (the port never falls back to the CPU)."""
    dev = torch.device(sett.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"Settings.device={sett.device!r} but CUDA is not available "
            "(pass device='cpu' to run the plain PyTorch path)")
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
    dat = np.array(dat, np.float32)  # copy: inputs may be read-only buffers
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

    info(sett, "filenames", x)
    return x


def init_reg(x: XData, sett):
    """Registration init (reference _core.py:310-368). Co-registration and
    atlas alignment are not ported yet (``check_supported``): this sets the
    rigid basis and zero poses."""
    sett.rigid_basis = affine_basis("SE")
    for xc in x:
        for o in xc:
            o.rigid_q = np.zeros(sett.rigid_basis.shape[0], np.float64)
    return x, sett


def init(data, sett: Optional[Settings] = None):
    """Model initialiser (reference run.py:210-282)."""
    sett = sett if sett is not None else Settings()
    get_device(sett)
    info(sett, "init")
    x = read_data(data, sett)
    check_supported(sett, sum(len(xc) for xc in x))
    if sett.max_iter > 0:
        x = estimate_hyperpar(x, sett)
    x, sett = init_reg(x, sett)
    y, sett = format_y(x, sett)
    x = proj_info_add(x, y, sett)
    y = init_y_dat(x, y, sett)
    return x, y, sett


def write_data(x: XData, y: YData, sett, jtv=None):
    """Clip to the input range and write reconstructions (reference
    _core.py:587-670). Returns (dat_y, pth_y, label, pth_label)."""
    mat = y[0].mat
    dir_out = sett.dir_out
    if dir_out is None:
        dir_out = x[0][0].direc if x[0][0].direc else "UniRes-output"
    if sett.write_out and not os.path.isdir(dir_out):
        os.makedirs(dir_out, exist_ok=True)

    pth_y: List[str] = []
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

    return dat_y, pth_y, None, None


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
    """One-call API (reference run.py:285-318)."""
    x, y, sett = init(data, sett)
    dat_y, mat_y, pth_y, _, _, _ = fit(x, y, sett)
    return dat_y, mat_y, pth_y
