"""Checkpoint / resume for the ADMM solver.

The reference is one-shot (intermediate state lives only in RAM and is lost
on failure; the restartable unit is the whole preproc call). Here the solver
state is small and explicit — {y, z, w, rigid_q, scl, schedule position,
rho, iteration, objective trace, countdowns} — and is written with numpy
every ``sett.checkpoint_every`` outer iterations, so a run resumes mid-solve
after pre-emption.

The file is ``unires_tpu.pipeline.checkpoint``'s, key for key (a numpy
``.npz`` read with ``allow_pickle=False``): a checkpoint written by either
package resumes in the other. The CG preconditioner's data-term diagonals
are not in it; a resumed fit recomputes them from the restored poses.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import affine_basis, fov_centre, rigid_from_q

_SCALARS = ("rho", "cnt_scl", "cnt_scl_iter", "n_iter", "countdown0",
            "countdown1")


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save_checkpoint(path: str, x, y, z, w, state: dict) -> str:
    """Write solver state. ``state`` carries the host-side loop scalars.

    The file is written beside ``path`` and moved over it, so a failed
    write leaves the previous checkpoint intact.
    """
    payload = dict(
        ys=np.stack([_np(yc.dat) for yc in y]),
        z=_np(z),
        w=_np(w),
        lams=np.asarray([yc.lam for yc in y], np.float64),
        lam0s=np.asarray([yc.lam0 for yc in y], np.float64),
        rigid_q=np.stack([np.asarray(o.rigid_q, np.float64)
                          if o.rigid_q is not None else np.zeros(6)
                          for xc in x for o in xc]),
        scls=np.asarray([o.po.scl for xc in x for o in xc], np.float64),
        obj_trace=np.asarray(state.get("obj_trace", np.zeros((0, 3)))),
    )
    for k in _SCALARS:
        payload[k] = np.asarray(state[k])
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(tmp, **payload)  # numpy appends ".npz"
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
    return path


def load_checkpoint(path: str) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def restore_into(ckpt: dict, x, y, device=None):
    """Apply a checkpoint onto freshly-initialised (x, y) structs.

    Volumes go to ``device`` (default: where ``y[0].dat`` lies), poses and
    scales to host float64, and every ``po.rigid`` is rebuilt from its pose
    about the recon FOV's centre. Returns (z, w, state-dict) for the fit
    loop.
    """
    if device is None:
        device = y[0].dat.device
    C = len(y)
    ys = ckpt["ys"]
    if ys.shape[0] != C:
        raise ValueError(f"checkpoint holds {ys.shape[0]} channels, the "
                         f"problem has {C}")

    def vol(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)

    for c in range(C):
        y[c].dat = vol(ys[c])
        y[c].lam = float(ckpt["lams"][c])
        y[c].lam0 = float(ckpt["lam0s"][c])
    centre = fov_centre(y[0].mat, y[0].dim)
    i = 0
    for xc in x:
        for o in xc:
            o.rigid_q = np.array(ckpt["rigid_q"][i], np.float64)
            o.po.scl = float(ckpt["scls"][i])
            o.po.rigid = rigid_from_q(o.rigid_q, affine_basis("SE"), centre)
            i += 1
    state = dict(
        rho=float(ckpt["rho"]),
        cnt_scl=int(ckpt["cnt_scl"]),
        cnt_scl_iter=int(ckpt["cnt_scl_iter"]),
        n_iter=int(ckpt["n_iter"]),
        countdown0=int(ckpt["countdown0"]),
        countdown1=int(ckpt["countdown1"]),
        obj_trace=[row for row in np.asarray(ckpt["obj_trace"], np.float64)],
    )
    return vol(ckpt["z"]), vol(ckpt["w"]), state
