"""Convert the JAX pipeline's state into the port's structs on a device.

``unires_tpu``'s ``init`` produces ``x`` (XData), ``y`` (YData) and its
``Settings``; its ADMM loop carries ``z``/``w``. This module copies them —
geometry (``ProjOp``), hyper-parameters (tau, sd, mu, lam0), volumes, labels,
the co-registration and atlas transforms (``mat_coreg``, ``mat_atlas``) and,
mid-fit, the loop state (poses, scales, schedule counters, z, w) — into
``unires_torch`` structs with torch tensors on ``device``, so both packages
can start an iteration from identical state. It needs no JAX: every array
goes through ``np.asarray``, and the structs are read by field name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.proj_op import ProjOp
from ..settings import Settings
from ..solvers.fitloop import FitState, init_state
from .fit import sync_state
from .structs import Chan, Obs


def to_tensor(a, device) -> torch.Tensor:
    """Any array (numpy, JAX, torch) -> float32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


def _label_tensor(a, device) -> torch.Tensor:
    """A label volume keeps its dtype."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    return torch.from_numpy(np.array(a)).to(device)


def convert_settings(sett, device) -> Settings:
    """Copy every field the port's Settings has; ``device`` replaces the
    source's."""
    src = {f.name: getattr(sett, f.name) for f in dataclasses.fields(Settings)
           if hasattr(sett, f.name)}
    src["device"] = str(device)
    return Settings(**src)


def convert_proj_op(po) -> ProjOp:
    return ProjOp(**{f.name: getattr(po, f.name)
                     for f in dataclasses.fields(ProjOp)})


def convert_fit_state(st, x, y, sett) -> FitState:
    """A JAX ``solvers.fitloop.FitState`` (the loop state between two of its
    chunks) -> the port's ``FitState`` on ``sett.device`` for the port's
    structs ``x`` / ``y``, which take its poses, scales and volumes. Its CG
    diagonals are kept (the port refreshes them on its own cadence)."""
    i = 0
    for xc in x:
        for o in xc:
            o.rigid_q = np.array(st.q[i], np.float64)
            o.po.scl = float(st.scl[i])
            i += 1
    ys = np.asarray(st.ys, np.float32)
    for c, yc in enumerate(y):
        yc.dat = to_tensor(ys[c], sett.device)
    out = init_state(
        x, y, sett, z=to_tensor(st.z, sett.device),
        w=to_tensor(st.w, sett.device), cnt_scl=int(st.cnt_scl),
        cnt_scl_iter=int(st.cnt_scl_iter), countdown0=int(st.countdown0),
        countdown1=int(st.countdown1), n_iter=int(st.n_iter),
        done=bool(st.done), prev_obj=float(st.prev_obj),
        obj_max=float(st.obj_max), obj_min=float(st.obj_min),
        has_prev=bool(st.has_prev), has_cdiags=True)
    out.jtv.copy_(to_tensor(st.jtv, sett.device))
    out.cdiags.copy_(to_tensor(st.cdiags, sett.device))
    return out


def convert_state(x, y, sett, device="cpu", z=None, w=None, state=None):
    """(x, y, sett[, z, w]) of the JAX pipeline -> the port's, on ``device``.

    Returns ``(x, y, sett)``, or ``(x, y, sett, z, w)`` when z and w (the
    ADMM auxiliary and dual variables, (C, 3, *dim_y)) are given, or
    ``(x, y, sett, state)`` for a JAX mid-fit ``FitState``: then the port's
    x and y also carry that state's poses, scales and volumes, so that
    ``pipeline.fit.fit(x, y, sett, state)`` continues the JAX fit.
    """
    device = torch.device(device)
    x_t = []
    for xc in x:
        row = []
        for o in xc:
            fields = {f.name: getattr(o, f.name) for f in dataclasses.fields(Obs)}
            fields["dat"] = to_tensor(o.dat, device)
            fields["po"] = None if o.po is None else convert_proj_op(o.po)
            fields["label"] = (None if o.label is None
                               else [_label_tensor(o.label[0], device),
                                     o.label[1]])
            row.append(Obs(**fields))
        x_t.append(row)
    y_t = []
    for yc in y:
        fields = {f.name: getattr(yc, f.name) for f in dataclasses.fields(Chan)}
        fields["dat"] = None if yc.dat is None else to_tensor(yc.dat, device)
        fields["label"] = (None if yc.label is None
                           else _label_tensor(yc.label, device))
        y_t.append(Chan(**fields))
    sett_t = convert_settings(sett, device)
    out = (x_t, y_t, sett_t)
    if state is not None:
        st = convert_fit_state(state, x_t, y_t, sett_t)
        sync_state(x_t, y_t, sett_t, st)
        return out + (st,)
    if z is not None or w is not None:
        out = out + (to_tensor(z, device), to_tensor(w, device))
    return out
