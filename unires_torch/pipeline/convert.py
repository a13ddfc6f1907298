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
from ..solvers.fitloop import FitState
from .fit import _sync_state
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


def convert_fit_state(st, device) -> FitState:
    """A JAX ``solvers.fitloop.FitState`` (the loop state between two of its
    chunks) -> the port's ``FitState``: volumes to ``device``, poses and
    scales to host float64, counters and flags to Python scalars."""
    return FitState(
        ys=to_tensor(st.ys, device), z=to_tensor(st.z, device),
        w=to_tensor(st.w, device), jtv=to_tensor(st.jtv, device),
        q=np.array(st.q, np.float64), scl=np.array(st.scl, np.float64),
        cdiags=to_tensor(st.cdiags, device),
        cnt_scl=int(st.cnt_scl), cnt_scl_iter=int(st.cnt_scl_iter),
        countdown0=int(st.countdown0), countdown1=int(st.countdown1),
        n_iter=int(st.n_iter), done=bool(st.done),
        prev_obj=float(st.prev_obj), obj_max=float(st.obj_max),
        obj_min=float(st.obj_min), has_prev=bool(st.has_prev))


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
        st = convert_fit_state(state, device)
        _sync_state(x_t, y_t, sett_t, st)
        return out + (st,)
    if z is not None or w is not None:
        out = out + (to_tensor(z, device), to_tensor(w, device))
    return out
