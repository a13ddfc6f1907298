"""Convert the JAX pipeline's state into the port's structs on a device.

``unires_tpu``'s ``init`` produces ``x`` (XData), ``y`` (YData) and its
``Settings``; its ADMM loop carries ``z``/``w``. This module copies them —
geometry (``ProjOp``), hyper-parameters (tau, sd, mu, lam0) and volumes — into
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
from .structs import Chan, Obs


def to_tensor(a, device) -> torch.Tensor:
    """Any array (numpy, JAX, torch) -> float32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(a, np.float32)).to(device)


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


def convert_state(x, y, sett, device="cpu", z=None, w=None):
    """(x, y, sett[, z, w]) of the JAX pipeline -> the port's, on ``device``.

    Returns ``(x, y, sett)``, or ``(x, y, sett, z, w)`` when z and w (the
    ADMM auxiliary and dual variables, (C, 3, *dim_y)) are given.
    """
    device = torch.device(device)
    x_t = []
    for xc in x:
        row = []
        for o in xc:
            fields = {f.name: getattr(o, f.name) for f in dataclasses.fields(Obs)}
            fields["dat"] = to_tensor(o.dat, device)
            fields["po"] = None if o.po is None else convert_proj_op(o.po)
            fields["label"] = None
            row.append(Obs(**fields))
        x_t.append(row)
    y_t = []
    for yc in y:
        fields = {f.name: getattr(yc, f.name) for f in dataclasses.fields(Chan)}
        fields["dat"] = None if yc.dat is None else to_tensor(yc.dat, device)
        fields["label"] = None
        y_t.append(Chan(**fields))
    out = (x_t, y_t, convert_settings(sett, device))
    if z is not None or w is not None:
        out = out + (to_tensor(z, device), to_tensor(w, device))
    return out
