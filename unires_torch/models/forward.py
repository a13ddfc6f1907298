"""The forward model: A, A^T and A^T A for super-resolution / denoising.

The chains of ``unires_tpu.models.forward`` (reference _proj_apply,
unires/_project.py:99-190):

  super-resolution:
    A   y = S_scl . C_blur,stride=ratio . Pull_{M}  y
    A^T x = Push_{M} . C^T               . S_scl    x
    A^T A = Push . C^T . S_{2 scl} . C . Pull
  denoising:
    A = Pull, A^T = Push, A^T A = Push . Pull

with M = mat_y \\ rigid @ mat_yx (or mat_x for denoising). Pull and push run
through ``ops.resample``, i.e. the CUDA kernels for CUDA tensors. The JAX
package's window plans and capacity checks have no counterpart: the kernels
take any affine map.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from ..ops.conv import blur_down_sep, blur_up_sep
from ..ops.resample import pull, push
from ..ops.scaling import apply_scaling
from .proj_op import ProjOp

Method = Literal["super-resolution", "denoising"]


def make_obs_ops(po: ProjOp, method: Method):
    """A / At / AtA callables for one observation.

    Each takes ``(dat, M, Minv, scl)``: the volume, the (3, 4) host maps of
    the current pose (:func:`obs_dyn_args`) and the even/odd scaling scalar.
    """
    src_dim = po.dim_yx if method == "super-resolution" else po.dim_x
    dim_y = po.dim_y

    def pull_fn(dat, M):
        return pull(dat, M, src_dim)

    def push_fn(dat, M, Minv):
        return push(dat, M, dim_y, Minv=Minv)

    if method == "denoising":
        def A(dat, M, Minv, scl):
            return pull_fn(dat, M)

        def At(dat, M, Minv, scl):
            return push_fn(dat, M, Minv)

        def AtA(dat, M, Minv, scl):
            return push_fn(pull_fn(dat, M), M, Minv)

        return A, At, AtA

    kers = po.smo_ker_1d
    ratio = po.ratio
    axis = po.dim_thick

    def A(dat, M, Minv, scl):
        out = pull_fn(dat, M)
        out = blur_down_sep(out, kers, ratio)
        return apply_scaling(out, scl, axis)

    def At(dat, M, Minv, scl):
        out = apply_scaling(dat, scl, axis)
        out = blur_up_sep(out, kers, ratio)
        return push_fn(out, M, Minv)

    def AtA(dat, M, Minv, scl):
        out = pull_fn(dat, M)
        out = blur_down_sep(out, kers, ratio)
        out = apply_scaling(out, 2.0 * float(scl), axis)
        out = blur_up_sep(out, kers, ratio)
        return push_fn(out, M, Minv)

    return A, At, AtA


def obs_dyn_args(po: ProjOp, method: Method, rigid=None):
    """(M, Minv) (3, 4) float32 host maps for the observation's pose."""
    M = po.M_sr(rigid) if method == "super-resolution" else po.M_den(rigid)
    M4 = np.eye(4)
    M4[:3, :4] = M
    Minv = np.linalg.inv(M4)[:3, :4].astype(np.float32)
    return M, Minv


def proj_apply(operator: str, dat: torch.Tensor, po: ProjOp, method: Method,
               M=None, scl=None) -> torch.Tensor:
    """Apply 'A' | 'At' | 'AtA' | 'none' of one observation's operator.

    Args:
        operator: which map to apply.
        dat: (dim_y) for A/AtA, (dim_x) for At; float32 on any device.
        po: static geometry.
        M: (3,4) map (defaults to po's rigid).
        scl: even/odd scaling scalar (defaults to po.scl).

    Returns the projected volume ((dim_x) for A, (dim_y) for At/AtA).
    """
    if operator == "none":
        return dat
    if operator not in ("A", "At", "AtA"):
        raise ValueError(f"Undefined operator {operator!r}")
    if method not in ("super-resolution", "denoising"):
        raise ValueError(f"Undefined method {method!r}")
    scl = float(np.float32(po.scl if scl is None else scl))
    if M is None:
        M, Minv = obs_dyn_args(po, method)
    else:
        M = np.asarray(M, np.float32).reshape(3, 4)
        M4 = np.eye(4)
        M4[:3, :4] = M
        Minv = np.linalg.inv(M4)[:3, :4].astype(np.float32)
    fn = dict(zip(("A", "At", "AtA"), make_obs_ops(po, method)))[operator]
    return fn(dat, M, Minv, scl)


def check_adjoint(po: ProjOp, method: Method, seed: int = 0):
    """<Ay, x> - <A^T x, y> on seeded random volumes (reference
    unires/_project.py:27-51). Returns (difference, <Ay, x>)."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random(po.dim_x, dtype=np.float32))
    y = torch.from_numpy(rng.random(po.dim_y, dtype=np.float32))
    Ay = proj_apply("A", y, po, method)
    Atx = proj_apply("At", x, po, method)
    lhs = torch.sum(Ay * x)
    rhs = torch.sum(Atx * y)
    return float(lhs - rhs), float(lhs)
