"""Finite-difference gradient / divergence (D and D^T) for the JTV prior.

The semantics of ``unires_tpu.ops.finite_diff`` (nitorch im_gradient /
im_divergence as pinned by the reference, unires/_project.py:314-315,
unires/_update.py:132, 168-193): difference type 'forward' | 'backward' |
'central', voxel-size scaled, Dirichlet-zero bound, and ``im_divergence`` the
EXACT adjoint of ``im_gradient`` (the solver adds rho lam^2 D^T D to the CG
normal matrix, so adjointness is load-bearing).

Layout: the gradient of a (X, Y, Z) image is (3, X, Y, Z); leading axes
(a batch of images) ride along, (..., X, Y, Z) -> (..., 3, X, Y, Z).

Two implementations. The plain one (``gradient_plain`` /
``divergence_plain``) shifts with a zero fill and subtracts, axis by axis,
and is what a CPU tensor takes. A CUDA tensor takes one hand-written stencil
launch instead (``unires_torch/csrc/finite_diff.cu``: gradient, divergence
and the membrane operator D^T D), which reads its input once and writes its
output once and rounds as the plain chain on the card does, so the two agree
to the bit. The kernel takes float32 volumes, each C-contiguous, with any
stride between the volumes of a batch; for any other CUDA tensor the public
functions raise (TypeError for the dtype, ValueError for the layout), as the
resample wrappers do. The one exception: the 'backward' and 'central'
differences, which no configuration uses, have no kernel and take the plain
chain on either device. Each public function takes an optional ``scale``,
one factor or one per volume shaped to broadcast (a 0-d or (B, 1, ...)
tensor), multiplied in last as ``scale * result``; the kernel reads it from
device memory, so it may change between the replays of a captured graph.
Each counts its kernel's launches on the device (``im_gradient.launches``,
``im_divergence.launches``, ``DtD.launches``), all three in the launch
group "stencils" (``cuda_build.GROUPS``; :data:`STENCILS` lists them).
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda_build import Counted, check, check_size, kernels, volume_batch


def _roll_zero(u: torch.Tensor, shift: int, axis: int) -> torch.Tensor:
    """Shift with zero fill (Dirichlet bound): shift 1 -> u[i-1], -1 -> u[i+1]."""
    n = u.shape[axis]
    zero = torch.zeros_like(u.narrow(axis, 0, 1))
    if shift == 1:
        return torch.cat([zero, u.narrow(axis, 0, n - 1)], dim=axis)
    if shift == -1:
        return torch.cat([u.narrow(axis, 1, n - 1), zero], dim=axis)
    raise ValueError(shift)


def gradient_plain(dat: torch.Tensor, vx, which: str = "forward"
                   ) -> torch.Tensor:
    """D dat: (..., 3, X, Y, Z), per-axis finite difference divided by voxel
    size."""
    gs = []
    for d in range(3):
        ax = d - 3
        if which == "forward":
            g = _roll_zero(dat, -1, ax) - dat
        elif which == "backward":
            g = dat - _roll_zero(dat, 1, ax)
        elif which == "central":
            g = 0.5 * (_roll_zero(dat, -1, ax) - _roll_zero(dat, 1, ax))
        else:
            raise ValueError(which)
        gs.append(g / float(vx[d]))
    return torch.stack(gs, dim=-4)


def divergence_plain(p: torch.Tensor, vx, which: str = "forward"
                     ) -> torch.Tensor:
    """D^T p: exact adjoint of :func:`gradient_plain` (NOT the negative
    adjoint)."""
    out = torch.zeros_like(p.select(-4, 0))
    for d in range(3):
        ax = d - 3
        q = p.select(-4, d)
        if which == "forward":
            a = _roll_zero(q, 1, ax) - q
        elif which == "backward":
            a = q - _roll_zero(q, -1, ax)
        elif which == "central":
            a = 0.5 * (_roll_zero(q, 1, ax) - _roll_zero(q, -1, ax))
        else:
            raise ValueError(which)
        out = out + a / float(vx[d])
    return out


def _scaled(scale, r: torch.Tensor) -> torch.Tensor:
    return r if scale is None else scale * r


def _stencil_batch(t: torch.Tensor, which: str, nd: int, name: str):
    """``t`` (..., X, Y, Z) (nd = 3) or (..., 3, X, Y, Z) (nd = 4) viewed as
    the kernel's batch (B, ...), or None where the plain chain runs: a CPU
    tensor, or the 'backward' and 'central' differences. Raises for a CUDA
    tensor the kernel does not take (``cuda_build.volume_batch``)."""
    if which in ("backward", "central"):
        return None
    if which != "forward" and t.device.type != "cpu":
        raise ValueError(which)
    return volume_batch(t, nd, name)


def _launch(fn, entry: str, src: torch.Tensor, out: torch.Tensor, nd: int,
            vx, scale) -> torch.Tensor:
    """One launch of ``entry`` over the batch ``src`` (B, [3,] X, Y, Z) into
    ``out``, whose volumes have ``nd`` axes, counted in ``fn``'s
    launches."""
    B, dim = src.shape[0], tuple(src.shape[-3:])
    check_size(dim)
    dev = src.device
    s, sstride = None, 0
    if scale is not None:
        s = torch.as_tensor(scale, dtype=torch.float32, device=dev)
        if s.numel() != 1:
            if (s.numel() != B or s.dim() < nd
                    or any(n != 1 for n in s.shape[-nd:])):
                raise ValueError(f"{entry}: scale {tuple(s.shape)} is neither "
                                 f"one factor nor one per volume of {B}")
            s = s.reshape(B)
            sstride = s.stride(0)
    # the divide by vx as PyTorch's CUDA kernel divides by a Python number:
    # a multiply by its float32 reciprocal
    inv = [float(np.float32(1.0) / np.float32(float(vx[d]))) for d in range(3)]
    lib = kernels.get()
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            src.data_ptr(), out.data_ptr(), None if s is None else s.data_ptr(),
            sstride, *dim, B, src.stride(0), *inv, fn.count.ptr(dev),
            torch.cuda.current_stream().cuda_stream)
    check(err, entry)
    return out


def im_gradient(dat: torch.Tensor, vx, which: str = "forward",
                scale=None) -> torch.Tensor:
    """``scale *`` D dat: (..., 3, X, Y, Z), per-axis finite difference
    divided by voxel size."""
    v = _stencil_batch(dat, which, 3, "im_gradient")
    if v is None:
        return _scaled(scale, gradient_plain(dat, vx, which))
    out = torch.empty(dat.shape[:-3] + (3,) + dat.shape[-3:],
                      dtype=torch.float32, device=dat.device)
    return _launch(im_gradient, "unires_fd_gradient", v, out, 4, vx,
                   scale)


def im_divergence(p: torch.Tensor, vx, which: str = "forward",
                  scale=None) -> torch.Tensor:
    """``scale *`` D^T p: exact adjoint of :func:`im_gradient` (NOT the
    negative adjoint)."""
    q = _stencil_batch(p, which, 4, "im_divergence")
    if q is None:
        return _scaled(scale, divergence_plain(p, vx, which))
    out = torch.empty(p.shape[:-4] + p.shape[-3:], dtype=torch.float32,
                      device=p.device)
    return _launch(im_divergence, "unires_fd_divergence", q, out, 3, vx,
                   scale)


def DtD(dat: torch.Tensor, vx, which: str = "forward",
        scale=None) -> torch.Tensor:
    """``scale *`` D^T (D dat), the membrane operator of the CG normal
    matrix."""
    v = _stencil_batch(dat, which, 3, "DtD")
    if v is None:
        return _scaled(scale, divergence_plain(
            gradient_plain(dat, vx, which), vx, which))
    out = torch.empty(dat.shape, dtype=torch.float32, device=dat.device)
    return _launch(DtD, "unires_fd_membrane", v, out, 3, vx, scale)


im_gradient = Counted(im_gradient, group="stencils")
im_divergence = Counted(im_divergence, group="stencils")
DtD = Counted(DtD, group="stencils")
STENCILS = (im_gradient, im_divergence, DtD)
