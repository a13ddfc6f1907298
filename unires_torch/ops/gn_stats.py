"""The rigid Gauss-Newton statistics of the fit: the float64 moments of the
gradient and Hessian weight volumes (``solvers.rigid.match_stats_device``).

From the pulled gradient ``gr`` (..., X, Y, Z, 3), the back-projected
residual ``diff`` (..., X, Y, Z) and ``ctc`` (C^T C (1), a volume, or 1.0
where the forward model has no blur), the three gradient volumes
G_d = gr_d * diff and the six Hessian weights W_p = gr_a * gr_b * ctc
(pairs :data:`PAIRS`) give a (..., 72) float64 tensor: G_0..G_2's order-1
moments (4 each), then W_0..W_5's order-2 moments (10 each), over the
centred coordinates ``coords`` (``solvers.rigid._moments``' layout).

Two implementations. The plain one (:func:`gn_moments_plain`: the nine
products stacked into two volumes, each subject's moments taken alone by
``solvers.rigid._moments``) is what a CPU tensor takes. A CUDA tensor takes
``unires_torch/csrc/gn_stats.cu`` instead: one pass that reads each voxel of
``gr``, ``diff`` and ``ctc`` once and writes nothing the size of a volume,
each product rounded in float32 as the plain chain rounds it and every sum
in float64, in a fixed order (no floating-point atomics), so a rerun gives
the same moments to the bit and they differ from the plain chain's only by
the order of the float64 sums. The kernel takes float32 volumes, each
C-contiguous, with any stride between the volumes of a batch, and float64
coordinates on the same device; for any other CUDA input it raises
(TypeError for a dtype, ValueError for a layout or shape). It counts its two
launches (the partial sums and their reduction) on the device
(``gn_moments.launches``), in the launch group "gn_stats"
(``cuda_build.GROUPS``).
"""
from __future__ import annotations

import torch

from ..utils.batch import each
from .cuda_build import Counted, check, check_size, kernels, volume_batch

# the Hessian weights' index pairs (reference unires/_update.py)
PAIRS = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
N_MOMENTS = 3 * 4 + len(PAIRS) * 10


def gn_moments_plain(gr: torch.Tensor, diff: torch.Tensor, ctc,
                     coords) -> torch.Tensor:
    """:func:`gn_moments` as the plain chain, on any device."""
    # solvers.rigid imports this module: its moments are taken at call time
    from ..solvers.rigid import _moments

    G = torch.stack([gr[..., d] * diff for d in range(3)], dim=-4)
    W = torch.stack([gr[..., d1] * gr[..., d2] * ctc for d1, d2 in PAIRS],
                    dim=-4)
    return torch.cat([each(lambda g: _moments(g, coords, 1).reshape(-1), G, 4),
                      each(lambda w: _moments(w, coords, 2).reshape(-1), W,
                           4)], dim=-1)


def _coords(coords, dim, device):
    """The three coordinate vectors as the kernel reads them."""
    if len(coords) != 3:
        raise ValueError(f"gn_moments: expected 3 coordinate vectors, got "
                         f"{len(coords)}")
    for c, n in zip(coords, dim):
        if c.dtype != torch.float64:
            raise TypeError(f"gn_moments: coordinates must be float64, got "
                            f"{c.dtype}")
        if c.device != device or c.shape != (n,) or not c.is_contiguous():
            raise ValueError(f"gn_moments: coordinates of shape "
                             f"{tuple(c.shape)} on {c.device}, the kernel "
                             f"needs ({n},) contiguous on {device}")
    return coords


def gn_moments(gr: torch.Tensor, diff: torch.Tensor, ctc,
               coords) -> torch.Tensor:
    """The (..., 72) float64 moments of G and W (module docstring); each
    leading entry (a subject) is reduced on its own."""
    d = volume_batch(diff, 3, "gn_moments")
    if d is None:
        return gn_moments_plain(gr, diff, ctc, coords)
    g = volume_batch(gr, 4, "gn_moments")
    dim = tuple(diff.shape[-3:])
    if tuple(gr.shape) != tuple(diff.shape) + (3,):
        raise ValueError(f"gn_moments: gradient {tuple(gr.shape)} and "
                         f"residual {tuple(diff.shape)} do not match")
    B = d.shape[0]
    if isinstance(ctc, torch.Tensor):
        c = volume_batch(ctc, 3, "gn_moments")
        if tuple(ctc.shape[-3:]) != dim or c.shape[0] not in (1, B) \
                or c.device != d.device:
            raise ValueError(f"gn_moments: ctc {tuple(ctc.shape)} for "
                             f"volumes {tuple(diff.shape)}")
        c_ptr, c_stride = c.data_ptr(), c.stride(0) if c.shape[0] > 1 else 0
    elif ctc == 1.0:
        c_ptr, c_stride = None, 0
    else:
        raise ValueError(f"gn_moments: ctc must be a volume or 1.0, got "
                         f"{ctc!r}")
    ci, cj, ck = _coords(coords, dim, d.device)
    check_size(dim + (3,))
    lib = kernels.get()
    partial = torch.empty(B * lib.unires_gn_partials(*dim),
                          dtype=torch.float64, device=d.device)
    out = torch.empty((B, N_MOMENTS), dtype=torch.float64, device=d.device)
    with torch.cuda.device(d.device):
        err = lib.unires_gn_moments(
            g.data_ptr(), d.data_ptr(), c_ptr, ci.data_ptr(), cj.data_ptr(),
            ck.data_ptr(), *dim, B, g.stride(0), d.stride(0), c_stride,
            partial.data_ptr(), out.data_ptr(), gn_moments.count.ptr(d.device),
            torch.cuda.current_stream().cuda_stream)
    check(err, "unires_gn_moments")
    return out.view(tuple(diff.shape[:-3]) + (N_MOMENTS,))


gn_moments = Counted(gn_moments, group="gn_stats")
