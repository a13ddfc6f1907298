"""Even/odd slice scaling for interleaved acquisitions.

Reference: unires/_project.py:9-24 (_apply_scaling). Slices at even index
along the thick axis scale by exp(+s), odd by exp(-s). The operator is
diagonal, hence self-adjoint; A and A^T apply the same scaling.
"""
from __future__ import annotations

import torch


def apply_scaling(dat: torch.Tensor, scl, axis: int) -> torch.Tensor:
    """Multiply even-index slices along ``axis`` (0-2, of the last three
    axes) by exp(scl), odd by exp(-scl).

    ``scl`` is a number or a 0-d tensor on the data's device (the fit
    chunk's, read by no host), or for a batch of volumes (B, X, Y, Z) a
    (B,) tensor, one scale per volume; each is rounded to the data's dtype
    before the product, as a Python number is.
    """
    axis += dat.dim() - 3
    n = dat.shape[axis]
    idx = torch.arange(n, device=dat.device)
    sgn = torch.where(idx % 2 == 0, 1.0, -1.0).to(dat.dtype)
    shape = [1] * dat.dim()
    shape[axis] = n
    if not isinstance(scl, torch.Tensor):
        scl = float(scl)
    elif scl.dim():
        scl = scl.to(dat.dtype).reshape(
            scl.shape + (1,) * (dat.dim() - scl.dim()))
    return dat * torch.exp(scl * sgn.reshape(shape))


def _parity(dat: torch.Tensor, axis: int, start: int) -> torch.Tensor:
    sl = [slice(None)] * dat.dim()
    sl[axis + dat.dim() - 3] = slice(start, None, 2)
    return dat[tuple(sl)]


def even_slices(dat: torch.Tensor, axis: int) -> torch.Tensor:
    """Slices at even indices along ``axis`` (the exp(+s) group)."""
    return _parity(dat, axis, 0)


def odd_slices(dat: torch.Tensor, axis: int) -> torch.Tensor:
    """Slices at odd indices along ``axis`` (the exp(-s) group)."""
    return _parity(dat, axis, 1)
