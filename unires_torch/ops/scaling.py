"""Even/odd slice scaling for interleaved acquisitions.

Reference: unires/_project.py:9-24 (_apply_scaling). Slices at even index
along the thick axis scale by exp(+s), odd by exp(-s). The operator is
diagonal, hence self-adjoint; A and A^T apply the same scaling.
"""
from __future__ import annotations

import torch


def apply_scaling(dat: torch.Tensor, scl, axis: int) -> torch.Tensor:
    """Multiply even-index slices along ``axis`` by exp(scl), odd by exp(-scl)."""
    n = dat.shape[axis]
    idx = torch.arange(n, device=dat.device)
    sgn = torch.where(idx % 2 == 0, 1.0, -1.0).to(dat.dtype)
    shape = [1] * dat.dim()
    shape[axis] = n
    return dat * torch.exp(float(scl) * sgn.reshape(shape))
