"""Algorithm state containers (reference: unires/struct.py:4-54).

``Obs`` mirrors the reference ``_input`` (one observed volume), ``Chan``
mirrors ``_output`` (one reconstructed channel). Volumes are float32
``torch.Tensor``s on ``Settings.device``; geometry (affines, rigid parameters)
stays host-side float64 numpy — it is tiny.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import numpy as np

from ..models.proj_op import ProjOp


@dataclasses.dataclass
class Obs:
    """One observed volume (channel c, repeat n)."""

    dat: Any = None  # (dim) f32 torch.Tensor
    dim: Tuple[int, int, int] = None
    ct: bool = False
    mat: np.ndarray = None  # (4,4) f64 host affine
    mu: float = 1.0  # mean foreground intensity
    sd: float = 1.0  # background (noise) std
    tau: float = 1.0  # noise precision 1/sd^2
    po: Optional[ProjOp] = None
    fname: Optional[str] = None
    direc: Optional[str] = None
    nam: Optional[str] = None
    header: Any = None  # source NIfTI header (for save-like-source)
    rigid_q: Optional[np.ndarray] = None  # (6,) f64 se(3) params
    label: Any = None  # (volume, header) if a manual label is attached


@dataclasses.dataclass
class Chan:
    """One reconstructed channel."""

    dat: Any = None  # (dim_y) f32 torch.Tensor
    dim: Tuple[int, int, int] = None
    lam: float = None  # current regularisation
    lam0: float = None  # base regularisation (rescaled by the schedule)
    mat: np.ndarray = None  # (4,4) f64 host affine
    label: Any = None


XData = List[List[Obs]]
YData = List[Chan]
