"""Device-to-host reads, counted.

Every place where the host loop needs a number the device computed (an
objective, a line-search value, Gauss-Newton moments, the CG stop test) goes
through :func:`to_host`, so a run can report how often the host waited on
the card: ``to_host.syncs`` counts the reads.
"""
from __future__ import annotations

import numpy as np
import torch


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a numpy array on the host (one synchronisation on a card)."""
    to_host.syncs += 1
    return t.detach().cpu().numpy()


to_host.syncs = 0
