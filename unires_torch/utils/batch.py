"""Reductions of a batch of subjects, each as it would run alone.

A batched fit chunk (``solvers.fitloop``, ``make_batch_chunk``) stacks its
subjects on a leading axis. Elementwise work runs on the stacked tensors:
every element is rounded as it would be alone. A reduction over a volume
is different: the device splits it by the size of the whole tensor, so the
order of its sums, and the last bits of the result, would change with the
batch. :func:`each` reduces every subject on its own, on the shape a single
fit gives it, so that a subject of a batch keeps its single fit's numbers
digit for digit. :func:`any_of` turns a per-subject decision into the
predicate of a ``utils.graph.cond``.
"""
from __future__ import annotations

from typing import Callable

import torch


def each(fn: Callable[[torch.Tensor], torch.Tensor], t: torch.Tensor,
         nd: int) -> torch.Tensor:
    """``fn`` of every leading entry of ``t`` (whose entries have ``nd``
    axes), stacked on the leading axes; ``fn(t)`` when there are none."""
    lead = tuple(t.shape[:t.dim() - nd])
    if not lead:
        return fn(t)
    outs = [fn(v) for v in t.reshape((-1,) + tuple(t.shape[-nd:]))]
    out = outs[0][None] if len(outs) == 1 else torch.stack(outs)
    return out.reshape(lead + tuple(out.shape[1:]))


def sum_f64(t: torch.Tensor, nd: int = 3) -> torch.Tensor:
    """The float64 sum of each leading entry's last ``nd`` axes."""
    return each(lambda v: v.sum(dtype=torch.float64), t, nd)


def any_of(mask: torch.Tensor) -> torch.Tensor:
    """The predicate "some subject needs it": ``mask`` itself for one
    subject (a 0-d or one-element mask), else ``mask.any()``."""
    return mask if mask.numel() == 1 else mask.any()
