"""Reduce a ``torch.profiler`` trace of one fit chunk to what the per-layer
readers and the result's ``breakdown`` take: the device's busy seconds (the
union of its events' intervals), the chunk's wall seconds, the device time
and event count of the port's resampling kernels, the device operations
that took most time, and the idle gaps between device work by the
innermost host operation that was running across each."""
from __future__ import annotations

import re
from collections import defaultdict

import numpy as np

# the port's kernels in csrc/resample.cu, batched launches included
KERNEL_NAME = re.compile(r"\b(pull|push|pull_grad)(?:_batch)?_kernel\b")
TOP = 10


def _short(name: str) -> str:
    name = name.split("(")[0].strip()
    return name[:120]


def _merge(spans):
    """Disjoint, sorted union of (start, end) intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(prof, wall_s: float) -> dict:
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            dev.append((s, t, e.name))
        elif e.device_type == DeviceType.CPU and t > s:
            cpu.append((s, t, e.name))
    if not dev:
        return dict(busy_s=None, window_s=wall_s, kernels={}, device_ops=[],
                    idle_gaps=[], events=0)
    merged = _merge([(s, t) for s, t, _ in dev])
    busy_s = sum(t - s for s, t in merged) * 1e-6
    by_name = defaultdict(float)
    kernels = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        by_name[_short(name)] += (t - s) * 1e-6
        m = KERNEL_NAME.search(name)
        if m:
            kernels[m.group(1)][0] += 1
            kernels[m.group(1)][1] += (t - s) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy_s, window_s=wall_s,
                kernels={k: tuple(v) for k, v in kernels.items()},
                device_ops=[[n, s] for n, s in ops],
                idle_gaps=_idle_gaps(merged, cpu), events=len(dev))


def _idle_gaps(merged, cpu):
    """Seconds of the gaps between device work, summed by the innermost host
    operation covering each gap's middle, the longest first."""
    if len(merged) < 2:
        return []
    starts = np.array([m[0] for m in merged[1:]], np.float64)
    ends = np.array([m[1] for m in merged[:-1]], np.float64)
    length = starts - ends
    mid = 0.5 * (starts + ends)
    order = np.argsort(mid)
    mid, length = mid[order], length[order]
    owner = np.full(mid.size, -1, np.int64)
    names = {}
    # the shortest host operations first: each gap goes to the innermost
    for s, t, name in sorted(cpu, key=lambda ev: ev[1] - ev[0]):
        lo, hi = np.searchsorted(mid, s), np.searchsorted(mid, t)
        if lo == hi:
            continue
        free = lo + np.flatnonzero(owner[lo:hi] < 0)
        if free.size:
            owner[free] = names.setdefault(name, len(names))
    label = {i: _short(n) for n, i in names.items()}
    by = defaultdict(float)
    for o, n in zip(owner, length):
        by[label.get(o, "(no host operation)")] += n * 1e-6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]
