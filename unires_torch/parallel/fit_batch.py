"""Data-parallel (multi-subject) fit over the CUDA devices.

The counterpart of ``unires_tpu.parallel.fit_batch``. Subjects are
independent, so the solve carries no communication between devices. Every
subject runs the FULL per-subject algorithm (ADMM, scaling and rigid GN,
the lambda schedule, its own convergence), so ``fit_batch`` on B subjects
is B independent ``pipeline.fit.fit`` runs (tests/test_torch_batch.py and
tests/test_torch_batchchunk.py pin equality against the single fit).

As in the JAX package, the subjects of one device form ONE chunk
(``solvers.fitloop.make_batch_chunk``, the JAX ``make_batch_chunk``'s
``vmap``), their state and data stacked on a leading subject axis, driven
by the fit's one stepper (:class:`BatchRun`, a ``pipeline.fit.FitStepper``):
on the card one captured CUDA graph, read once per chunk for all its
subjects. Subject b goes to device ``b % g`` (:func:`assign_devices`); with
more than one device, one host thread drives each. The batch must be
homogeneous (:func:`check_homogeneous`): its shapes are stacked.
"""
from __future__ import annotations

import threading

import torch

from ..pipeline.fit import FitStepper, fit_span
from ..solvers.fitloop import (FitState, make_batch_chunk, stack_states,
                               subject_state)
from ..utils import trace

__all__ = ["assign_devices", "check_homogeneous", "fit_batch"]


def batch_devices(sett):
    """The devices a batch may use: the one ``sett.device`` names when that
    is the CPU or a CUDA device with an index, else every CUDA device."""
    dev = torch.device(sett.device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def assign_devices(B: int, n_devices: int):
    """The device slot of each of B subjects: subject b -> slot ``b % g``,
    g the largest divisor of B that is at most ``n_devices`` (the JAX
    package's ``batch_mesh`` rule: any divisor is valid, and equal shares
    keep the devices level)."""
    g = 1
    for d in range(min(B, n_devices), 0, -1):
        if B % d == 0:
            g = d
            break
    return [b % g for b in range(B)]


def check_homogeneous(xs, ys, sett) -> None:
    """Raise ValueError unless the subjects form a homogeneous batch: same
    recon grid, same channel/repeat structure, same CT flags and the same
    observation geometry (dims, ratios, slice thickness), the shapes that
    a batched chunk stacks. Per-subject poses, affines and hyper-parameters
    MAY differ: they are stacked operands. The check is the JAX
    package's."""
    x0, y0 = xs[0], ys[0]
    dim0 = tuple(int(d) for d in y0[0].dim)
    struct0 = [len(xc) for xc in x0]
    ct0 = [o.ct for xc in x0 for o in xc]
    for b, (xb, yb) in enumerate(zip(xs, ys)):
        if [len(xc) for xc in xb] != struct0:
            raise ValueError(
                f"batch subject {b}: channel/repeat structure "
                f"{[len(xc) for xc in xb]} != subject 0's {struct0}")
        if tuple(int(d) for d in yb[0].dim) != dim0:
            raise ValueError(
                f"batch subject {b}: recon grid {yb[0].dim} != {dim0} "
                "(run init with common_output to force one output space)")
        if [o.ct for xc in xb for o in xc] != ct0:
            raise ValueError(f"batch subject {b}: CT flags differ")
        for c, (xc, xc0) in enumerate(zip(xb, x0)):
            for n, (o, o0) in enumerate(zip(xc, xc0)):
                if (o.po.dim_x != o0.po.dim_x
                        or o.po.dim_yx != o0.po.dim_yx
                        or o.po.ratio != o0.po.ratio
                        or o.po.dim_thick != o0.po.dim_thick):
                    raise ValueError(
                        f"batch subject {b} channel {c} repeat {n}: "
                        f"observation geometry differs from subject 0 "
                        f"({o.po.dim_x} vs {o0.po.dim_x}) — a homogeneous "
                        "acquisition protocol is required for batch mode")


def _move(x, y, dev) -> None:
    """Every tensor of a subject onto ``dev`` (a no-op where it lies there)."""
    for xc in x:
        for o in xc:
            o.dat = o.dat.to(dev)
            if o.label is not None:
                o.label[0] = o.label[0].to(dev)
    for yc in y:
        yc.dat = yc.dat.to(dev)
        if yc.label is not None:
            yc.label = yc.label.to(dev)


class BatchRun(FitStepper):
    """The subjects of one device as one stacked chunk: the many-subject
    ``pipeline.fit.FitStepper``, whose ``finish()`` returns a list over
    them (as the JAX package's l.250-264). Its own part: each subject's
    state and volumes stacked on a leading subject axis, and read back out.
    ``sett`` is subject 0's on the subjects' device."""

    def __init__(self, xs, ys, sett, capture=None):
        super().__init__(xs, ys, sett, capture=capture)

    def _make_chunk(self, K, capture):
        return make_batch_chunk(self.xs, self.ys, self.sett, K, capture)

    @staticmethod
    def _stack(items):
        if isinstance(items[0], FitState):
            return stack_states(items)
        return torch.stack(items)

    def _subject(self, b):
        return subject_state(self.state, b)


def fit_batch(xs, ys, sett, devices=None, capture=None):
    """Fit a geometry-homogeneous batch of subjects over the devices.

    ``xs``/``ys``: lists over subjects of the per-subject pipeline structs
    (as ``pipeline.run.init`` makes them); ``sett`` is subject 0's.
    ``devices`` (default :func:`batch_devices`) lists the torch devices to
    spread over; naming the CPU twice gives two host threads. Returns a list
    over subjects of ``(y, R, jtv, obj_trace, n_iter)``, each as
    ``pipeline.fit.fit`` returns it for that subject alone. ``capture``:
    as :class:`BatchRun`'s.

    As in the JAX package, checkpoint/resume, the profiler trace, the
    dashboards and ``clean_fov`` are single-subject features: batch mode
    does not read those settings. ``utils.host.to_host.syncs`` counts the
    reads of all devices together: one per chunk per device.

    The call is a ``fit`` span (``pipeline.fit.fit_span``) with the
    subjects' ids, ``B`` and each subject's ``n_iter``; each device's spans
    nest in it, on that device's thread.
    """
    B = len(xs)
    if B == 0:
        return []
    with fit_span(trace.subjects(ys) or None, B, sett) as span:
        results = _fit_batch(xs, ys, sett, devices, capture, span)
        span.attrs["n_iter"] = [r[-1] for r in results]
    return results


def _fit_batch(xs, ys, sett, devices, capture, span):
    """:func:`fit_batch` inside its span ``span``."""
    B = len(xs)
    check_homogeneous(xs, ys, sett)
    if sett.max_iter <= 0:
        return BatchRun(xs, ys, sett).finish()

    devices = ([torch.device(d) for d in devices] if devices is not None
               else batch_devices(sett))
    slots = assign_devices(B, len(devices))
    groups = [[b for b in range(B) if slots[b] == k]
              for k in sorted(set(slots))]
    runs = []
    for k, mine in zip(sorted(set(slots)), groups):
        dev = devices[k]
        for b in mine:
            _move(xs[b], ys[b], dev)
        sb = sett.copy()
        sb.device, sb.do_print = str(dev), 0  # the batch logs per round
        runs.append(BatchRun([xs[b] for b in mine], [ys[b] for b in mine],
                             sb, capture))

    lock = threading.Lock()

    def drive(run):
        """Chunks of one device's subjects until none is live."""
        while run.live:
            run.step()
            if sett.do_print >= 1:
                n_iter = max(int(r.state.host["n_iter"].max()) for r in runs)
                done = sum(int((~r.on).sum()) for r in runs)
                t0 = runs[0].traces[0]
                with lock:
                    print(f"batch-fit: iter<= {n_iter} done {done}/{B} obj0 "
                          f"{t0[-1][0] if t0 else float('nan'):.6g}",
                          flush=True)

    if len(runs) == 1:
        drive(runs[0])
    else:
        errors = []

        def worker(run):
            try:
                with trace.within(span):
                    drive(run)
            except BaseException as e:  # re-raised in the caller below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(r,)) for r in runs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    results = [None] * B
    for mine, run in zip(groups, runs):
        for b, res in zip(mine, run.finish()):
            results[b] = res
    return results
