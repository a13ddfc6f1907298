"""Data-parallel (multi-subject) fit over the CUDA devices.

The counterpart of ``unires_tpu.parallel.fit_batch``. Subjects are
independent, so the solve carries no communication between devices. Every
subject runs the FULL per-subject algorithm — ADMM y/z/w updates, even/odd
scaling GN, unified rigid GN, the coarse-to-fine lambda schedule and
per-subject gain convergence — so ``fit_batch`` on B subjects is semantically
identical to B independent ``pipeline.fit.fit`` runs (tested:
tests/test_torch_batch.py pins equality against the single fit).

The JAX package compiles one program for a geometry-homogeneous batch and
maps it over a device mesh, with its Pallas window plans sized for every
subject. Here subject b goes to device ``b % g`` (:func:`assign_devices`),
and each device's subjects are fitted round-robin through the stepper that
``pipeline.fit.fit`` uses (``pipeline.fit.FitRun``): a chunk of
``chunk_iters`` outer iterations of every live subject is enqueued (on the
card, replays of each subject's captured graph) before any subject's chunk
is read, so that the card runs one subject's chunk while the host reads or
enqueues another's. With more than one device, one host thread drives each.
The batch must still be homogeneous (:func:`check_homogeneous`), as in the
JAX package.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..pipeline.fit import FitRun, get_sched

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
    observation geometry (dims, ratios, slice thickness). Per-subject poses,
    affines and hyper-parameters MAY differ. The CUDA kernels take any
    affine and would fit a mixed batch; the check is the JAX package's."""
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


def fit_batch(xs, ys, sett, devices=None):
    """Fit a geometry-homogeneous batch of subjects over the devices.

    ``xs``/``ys``: lists over subjects of the per-subject pipeline structs
    (as ``pipeline.run.init`` makes them); ``sett`` is subject 0's.
    ``devices`` (default :func:`batch_devices`) lists the torch devices to
    spread over; naming the CPU twice gives two host threads. Returns a list
    over subjects of ``(y, R, jtv, obj_trace, n_iter)``, each as
    ``pipeline.fit.fit`` returns it for that subject alone.

    As in the JAX package, checkpoint/resume, the profiler trace, the
    dashboards and ``clean_fov`` are single-subject features: batch mode
    does not read those settings. ``utils.host.to_host.syncs`` counts the
    reads of all subjects together.
    """
    B = len(xs)
    if B == 0:
        return []
    check_homogeneous(xs, ys, sett)
    sett = get_sched(sum(len(xc) for xc in xs[0]), sett)
    reg0 = float(np.atleast_1d(sett.reg_scl)[0])
    for yb in ys:
        for yc in yb:
            yc.lam = reg0 * yc.lam0

    if sett.max_iter <= 0:
        return [(ys[b], np.stack([np.eye(4)] * sum(len(xc) for xc in xs[b])),
                 None, np.zeros((0, 3)), 0) for b in range(B)]

    devices = ([torch.device(d) for d in devices] if devices is not None
               else batch_devices(sett))
    slots = assign_devices(B, len(devices))
    runs = []
    for xb, yb, slot in zip(xs, ys, slots):
        dev = devices[slot]
        _move(xb, yb, dev)
        sb = sett.copy()
        sb.device, sb.do_print = str(dev), 0  # the batch logs per round
        runs.append(FitRun(xb, yb, sb))

    lock = threading.Lock()

    def drive(mine):
        """Chunks of one device's subjects, every live subject's enqueued
        before any is read, until none is live."""
        while any(r.live for r in mine):
            live = [r for r in mine if r.live]
            for r in live:
                r.launch()
            for r in live:
                r.collect()
            if sett.do_print >= 1:
                t0 = runs[0].obj_trace
                with lock:
                    print(f"batch-fit: iter<= "
                          f"{max(r.n_iter for r in runs)} done "
                          f"{sum(not r.live for r in runs)}/{B} obj0 "
                          f"{t0[-1][0] if t0 else float('nan'):.6g}",
                          flush=True)

    groups = [[r for r, s in zip(runs, slots) if s == k]
              for k in sorted(set(slots))]
    if len(groups) == 1:
        drive(groups[0])
    else:
        errors = []

        def worker(mine):
            try:
                drive(mine)
            except BaseException as e:  # re-raised in the caller below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(g,)) for g in groups]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    return [r.finish(clean=False) for r in runs]
