"""Data-parallel (multi-subject) fit over the CUDA devices.

The counterpart of ``unires_tpu.parallel.fit_batch``. Subjects are
independent, so the solve carries no communication between devices. Every
subject runs the FULL per-subject algorithm — ADMM y/z/w updates, even/odd
scaling GN, unified rigid GN, the coarse-to-fine lambda schedule and
per-subject gain convergence — so ``fit_batch`` on B subjects is semantically
identical to B independent ``pipeline.fit.fit`` runs (tested:
tests/test_torch_batch.py and tests/test_torch_batchchunk.py pin equality
against the single fit).

As in the JAX package, the subjects of one device form ONE chunk
(``solvers.fitloop.make_batch_chunk``, the JAX ``make_batch_chunk``'s
``vmap``): built once from subject 0, every subject's state, data, taus,
lam0 and geometry stacked on a leading subject axis, so that each
resampling kernel takes the subjects' volumes in one launch. On the card
the chunk is one captured CUDA graph, replayed ``chunk_iters`` times and
read once per chunk for all its subjects; a device's share of one subject
runs the same chunk with one subject, which is the single fit's iteration.
Subject b goes to device ``b % g`` (:func:`assign_devices`); with more
than one device, one host thread drives each. The batch must be
homogeneous (:func:`check_homogeneous`): its shapes are stacked. There is
no fallback to per-subject graphs or to the serial path.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..geometry import fov_centre, rigid_from_q
from ..ops.cuda_build import launch_marks, launches_since
from ..pipeline.fit import (COUNTED, _gather_subdats, _sync_state, chunk_len,
                            get_sched)
from ..solvers.fitloop import (init_state, make_batch_chunk, stack_states,
                               subject_state)
from ..utils import trace
from ..utils.host import to_host

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


class BatchRun:
    """The subjects of one device as one stacked chunk
    (``solvers.fitloop.make_batch_chunk``): ``step()`` runs a chunk of
    every subject and reads it once, appending each live iteration's
    objective to that subject's trace; ``finish()`` writes every subject's
    state back into its structs (``pipeline.fit._sync_state``, as the JAX
    package's l.250-264) and returns what ``pipeline.fit.fit`` returns for
    each. ``capture`` is the chunk's (tests and ``chip_smoke.py`` pass
    False to run the card uncaptured). Spans (``utils.trace``), as
    ``pipeline.fit.FitRun``'s: ``fit.setup``, ``fit.chunk``
    (``fit.chunk.launch``, ``fit.chunk.read``), ``fit.finish``."""

    def __init__(self, xs, ys, sett, capture=None):
        self.xs, self.ys, self.sett = xs, ys, sett
        self.B = len(xs)
        self.ids = trace.subjects(ys) or None  # of its spans
        with trace.span("fit.setup", ids=self.ids):
            self.chunk = make_batch_chunk(xs, ys, sett, chunk_len(sett),
                                          capture)
            self.state = stack_states([init_state(xb, yb, sett)
                                       for xb, yb in zip(xs, ys)])
            self.xdats = [[torch.stack([xb[c][n].dat for xb in xs])
                           for n in range(len(xs[0][c]))]
                          for c in range(len(xs[0]))]
            subdats = [_gather_subdats(xb, subs)
                       for xb, subs in zip(xs, self.chunk.subs_of)]
            self.subdats = [None if d[0] is None else torch.stack(d)
                            for d in zip(*subdats)]
        self.traces = [[] for _ in xs]

    @property
    def on(self) -> np.ndarray:
        """The subjects still fitting, as last read: (B,) bool."""
        h = self.state.host
        return ~h["done"] & (h["n_iter"] < self.sett.max_iter)

    @property
    def live(self) -> bool:
        return bool(self.on.any())

    def step(self, n: int = None) -> None:
        """One chunk of every subject (the finished ones frozen), read
        once: ``n`` iterations, by default and at most ``chunk_iters``, at
        most what ``max_iter`` leaves the least advanced live subject. A
        ``fit.chunk`` span with the iterations asked (``asked``), the
        subject-iterations run (``iters``) and each subject's ``n_iter``
        after the read."""
        with trace.span("fit.chunk", ids=self.ids) as span:
            n_iter = self.state.host["n_iter"][self.on]
            n = self.chunk.K if n is None else min(int(n), self.chunk.K)
            n = min(n, self.sett.max_iter - int(n_iter.min()))
            with trace.span("fit.chunk.launch"):
                self.chunk(self.state, self.xdats, self.subdats, n)
            with trace.span("fit.chunk.read"):
                out = self.chunk.read(self.state, n)
            for b in range(self.B):
                self.traces[b].extend(out["objs"][b, k]
                                      for k in np.flatnonzero(out["valid"][b]))
            span.attrs.update(asked=n, iters=int(out["valid"].sum()),
                              n_iter=[len(t) for t in self.traces])

    def finish(self):
        out = []
        basis = self.sett.rigid_basis
        with trace.span("fit.finish", ids=self.ids):
            for b, (x, y) in enumerate(zip(self.xs, self.ys)):
                st = subject_state(self.state, b)
                _sync_state(x, y, self.sett, st)
                N = sum(len(xc) for xc in x)
                R = np.stack([np.eye(4)] * N)
                centre = fov_centre(y[0].mat, y[0].dim)
                for i, o in enumerate(o for xc in x for o in xc):
                    if o.rigid_q is not None and basis is not None:
                        R[i] = rigid_from_q(o.rigid_q, basis, centre)
                obj = (np.asarray(self.traces[b]) if self.traces[b]
                       else np.zeros((0, 3)))
                out.append((y, R, st.jtv, obj, len(self.traces[b])))
        return out


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

    The call is a ``fit`` span (``utils.trace``) with the subjects' ids,
    ``B``, each subject's ``n_iter``, the host reads (``syncs``), the
    method (``method``) and the launches of the finite-difference stencils
    (``stencils``), of pull, push and pull_grad (``resamples``) and of the
    blur's passes (``blurs``), a batched launch serving the batch once, read
    after the fit; each
    device's spans nest in it, on that device's thread.
    """
    B = len(xs)
    if B == 0:
        return []
    with trace.span("fit", ids=trace.subjects(ys) or None, B=B) as span:
        syncs0, marks = to_host.syncs, launch_marks(COUNTED)
        results = _fit_batch(xs, ys, sett, devices, capture, span)
        span.attrs.update(n_iter=[r[-1] for r in results],
                          syncs=to_host.syncs - syncs0, method=sett.method,
                          **launches_since(COUNTED, marks))
    return results


def _fit_batch(xs, ys, sett, devices, capture, span):
    """:func:`fit_batch` inside its span ``span``."""
    B = len(xs)
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
