"""Fit orchestrator: chunks of outer iterations on the device.

Mirrors ``unires_tpu.pipeline.fit`` (reference ``fit``, unires/run.py:24-207):
lambda schedule with countdowns, gain-based convergence, optional even/odd
scaling and unified rigid updates, FOV cleaning and rigid-matrix collection.
The iterations run in chunks of ``Settings.chunk_iters``
(``solvers.fitloop.FitChunk``: on the card, replays of a captured CUDA
graph), each read by the host once, as the JAX loop does
(``unires_tpu/pipeline/fit.py:209-235``). One stepper (:class:`FitStepper`)
drives the chunk of one subject (:class:`FitRun`) or of a device's share of
a batch (``parallel.fit_batch.BatchRun``). Around a single fit's loop, at
chunk cadence: checkpoint / resume (``pipeline.checkpoint``; a chunk is cut
short to land on ``checkpoint_every``), a ``torch.profiler`` trace
(``Settings.profile_dir``) and the dashboards (``utils.plots``). The JAX
package's window re-plans have no counterpart: the CUDA kernels take any
affine, so a drifted pose never needs another program.
"""
from __future__ import annotations

import contextlib
import os
import time
from timeit import default_timer as timer

import numpy as np
import torch

from ..geometry import fov_centre, rigid_from_q
from ..ops.cuda_build import launch_marks, launches_since
from ..ops.resample import affine_to_M, pull
from ..solvers.admm import step_size
from ..solvers.fitloop import FitState, chunk_len, init_state, make_fit_chunk
from ..utils import trace
from ..utils.host import to_host
from ..utils.log import info
from ..utils.plots import plot_convergence, require_matplotlib, show_slices
from .checkpoint import load_checkpoint, restore_into, save_checkpoint
from .structs import XData, YData

def get_gain(obj_trace) -> float:
    """Relative gain of the last step (nitorch get_gain, run.py:100)."""
    v = np.asarray(obj_trace, dtype=np.float64)
    if v.size < 2:
        return float("inf")
    denom = v.max() - v.min()
    if denom == 0:
        return 0.0
    return float((v[-2] - v[-1]) / denom)


def get_sched(N: int, sett):
    """Coarse-to-fine lambda schedule (reference _core.py:288-307)."""
    if sett.sched_num < 0 or N == 1:
        sett.sched_num = 0
    if sett.rigid_mod < 1:
        sett.rigid_mod = 1
    scl = np.atleast_1d(np.asarray(sett.reg_scl, dtype=np.float32))
    if scl.size > 1:
        # explicit schedule given by the user
        sett.reg_scl = scl
        return sett
    sched = 2.0 ** np.arange(31, -1, -1, dtype=np.float32)
    ix = int(np.argmin(np.abs(sched - scl[0])))
    sched = sched[max(ix - sett.sched_num, 0):ix]
    sett.reg_scl = np.concatenate([sched, scl.reshape(1)])
    return sett


def clean_fov(x: XData, y: YData) -> None:
    """Zero recon voxels outside every observation's FOV (reference
    run.py:162-187; coordinate range g in [0, dim) per axis)."""
    for c in range(len(y)):
        dim_y = tuple(int(d) for d in y[c].dim)
        dev = y[c].dat.device
        ii, jj, kk = (torch.arange(n, dtype=torch.float32, device=dev)
                      for n in dim_y)
        ii, jj, kk = ii[:, None, None], jj[None, :, None], kk[None, None, :]
        msk = torch.ones(dim_y, dtype=torch.bool, device=dev)
        for o in x[c]:
            Minv = np.linalg.inv(np.linalg.solve(y[c].mat, o.po.rigid @ o.mat))
            Mj = Minv[:3, :4].astype(np.float32)
            for d in range(3):
                g = (float(Mj[d, 0]) * ii + float(Mj[d, 1]) * jj
                     + float(Mj[d, 2]) * kk + float(Mj[d, 3]))
                msk = msk & (g >= 0) & (g < o.dim[d])
        y[c].dat = torch.where(msk, y[c].dat, 0.0)


def gather_subdats(x, subs):
    """Flat per-observation NN-subsampled volumes for the rigid update
    (reference unires/_update.py:589-593) on the grids that
    ``solvers.fitloop.chunk_geom`` chose (``subs``); None without unified
    rigid or where the rigid grid is the main grid (rigid_samp=1 on >= 1 mm
    data)."""
    obs = [o for xc in x for o in xc]
    return [None if s is None or s["sub_is_main"] else
            pull(o.dat, affine_to_M(s["po"].D_x), s["po"].dim_x, order=0)
            for o, s in zip(obs, subs)]


def sync_state(x, y, sett, state: FitState) -> None:
    """Write the loop state back into the pipeline structs: q -> rigid_q and
    the centre-conjugated po.rigid, scl -> po.scl (the host's copies, as
    last read), ys -> y (device views), lam."""
    basis = sett.rigid_basis
    centre = fov_centre(y[0].mat, y[0].dim)
    i = 0
    for xc in x:
        for o in xc:
            o.rigid_q = np.array(state.host["q"][i], np.float64)
            if basis is not None:
                o.po.rigid = rigid_from_q(o.rigid_q, basis, centre)
            o.po.scl = float(state.host["scl"][i])
            i += 1
    reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
    cnt = state.host["cnt_scl"]
    for c in range(len(y)):
        y[c].dat = state.ys[c]
        y[c].lam = float(reg[min(cnt, reg.size - 1)]) * y[c].lam0


class FitStepper:
    """A fit's host side: the B subjects of one device in one chunk
    (``solvers.fitloop.FitChunk``; B = 1 for a single fit). ``step(n)``
    launches a chunk of every subject (``launch``) and reads it once,
    appending each live iteration's objective to that subject's trace
    (``traces``); ``finish()`` writes the states back
    (:func:`sync_state`) and returns :func:`fit`'s tuple for each subject.
    Its forms, :class:`FitRun` (one subject, its state unstacked) and
    ``parallel.fit_batch.BatchRun`` (stacked), give the chunk
    (``_make_chunk``), the chunk's state and volumes from the subjects'
    (``_stack``) and a subject's state (``_subject``). ``state`` and
    ``traces`` continue a fit; ``capture`` is the chunk's. With ``max_iter``
    <= 0 nothing is built. Spans (``utils.trace``, with the subjects' ids):
    ``fit.setup``, ``fit.chunk`` (``.launch``, ``.read``), ``fit.finish``.
    The chunk gets the same state and tensors at every step, so a captured
    chunk captures once.
    """

    def __init__(self, xs, ys, sett, state: FitState = None, traces=None,
                 capture=None):
        self.xs, self.ys, self.B = xs, ys, len(xs)
        self.ids = trace.subjects(ys) or None  # of its spans
        self.N = sum(len(xc) for xc in xs[0])
        self.sett = sett = get_sched(self.N, sett)
        self.traces = ([list(t) for t in traces] if traces is not None
                       else [[] for _ in xs])
        self.state = None
        self.pending = 0
        if state is None:
            # schedule position 0
            reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
            for y in ys:
                for yc in y:
                    yc.lam = float(reg[0]) * yc.lam0
        if sett.max_iter <= 0:
            return
        with trace.span("fit.setup", ids=self.ids):
            info(sett, "step-size", step_size(xs[0], ys[0], sett))
            self.chunk = self._make_chunk(chunk_len(sett), capture)
            self.state = (state if state is not None else self._stack(
                [init_state(x, y, sett) for x, y in zip(xs, ys)]))
            self.xdats = [[self._stack([x[c][n].dat for x in xs])
                           for n in range(len(xs[0][c]))]
                          for c in range(len(xs[0]))]
            subdats = [gather_subdats(x, subs)
                       for x, subs in zip(xs, self.chunk.subs_of)]
            self.subdats = [None if d[0] is None else self._stack(d)
                            for d in zip(*subdats)]

    @property
    def on(self) -> np.ndarray:
        """The subjects still fitting, as last read: (B,) bool."""
        h = self.state.host
        return (~np.atleast_1d(h["done"])
                & (np.atleast_1d(h["n_iter"]) < self.sett.max_iter))

    @property
    def live(self) -> bool:
        return self.state is not None and bool(self.on.any())

    def launch(self, n: int = None) -> None:
        """Enqueue a chunk of ``n`` iterations, by default and at most
        ``chunk_iters``, at most what ``max_iter`` leaves the least advanced
        live subject (every subject, when none is live)."""
        n = self.chunk.K if n is None else min(int(n), self.chunk.K)
        n_iter = np.atleast_1d(self.state.host["n_iter"])
        least = int(n_iter[self.on].min(initial=n_iter.max()))
        self.pending = min(n, self.sett.max_iter - least)
        self.chunk(self.state, self.xdats, self.subdats, self.pending)

    def _collect(self):
        """Read the launched chunk (one read); returns each subject's live
        iterations' (obj (3,), gain) rows, also appended to its trace."""
        n, self.pending = self.pending, 0
        out = self.chunk.read(self.state, n)
        objs = out["objs"].reshape(self.B, n, 3)
        gains = out["gains"].reshape(self.B, n)
        valid = out["valid"].reshape(self.B, n)
        rows = [[(objs[b, k], float(gains[b, k]))
                 for k in np.flatnonzero(valid[b])] for b in range(self.B)]
        for t, r in zip(self.traces, rows):
            t.extend(obj for obj, _ in r)
        return rows

    def step(self, n: int = None):
        """One chunk, launched and read; returns each subject's rows
        (:meth:`_collect`). A ``fit.chunk`` span with the iterations asked
        (``asked``), the subject-iterations run (``iters``) and each
        subject's ``n_iter`` after the read."""
        with trace.span("fit.chunk", ids=self.ids) as span:
            with trace.span("fit.chunk.launch"):
                self.launch(n)
            span.attrs["asked"] = self.pending
            with trace.span("fit.chunk.read"):
                rows = self._collect()
            span.attrs.update(iters=sum(map(len, rows)),
                              n_iter=[len(t) for t in self.traces])
        return rows

    def finish(self, clean: bool = False):
        """Each subject's (y, R, jtv, obj_trace, n_iter), its structs
        brought up to date; ``clean`` applies ``Settings.clean_fov``."""
        sett, basis = self.sett, self.sett.rigid_basis
        out = []
        with trace.span("fit.finish", ids=self.ids):
            for b, (x, y) in enumerate(zip(self.xs, self.ys)):
                jtv = None
                if self.state is not None:
                    st = self._subject(b)
                    sync_state(x, y, sett, st)
                    jtv = st.jtv
                if clean and sett.clean_fov:
                    clean_fov(x, y)
                # rigid matrices (reference run.py:195-200): centre-
                # conjugated world transforms of the fitted pose parameters
                obs = [o for xc in x for o in xc]
                R = np.stack([np.eye(4)] * len(obs))
                centre = fov_centre(y[0].mat, y[0].dim)
                for i, o in enumerate(obs):
                    if o.rigid_q is not None and basis is not None:
                        R[i] = rigid_from_q(o.rigid_q, basis, centre)
                t = self.traces[b]
                out.append((y, R, jtv, np.asarray(t) if t
                            else np.zeros((0, 3)), len(t)))
        return out


class FitRun(FitStepper):
    """One subject's fit, the single-subject :class:`FitStepper`: its chunk
    ``make_fit_chunk``'s, its state an unstacked ``FitState`` (checkpoints,
    ``pipeline.convert``). What a batch does not read: ``collect()``, the
    read of a ``launch()`` returning the one subject's rows, ``obj_trace``,
    ``n_iter``, ``sync()``, and ``finish()`` with ``clean_fov``, returning
    one tuple. ``fit`` drives one to the end; ``state`` and ``obj_trace``
    continue a fit (a resume, ``pipeline.convert``)."""

    def __init__(self, x: XData, y: YData, sett, state: FitState = None,
                 obj_trace=None, capture=None):
        self.x, self.y = x, y
        super().__init__([x], [y], sett, state,
                         None if obj_trace is None else [obj_trace], capture)

    def _make_chunk(self, K, capture):
        return make_fit_chunk(self.x, self.y, self.sett, K, capture)

    @staticmethod
    def _stack(items):
        return items[0]  # one subject, no subject axis

    def _subject(self, b):
        return self.state

    @property
    def obj_trace(self) -> list:
        return self.traces[0]

    @property
    def n_iter(self) -> int:
        """Outer iterations done, as last read."""
        return self.state.host["n_iter"]

    def collect(self):
        return self._collect()[0]

    def sync(self) -> None:
        sync_state(self.x, self.y, self.sett, self.state)

    def finish(self, clean: bool = True):
        return super().finish(clean)[0]


def _resume_state(x, y, sett):
    """(state, obj_trace) from ``sett.checkpoint_path``: the volumes, poses
    and scales of the file in a fresh loop state, the counters as saved
    (``n_iter`` is stored as iterations done - 1), and the gain's running
    values rebuilt from the saved trace. The saved rho is not read back
    (the step size follows from the restored lam), and the CG
    preconditioner's data-term diagonals are recomputed from the restored
    poses at the first iteration."""
    z, w, st = restore_into(load_checkpoint(sett.checkpoint_path), x, y,
                            torch.device(sett.device))
    tr = np.asarray(st["obj_trace"], np.float64).reshape(-1, 3)
    counters = {k: st[k] for k in ("cnt_scl", "cnt_scl_iter", "countdown0",
                                   "countdown1")}
    if tr.size:
        counters.update(prev_obj=float(tr[-1, 0]),
                        obj_max=float(tr[:, 0].max()),
                        obj_min=float(tr[:, 0].min()), has_prev=True)
    state = init_state(x, y, sett, z=z, w=w, n_iter=st["n_iter"] + 1,
                       **counters)
    return state, st["obj_trace"]


def _save_state(run: FitRun) -> None:
    run.sync()  # y[c].lam at the current schedule position, q, scl, ys
    h, sett = run.state.host, run.sett
    save_checkpoint(sett.checkpoint_path, run.x, run.y, run.state.z,
                    run.state.w, dict(
                        rho=step_size(run.x, run.y, sett),
                        cnt_scl=h["cnt_scl"], cnt_scl_iter=h["cnt_scl_iter"],
                        n_iter=h["n_iter"] - 1, countdown0=h["countdown0"],
                        countdown1=h["countdown1"],
                        obj_trace=np.asarray(run.obj_trace)))


@contextlib.contextmanager
def profile_trace(sett):
    """Trace everything inside the block with ``torch.profiler`` (host
    operators and, on a card, the CUDA kernels, the hand-written ones under
    their own names) when ``sett.profile_dir`` is set, and write a Chrome /
    Perfetto trace ``unires_fit_<pid>_<ms>.pt.trace.json`` there when the
    block ends, by an exception too. The whole block is traced: a long fit
    gives a large file."""
    if not sett.profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(sett.profile_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.device(sett.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            sett.profile_dir,
            f"unires_fit_{os.getpid()}_{int(time.time() * 1e3)}"
            ".pt.trace.json"))


def _dashboards(run: FitRun) -> None:
    """The optional figures, once per chunk (as the JAX loop): the
    per-channel slices of verbosity 3, the convergence plot and the JTV
    field (reference run.py:90-99)."""
    sett, st = run.sett, run.state
    if sett.do_print >= 3:
        for c in range(len(run.y)):
            show_slices(st.ys[c], title=f"y (channel {c}) @ iter {run.n_iter}",
                        fig_num=60 + c)
    if sett.plot_conv:
        plot_convergence(np.asarray(run.obj_trace))
    if sett.show_jtv:
        show_slices(st.jtv, title="JTV", fig_num=98, cmap="coolwarm")


@contextlib.contextmanager
def fit_span(ids, B: int, sett):
    """The ``fit`` span (``utils.trace``) of a fit of ``B`` subjects
    (trace ``ids``); the caller adds each subject's ``n_iter``. At its end
    it gains the host reads (``syncs``, the capture's wait included),
    ``method`` and each launch group's device launches
    (``ops.cuda_build.GROUPS``: ``stencils``, ``resamples``, ``blurs``; 0
    where the plain versions ran), read after the fit's last read."""
    with trace.span("fit", ids=ids, B=B) as span:
        syncs0, marks = to_host.syncs, launch_marks()
        yield span
        span.attrs.update(syncs=to_host.syncs - syncs0, method=sett.method,
                          **launches_since(marks=marks))


def fit(x: XData, y: YData, sett, state: FitState = None, capture=None):
    """Run the iterative solver; returns (y, R, jtv, obj_trace, n_iter).

    Output writing is the caller's job (``pipeline.run.fit``). ``state``
    continues a fit from a given loop state (``pipeline.convert``) instead
    of a fresh one. ``capture``: as :class:`FitRun`'s (default: a captured
    graph on a CUDA device).

    With ``checkpoint_every`` > 0 and a ``checkpoint_path`` the solver state
    is saved after every ``checkpoint_every``-th iteration of this call (a
    chunk is cut short to land there). With ``resume`` and an existing file
    the fit continues from it, and the returned trace and ``n_iter`` count
    the iterations before the checkpoint too; without the file it starts
    fresh.

    The call is a ``fit`` span (:func:`fit_span`) with the subject's
    ``n_iter``.
    """
    with fit_span(trace.subjects([y]) or None, 1, sett) as span:
        out = _fit(x, y, sett, state, capture)
        span.attrs["n_iter"] = [out[-1]]
    return out


def _fit(x, y, sett, state, capture):
    """:func:`fit` inside its span."""
    prior = None
    if (state is None and sett.max_iter > 0 and sett.resume
            and sett.checkpoint_path
            and os.path.exists(sett.checkpoint_path)):
        state, prior = _resume_state(x, y, sett)
    run = FitRun(x, y, sett, state, prior, capture)
    sett = run.sett
    if run.state is not None:
        require_matplotlib(sett)
        t00 = info(sett, "fit-start", len(x), run.N)
        last_ckpt = run.n_iter
        every = sett.checkpoint_every if sett.checkpoint_path else 0
        with profile_trace(sett):
            while run.live:
                t_chunk = timer()
                n = run.chunk.K
                if every > 0:
                    n = min(n, every - (run.n_iter - last_ckpt))
                rows, = run.step(n)
                t_now = timer()
                per_iter = (t_now - t_chunk) / max(len(rows), 1)
                base = run.n_iter - len(rows)
                for k, (obj, gain) in enumerate(rows):
                    info(sett, "fit-ll", base + k, obj, gain, t_now - per_iter)
                if rows and sett.do_print >= 2:
                    # reference verbosity 2 (_util.py:107-129)
                    run.sync()
                    info(sett, "reg-param", x)
                    info(sett, "scl-param", x)
                if rows and sett.do_print >= 3:
                    info(sett, "fit-done", t_chunk)
                _dashboards(run)
                if every > 0 and run.n_iter - last_ckpt >= every:
                    _save_state(run)
                    last_ckpt = run.n_iter
        if run.state.host["done"]:
            info(sett, "fit-finish", t00, run.n_iter - 1)
    return run.finish()
