"""Fit orchestrator: the host-driven outer loop.

Mirrors ``unires_tpu.pipeline.fit`` (reference ``fit``, unires/run.py:24-207):
lambda schedule with countdowns, gain-based convergence, optional even/odd
scaling and unified rigid updates, FOV cleaning and rigid-matrix collection.
One outer iteration per step (``solvers.fitloop.make_fit_iteration``),
held by a per-subject stepper (:class:`FitRun`) that ``parallel.fit_batch``
shares. Around the loop: checkpoint / resume (``pipeline.checkpoint``), a
``torch.profiler`` trace (``Settings.profile_dir``) and the matplotlib
dashboards (``utils.plots``). The JAX package's window re-plans have no
counterpart: the CUDA kernels take any affine, so a drifted pose never needs
another program.
"""
from __future__ import annotations

import contextlib
import os
import time
from timeit import default_timer as timer

import numpy as np
import torch

from ..geometry import fov_centre, rigid_from_q
from ..ops.resample import affine_to_M, pull
from ..solvers.admm import step_size
from ..solvers.fitloop import FitState, init_state, make_fit_iteration
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


def _gather_subdats(x, subs):
    """Flat per-observation NN-subsampled volumes for the rigid update
    (reference unires/_update.py:589-593) on the grids that
    ``solvers.fitloop.chunk_geom`` chose (``subs``); None without unified
    rigid or where the rigid grid is the main grid (rigid_samp=1 on >= 1 mm
    data)."""
    obs = [o for xc in x for o in xc]
    return [None if s is None or s["sub_is_main"] else
            pull(o.dat, affine_to_M(s["po"].D_x), s["po"].dim_x, order=0)
            for o, s in zip(obs, subs)]


def _sync_state(x, y, sett, state: FitState) -> None:
    """Write the loop state back into the pipeline structs: q -> rigid_q and
    the centre-conjugated po.rigid, scl -> po.scl, ys -> y, lam."""
    basis = sett.rigid_basis
    centre = fov_centre(y[0].mat, y[0].dim)
    i = 0
    for xc in x:
        for o in xc:
            o.rigid_q = np.array(state.q[i], np.float64)
            if basis is not None:
                o.po.rigid = rigid_from_q(o.rigid_q, basis, centre)
            o.po.scl = float(state.scl[i])
            i += 1
    reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
    for c in range(len(y)):
        y[c].dat = state.ys[c]
        y[c].lam = float(reg[min(state.cnt_scl, reg.size - 1)]) * y[c].lam0


class FitRun:
    """One subject's fit as a stepper: ``step()`` runs one outer iteration
    and appends its objective to ``obj_trace``; ``finish()`` writes the loop
    state back into the structs and returns what ``fit`` returns.

    ``fit`` drives one of these to the end; ``parallel.fit_batch`` holds one
    per subject and steps them in turn. Each owns its iteration closure
    (``solvers.fitloop.make_fit_iteration`` caches per-observation tensors on
    the subject's device), so no two subjects share one.
    """

    def __init__(self, x: XData, y: YData, sett, state: FitState = None,
                 obj_trace=None):
        self.x, self.y = x, y
        self.N = sum(len(xc) for xc in x)
        self.sett = sett = get_sched(self.N, sett)
        self.obj_trace = list(obj_trace) if obj_trace is not None else []
        self.state = None
        if state is None:
            # schedule position 0
            reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float64))
            for yc in y:
                yc.lam = float(reg[0]) * yc.lam0
        if sett.max_iter > 0:
            info(sett, "step-size", step_size(x, y, sett))
            self.state = state if state is not None else init_state(x, y, sett)
            self.iterate = make_fit_iteration(x, y, sett)
            self.xdats = [[o.dat for o in xc] for xc in x]
            self.subdats = _gather_subdats(x, self.iterate.subs)

    @property
    def live(self) -> bool:
        st = self.state
        return (st is not None and not st.done
                and st.n_iter < self.sett.max_iter)

    def step(self):
        """One outer iteration; returns (obj (3,), gain)."""
        self.state, obj, gain = self.iterate(self.state, self.xdats,
                                             self.subdats)
        self.obj_trace.append(obj)
        return obj, gain

    def sync(self) -> None:
        _sync_state(self.x, self.y, self.sett, self.state)

    def finish(self, clean: bool = True):
        """(y, R, jtv, obj_trace, n_iter) with the structs brought up to
        date; ``clean`` applies ``Settings.clean_fov``."""
        x, y, sett = self.x, self.y, self.sett
        jtv = None
        if self.state is not None:
            self.sync()
            jtv = self.state.jtv
        if clean and sett.clean_fov:
            clean_fov(x, y)
        # rigid matrices (reference run.py:195-200): centre-conjugated world
        # transforms of the fitted pose parameters
        R = np.stack([np.eye(4)] * self.N)
        centre = fov_centre(y[0].mat, y[0].dim)
        for i, o in enumerate(o for xc in x for o in xc):
            if o.rigid_q is not None and sett.rigid_basis is not None:
                R[i] = rigid_from_q(o.rigid_q, sett.rigid_basis, centre)
        trace = (np.asarray(self.obj_trace) if self.obj_trace
                 else np.zeros((0, 3)))
        return y, R, jtv, trace, len(self.obj_trace)


def _resume_state(x, y, sett):
    """(state, obj_trace) from ``sett.checkpoint_path``: the volumes, poses
    and scales of the file in a fresh loop state, the counters as saved
    (``n_iter`` is stored as iterations done - 1), and the gain's running
    values rebuilt from the saved trace. The saved rho is not read back
    (the step size follows from the restored lam), and ``cdiags`` stays
    None: the first iteration recomputes the preconditioner's data-term
    diagonals from the restored poses."""
    z, w, st = restore_into(load_checkpoint(sett.checkpoint_path), x, y,
                            torch.device(sett.device))
    state = init_state(x, y, sett)
    state.z, state.w = z, w
    tr = np.asarray(st["obj_trace"], np.float64).reshape(-1, 3)
    state.cnt_scl = st["cnt_scl"]
    state.cnt_scl_iter = st["cnt_scl_iter"]
    state.countdown0 = st["countdown0"]
    state.countdown1 = st["countdown1"]
    state.n_iter = st["n_iter"] + 1
    if tr.size:
        state.prev_obj = float(tr[-1, 0])
        state.obj_max = float(tr[:, 0].max())
        state.obj_min = float(tr[:, 0].min())
        state.has_prev = True
    return state, st["obj_trace"]


def _save_state(run: FitRun) -> None:
    run.sync()  # y[c].lam at the current schedule position, q, scl, ys
    st, sett = run.state, run.sett
    save_checkpoint(sett.checkpoint_path, run.x, run.y, st.z, st.w, dict(
        rho=step_size(run.x, run.y, sett), cnt_scl=st.cnt_scl,
        cnt_scl_iter=st.cnt_scl_iter, n_iter=st.n_iter - 1,
        countdown0=st.countdown0, countdown1=st.countdown1,
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
    """The optional figures, once per outer iteration (the JAX loop draws
    them once per chunk): the per-channel slices of verbosity 3, the
    convergence plot and the JTV field (reference run.py:90-99)."""
    sett, st = run.sett, run.state
    if sett.do_print >= 3:
        for c in range(len(run.y)):
            show_slices(st.ys[c], title=f"y (channel {c}) @ iter {st.n_iter}",
                        fig_num=60 + c)
    if sett.plot_conv:
        plot_convergence(np.asarray(run.obj_trace))
    if sett.show_jtv:
        show_slices(st.jtv, title="JTV", fig_num=98, cmap="coolwarm")


def fit(x: XData, y: YData, sett, state: FitState = None):
    """Run the iterative solver; returns (y, R, jtv, obj_trace, n_iter).

    Output writing is the caller's job (``pipeline.run.fit``). ``state``
    continues a fit from a given loop state (``pipeline.convert``) instead
    of a fresh one.

    With ``checkpoint_every`` > 0 and a ``checkpoint_path`` the solver state
    is saved after every ``checkpoint_every``-th iteration of this call (the
    JAX loop looks once per chunk of ``chunk_iters`` iterations, so it saves
    at the first chunk end at least that far on). With ``resume`` and an
    existing file the fit continues from it, and the returned trace and
    ``n_iter`` count the iterations before the checkpoint too; without the
    file it starts fresh.
    """
    prior = None
    if (state is None and sett.max_iter > 0 and sett.resume
            and sett.checkpoint_path
            and os.path.exists(sett.checkpoint_path)):
        state, prior = _resume_state(x, y, sett)
    run = FitRun(x, y, sett, state, prior)
    sett = run.sett
    if run.state is not None:
        require_matplotlib(sett)
        t00 = info(sett, "fit-start", len(x), run.N)
        last_ckpt = run.state.n_iter
        with profile_trace(sett):
            while run.live:
                t_it = timer()
                obj, gain = run.step()
                n_done = run.state.n_iter
                info(sett, "fit-ll", n_done - 1, obj, gain, t_it)
                if sett.do_print >= 2:  # reference verbosity 2 (_util.py:107-129)
                    run.sync()
                    info(sett, "reg-param", x)
                    info(sett, "scl-param", x)
                if sett.do_print >= 3:
                    info(sett, "fit-done", t_it)
                _dashboards(run)
                if (sett.checkpoint_every > 0 and sett.checkpoint_path
                        and n_done - last_ckpt >= sett.checkpoint_every):
                    _save_state(run)
                    last_ckpt = n_done
        if run.state.done:
            info(sett, "fit-finish", t00, run.state.n_iter - 1)
    return run.finish()
