"""The system under test, ``unires_torch``, as the window drives it.

A unit of one subject is the program's one-call entry
``pipeline.run.preproc`` (``init``, then the fit and the output as
``pipeline.run.fit`` makes it, without writing files); a unit of B
subjects is ``pipeline.run.preproc_batch`` (each subject's ``init``, then
``parallel.fit_batch.fit_batch`` and the outputs). While a unit runs, the
program's ``init`` and fit functions are wrapped to time the inits and keep
what the judge needs of each subject: the recon volumes, the output grid,
the fitted poses and scales, the registration transforms, the last
objective row and the iterations. A single-observation fit ends by zeroing
the recon outside the observation's field of view (UniRes' ``clean_fov``,
``pipeline.fit.clean_fov``), after its last objective row: the voxels it
changes and the values the fit held there are kept too (``cleaned``), so
that the judge can hold the objective to the volumes it was reported for
and check that every voxel it changed lies outside the field of view. That
capture is harness work: its seconds are left out of the fit's.

Spans are taken here, around calls into the program's layers (the
registration entries that ``init`` calls, the fit chunk's warm-up and
capture), and one chunk of the first fit can be profiled.
"""
from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from unires_torch.ops import cuda_build
from unires_torch.settings import Settings

run_mod = importlib.import_module("unires_torch.pipeline.run")
fit_mod = importlib.import_module("unires_torch.pipeline.fit")
fitloop = importlib.import_module("unires_torch.solvers.fitloop")
batch_mod = importlib.import_module("unires_torch.parallel.fit_batch")


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_kernels(device) -> float:
    """Load (on the first run in a checkout: build) the kernel library;
    returns the seconds its build took (0 when it was there)."""
    if torch.device(device).type != "cuda":
        return 0.0
    cuda_build.kernels.get()
    return float(cuda_build.kernels.build_seconds or 0.0)


def settings(config, device, max_iter=None) -> Settings:
    kw = dict(config["settings"])
    if max_iter is not None:
        kw["max_iter"] = int(max_iter)
    return Settings(device=device, do_print=0, write_out=False, **kw)


def run_unit(config, subjects, device, max_iter=None):
    """One unit: (init seconds, fit seconds, per-subject outputs). The fit
    seconds are the unit's less its inits and the FOV clean's capture."""
    inits, fits, t_init, t_kept, cleaned = [], [], [0.0], [0.0], {}
    init, fit_one, fit_many = run_mod.init, run_mod._fit, batch_mod.fit_batch
    clean_fov = fit_mod.clean_fov

    def timed_init(*args, **kw):
        sync(device)
        t0 = time.perf_counter()
        out = init(*args, **kw)
        sync(device)
        t_init[0] += time.perf_counter() - t0
        inits.append(out)
        return out

    def kept_fit(*args, **kw):
        fits.append(fit_one(*args, **kw))
        return fits[-1]

    def kept_fits(*args, **kw):
        res = fit_many(*args, **kw)
        fits.extend(res)
        return res

    def kept_clean(x, y):
        sync(device)
        t0 = time.perf_counter()
        before = [yc.dat.clone() for yc in y]
        sync(device)
        t1 = time.perf_counter()
        clean_fov(x, y)
        sync(device)
        t2 = time.perf_counter()
        idx = [torch.nonzero((b != yc.dat).reshape(-1)).reshape(-1)
               for b, yc in zip(before, y)]
        cleaned[id(y)] = [(i, b.reshape(-1)[i]) for i, b in zip(idx, before)]
        sync(device)
        t_kept[0] += t1 - t0 + time.perf_counter() - t2

    run_mod.init, run_mod._fit, batch_mod.fit_batch = (
        timed_init, kept_fit, kept_fits)
    fit_mod.clean_fov = kept_clean
    try:
        sett = settings(config, device, max_iter)
        sync(device)
        t0 = time.perf_counter()
        if len(subjects) == 1:
            run_mod.preproc(subjects[0]["inputs"], sett)
        else:
            run_mod.preproc_batch([s["inputs"] for s in subjects], sett)
        sync(device)
        total = time.perf_counter() - t0
    finally:
        run_mod.init, run_mod._fit, batch_mod.fit_batch = (
            init, fit_one, fit_many)
        fit_mod.clean_fov = clean_fov
    return t_init[0], total - t_init[0] - t_kept[0], [
        _outputs(x, st, *f, cleaned=cleaned.get(id(f[0])))
        for (x, _, st), f in zip(inits, fits)]


def _outputs(x, sett, y, R, jtv, obj, n_iter, cleaned=None):
    """What the judge reads of one fitted subject; ``cleaned``: per channel
    the flat indices of the voxels that the FOV clean zeroed and the fit's
    values there, or None."""
    obs = [o for xc in x for o in xc]
    chan = [c for c, xc in enumerate(x) for _ in xc]
    obj = np.asarray(obj, np.float64).reshape(-1, 3)
    return dict(
        ys=torch.stack([yc.dat for yc in y]).detach().clone(),
        mat_y=np.array(y[0].mat, np.float64), dim_y=tuple(y[0].dim),
        scls=[float(o.po.scl) for o in obs],
        rigids=[np.array(r, np.float64) for r in R], chan=chan,
        mat_coreg=(None if sett.mat_coreg is None
                   else np.array(sett.mat_coreg, np.float64)),
        mat_atlas=(None if sett.mat_atlas is None
                   else np.array(sett.mat_atlas, np.float64)),
        obj_last=obj[-1].tolist() if len(obj) else None,
        n_iter=int(n_iter), max_iter=int(sett.max_iter), cleaned=cleaned)


class Spans:
    """Seconds of the calls into the program's layers, by span name, while
    installed: ``registration.coreg`` (``affine_align``),
    ``registration.atlas`` (``atlas_align``), ``fit.capture`` (the fit
    chunk's warm-up of every branch and its capture, device included)."""

    def __init__(self, device):
        self.device = device
        self.s = {"registration.coreg": [], "registration.atlas": [],
                  "fit.capture": []}
        self._saved = []

    def _wrap(self, owner, attr, name, synced):
        fn = getattr(owner, attr)
        spans, device = self.s[name], self.device

        def timed(*args, **kw):
            if synced:
                sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if synced:
                sync(device)
            spans.append(time.perf_counter() - t0)
            return out

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def install(self):
        # the registration entries return host matrices: nothing to wait for
        self._wrap(run_mod, "affine_align", "registration.coreg", False)
        self._wrap(run_mod, "atlas_align", "registration.atlas", False)
        self._wrap(fitloop.FitChunk, "_capture", "fit.capture", True)
        return self

    def remove(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []


class ChunkProfile:
    """Profiles the ``index``-th chunk (0 based) of the next fit: the
    chunk's launch and its one read, under ``torch.profiler``, with the
    subject-iterations it ran."""

    def __init__(self, device, index=1):
        self.device, self.index = device, index
        self.result = None
        self._calls = 0
        self._saved = []

    def _wrap(self, cls, iters_of):
        fn = cls.step
        me = self

        def step(run, *args, **kw):
            i = me._calls
            me._calls += 1
            if i != me.index or me.result is not None:
                return fn(run, *args, **kw)
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.device(me.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            before = iters_of(run)
            prof = profile(activities=acts)
            sync(me.device)
            prof.start()
            t0 = time.perf_counter()
            out = fn(run, *args, **kw)
            sync(me.device)
            t1 = time.perf_counter()
            prof.stop()
            me.result = dict(prof=prof, wall_s=t1 - t0,
                             iters=iters_of(run) - before)
            return out

        self._saved.append((cls, fn))
        cls.step = step

    def install(self):
        self._wrap(fit_mod.FitRun, lambda run: len(run.obj_trace))
        self._wrap(batch_mod.BatchRun,
                   lambda run: sum(len(t) for t in run.traces))
        return self

    def remove(self):
        for cls, fn in reversed(self._saved):
            cls.step = fn
        self._saved = []
