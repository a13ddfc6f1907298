"""Faults planted under the timed path, by name, to show that ``correct``
catches them: each is a context manager that patches the program while it
is open and restores it on exit. None of them touches what the program
reports of its own answer: the fit's objective is still that of the
volumes, poses and scales it returns, so only the numbers held against the
truth (``judge.py``) can see them.

``solve_unchanged``
    the ADMM y-step's conjugate-gradient solve returns its initial guess:
    the volumes stay at their initial reslice.
``rigid_skipped``
    the Gauss-Newton rigid round is skipped: the poses stay where
    co-registration left them.
``scaling_skipped``
    the Gauss-Newton even / odd scaling step returns its scale unchanged.
``push_volume_zeroed``
    a batched push launch returns its second volume as zeros (a batch of
    subjects' adjoint drops one subject).
``atlas_skipped``
    atlas alignment returns the identity (the subject stays in its scanner
    frame on the atlas grid).
``half_batch``
    the batched fit fits the first half of the batch and returns its
    answers for the rest too.
``answer_altered``
    the first channel of the answer is scaled by 1.001 after the fit.
``fov_inside_zeroed``
    the FOV clean of a single-observation fit also zeroes a block of 4 x 4
    x 4 voxels at the centre of the recon grid, inside the field of view.
"""
from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

FAULTS = {}


def fault(fn):
    FAULTS[fn.__name__] = contextlib.contextmanager(fn)
    return FAULTS[fn.__name__]


def _patched(owner, attr, new):
    old = getattr(owner, attr)
    setattr(owner, attr, new)
    try:
        yield
    finally:
        setattr(owner, attr, old)


def _mod(name):
    return importlib.import_module("unires_torch." + name)


@fault
def solve_unchanged():
    def cg_batched(A, b, x0, *args, return_iters=False, **kw):
        x = x0.clone()
        return (x, x.new_zeros((), dtype=torch.int64)) if return_iters else x

    yield from _patched(_mod("solvers.admm"), "cg_batched", cg_batched)


@fault
def rigid_skipped():
    def _rigid_round(self, v, xdats, subdats, mask):
        return None

    yield from _patched(_mod("solvers.fitloop").FitChunk, "_rigid_round",
                        _rigid_round)


@fault
def scaling_skipped():
    def _scaling(self, ys_c, dat_x, M, s0, i, live=None):
        return s0.clone()

    yield from _patched(_mod("solvers.fitloop").FitChunk, "_scaling",
                        _scaling)


@fault
def push_volume_zeroed():
    forward = _mod("models.forward")
    push = forward.push

    def zeroed(vals, *args, **kw):
        out = push(vals, *args, **kw)
        if out.dim() == 4 and out.shape[0] > 1:
            out[1].zero_()
        return out

    yield from _patched(forward, "push", zeroed)


@fault
def atlas_skipped():
    def atlas_align(*args, **kw):
        return np.eye(4)

    yield from _patched(_mod("pipeline.run"), "atlas_align", atlas_align)


@fault
def half_batch():
    batch = _mod("parallel.fit_batch")
    fit_batch = batch.fit_batch

    def half(xs, ys, sett, **kw):
        h = max(1, len(xs) // 2)
        res = fit_batch(xs[:h], ys[:h], sett, **kw)
        return (res * len(xs))[:len(xs)]

    yield from _patched(batch, "fit_batch", half)


@fault
def answer_altered():
    fit = _mod("pipeline.fit")
    finish = fit.FitRun.finish

    def altered(self, clean=True):
        y, R, jtv, trace, n = finish(self, clean)
        y[0].dat = y[0].dat * 1.001
        return y, R, jtv, trace, n

    yield from _patched(fit.FitRun, "finish", altered)



@fault
def fov_inside_zeroed():
    fit = _mod("pipeline.fit")
    clean_fov = fit.clean_fov

    def zeroed(x, y):
        clean_fov(x, y)
        for yc in y:
            i, j, k = (n // 2 - 2 for n in yc.dat.shape)
            yc.dat[i:i + 4, j:j + 4, k:k + 4] = 0.0

    yield from _patched(fit, "clean_fov", zeroed)
