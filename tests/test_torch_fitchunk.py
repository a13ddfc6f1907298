"""The port's fit chunk (``unires_torch.solvers.fitloop.make_fit_chunk``)
against the JAX package's ``make_fit_chunk``, and against itself.

One misaligned problem (16x16x18): one channel, two repeats thick along z
and x, each with its own rigid misalignment and even/odd scaling 0.1 (with
one observation per channel a pose is barely identifiable early on, and
every line search rejects), no co-registration. It is initialised by the
JAX pipeline, with the true image resliced onto the recon grid as the start
so that the rigid updates move the poses from their first round, and
carried into the port by ``convert_state``, so that both chunks start from
the same volumes, poses and geometry. Scaling and unified rigid are on
(rigid from the second iteration).

Tolerances, those of tests/test_torch_gn.py for the loop's updates: the
objective trace rtol 1e-4 (the JAX package sums in float32, the port in
float64), the gains atol 1e-4 (ratios of objective differences), the poses
and scales rtol 1e-4 with an absolute floor of 1e-6 (mm, rad); counters,
``done`` and ``valid`` exactly. On the CPU the chunk runs uncaptured, so a
chunk of 4 and four chunks of 1 are the same operations: bitwise equal. The
device stop of ``cg_batched`` is held bitwise against the host loop it
replaced, written out below.
"""
import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

import unires_tpu
from phantoms import blob_phantom, degrade
from unires_torch.ops.resample import affine_to_M, pull
from unires_torch.pipeline.convert import convert_state
from unires_torch.pipeline.fit import get_sched as t_get_sched
from unires_torch.solvers.cg import cg_batched
from unires_torch.solvers.fitloop import init_state as t_init_state
from unires_torch.solvers.fitloop import make_fit_chunk as t_make_fit_chunk
from unires_torch.utils.host import to_host
from unires_tpu.pipeline.fit import _gather_dyn_taus, _gather_subdats
from unires_tpu.pipeline.fit import get_sched as j_get_sched
from unires_tpu.solvers.fitloop import init_state as j_init_state
from unires_tpu.solvers.fitloop import make_fit_chunk as j_make_fit_chunk

torch.set_num_threads(2)

K = 3
RSCL = 4.0
KW = dict(vx=1.0, do_coreg=False, do_print=0, max_iter=10, tolerance=0,
          write_out=False, unified_rigid=True, scaling=True, sched_num=0,
          reg_scl=RSCL)
POSES = ([0.9, -0.5, 0.4, 0.02, -0.01, 0.015],
         [-0.8, 0.6, -0.3, -0.015, 0.01, -0.01])
# a state on the last schedule step, past the 20 iterations the convergence
# test waits for, at the last iteration before max_iter (which passes the
# gain test) and one countdown step from done: it converges at its first
# iteration, and the rest of the chunk is frozen
NEAR_DONE = dict(cnt_scl_iter=25, countdown0=1, has_prev=True,
                 n_iter=KW["max_iter"] - 1)


def _close(got, want, rtol=1e-4, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def problem():
    gt = blob_phantom(dim=(16, 16, 18), amplitude=1000.0, seed=5)
    repeats = []
    for ax, seed, rp in zip((2, 0), (11, 22), POSES):
        x, mat, _ = degrade(gt, thick_axis=ax, thick=4.0, noise_sd=30.0,
                            seed=seed, scl=0.1, rigid_params=rp)
        repeats.append([x, mat])
    xj, yj, sj = unires_tpu.init([repeats], unires_tpu.Settings(**KW))
    on_grid = pull(torch.from_numpy(gt), affine_to_M(yj[0].mat),
                   tuple(int(d) for d in yj[0].dim)).numpy()
    for yc in yj:
        yc.dat = jnp.asarray(on_grid)
    sj = j_get_sched(2, sj)
    xt, yt, st = convert_state(xj, yj, sj, "cpu")
    st = t_get_sched(2, st)
    return (xj, yj, sj), (xt, yt, st)


@pytest.fixture(scope="module")
def jax_chunk(problem):
    xj, yj, sj = problem[0]
    chunk = j_make_fit_chunk(xj, yj, sj, K)
    args = (tuple(tuple(o.dat for o in xc) for xc in xj),
            _gather_dyn_taus(xj), _gather_subdats(xj, sj))
    return chunk, args


def _j_state(problem, **kw):
    xj, yj, sj = problem[0]
    st = j_init_state(xj, yj, sj)
    return st._replace(**{k: (jnp.bool_(v) if isinstance(v, bool)
                              else jnp.int32(v)) for k, v in kw.items()})


def _t_run(problem, n_calls, K_, **kw):
    """n_calls chunks of K_ iterations of the port from the problem's init
    (state scalars ``kw``); returns (state, chunk, stacked objs, gains,
    valid)."""
    xt, yt, st = copy.deepcopy(problem[1])
    chunk = t_make_fit_chunk(xt, yt, st, K_)
    state = t_init_state(xt, yt, st, **kw)
    xdats = [[o.dat for o in xc] for xc in xt]
    outs = []
    for _ in range(n_calls):
        _, objs, gains, valid = chunk(state, xdats, [None] * 2)
        outs.append((objs.clone(), gains.clone(), valid.clone()))
    objs, gains, valid = (torch.cat(t) for t in zip(*outs))
    return state, chunk, objs, gains, valid


def _tensors(state):
    return {k: v for k, v in vars(state).items()
            if isinstance(v, torch.Tensor)}


@pytest.fixture(scope="module")
def chunks(problem, jax_chunk):
    chunk, args = jax_chunk
    stj, objs_j, gains_j, valid_j = chunk(_j_state(problem), *args)
    port = _t_run(problem, 1, K)
    return (stj, objs_j, gains_j, valid_j), port


def test_chunk_matches_jax(chunks):
    (stj, objs_j, gains_j, valid_j), (st, chunk, objs, gains, valid) = chunks
    assert objs.shape == (K, 3) and objs.dtype == torch.float64
    np.testing.assert_allclose(objs.numpy(), np.asarray(objs_j, np.float64),
                               rtol=1e-4)
    assert objs[-1, 0] < objs[0, 0]
    np.testing.assert_allclose(gains.numpy(), np.asarray(gains_j, np.float64),
                               atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert int(st.n_iter) == int(stj.n_iter) == K
    assert bool(st.done) == bool(stj.done) is False
    assert float(np.abs(st.q.numpy()).max()) > 0.05  # the poses moved
    _close(st.q.numpy(), stj.q)
    _close(st.scl.numpy(), stj.scl)


def test_chunk_reads_the_host_once(problem, chunks):
    """``read`` packs the chunk's outputs and the state into one read, and
    equals the tensors it read."""
    _, (st, chunk, objs, gains, valid) = chunks
    n0 = to_host.syncs
    out = chunk.read(st, K)
    assert to_host.syncs == n0 + 1
    np.testing.assert_array_equal(out["objs"], objs.numpy())
    np.testing.assert_array_equal(out["gains"], gains.numpy())
    np.testing.assert_array_equal(out["valid"], valid.numpy())
    np.testing.assert_array_equal(out["q"], st.q.numpy())
    np.testing.assert_array_equal(out["scl"], st.scl.numpy())
    assert (out["n_iter"], out["done"]) == (K, False)
    assert st.host["n_iter"] == K and st.host["q"] is out["q"]


def test_one_chunk_of_4_equals_four_chunks_of_1(problem):
    st4, _, objs4, gains4, valid4 = _t_run(problem, 1, 4)
    st1, _, objs1, gains1, valid1 = _t_run(problem, 4, 1)
    assert torch.equal(objs4, objs1) and torch.equal(gains4, gains1)
    assert torch.equal(valid4, valid1) and bool(valid4.all())
    t4, t1 = _tensors(st4), _tensors(st1)
    for k in t4:
        assert torch.equal(t4[k], t1[k]), k


def test_converging_chunk_freezes_like_jax(problem, jax_chunk):
    """Converged at its first iteration: the other two are frozen in both
    packages (not valid), and leave the port's state bitwise as the first
    left it."""
    chunk, args = jax_chunk
    near = dict(NEAR_DONE, cnt_scl=int(np.asarray(problem[0][2].reg_scl).size)
                - 1)
    stj, _, _, valid_j = chunk(_j_state(problem, **near), *args)
    st, _, _, _, valid = _t_run(problem, 1, K, **near)
    st1, _, _, _, valid1 = _t_run(problem, 1, 1, **near)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(valid.numpy(), [True, False, False])
    assert bool(st.done) and bool(stj.done)
    assert int(st.n_iter) == int(stj.n_iter) == KW["max_iter"]
    assert bool(valid1.all()) and bool(st1.done)
    t3, t1 = _tensors(st), _tensors(st1)
    for k in t3:
        assert torch.equal(t3[k], t1[k]), k


def test_chunk_hooks_take_host_values(problem):
    """The per-observation updates take numpy poses and float scales, as
    the tests of tests/test_torch_gn.py call them, and give tensors."""
    xt, yt, st = copy.deepcopy(problem[1])
    chunk = t_make_fit_chunk(xt, yt, st, 1)
    q0 = np.array([0.3, -0.2, 0.1, 0.004, -0.003, 0.002])
    Ms, Minvs = chunk.maps(np.stack([q0, -q0]))
    assert Ms[0][1].shape == (3, 4) and Ms[0][1].dtype == torch.float32
    ys = yt[0].dat
    s = chunk.scaling_obs(ys, xt[0][0].dat, Ms[0][0], 0.05, 0)
    delta, ll = chunk.rigid_stats(ys, xt[0][0].dat, q0, 0.05, 0)
    q1 = chunk.rigid_ls(ys, xt[0][0].dat, q0, 0.05, 0, delta, ll)
    assert s.dtype == delta.dtype == q1.dtype == torch.float64
    assert delta.shape == q1.shape == (6,) and ll.dim() == 0
    assert bool(torch.isfinite(delta).all())


# --- the CG stop on the device -------------------------------------------------

def _host_loop_cg(A, b, x0, max_iter, tol, precond):
    """The loop cg_batched ran before the stop moved to the device: one host
    read of live.any() per step."""
    axes = tuple(range(1, b.dim()))

    def dot(a, c):
        return torch.sum(a * c, dim=axes)

    def bc(s):
        return s.reshape(s.shape + (1,) * (b.dim() - 1))

    tiny = 1e-30
    x = x0
    r = b - A(x)
    p = precond(r)
    rz = dot(r, p)
    ref = (tol * tol) * torch.clamp(dot(b, precond(b)), min=tiny)
    live = torch.ones(b.shape[0], dtype=torch.bool)
    it = 0
    while it < max_iter and bool(live.any()):
        Ap = A(p)
        pAp = dot(p, Ap)
        alpha = torch.where(live, rz / torch.clamp(pAp, min=tiny), 0.0)
        x = x + bc(alpha) * p
        r = r - bc(alpha) * Ap
        z = precond(r)
        rz_new = torch.where(live, dot(r, z), rz)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = torch.where(bc(live), z + bc(beta) * p, p)
        live = live & (rz_new >= ref)
        rz = rz_new
        it += 1
    return x, it


@pytest.mark.parametrize("max_iter,tol,precond", [
    (30, 1e-4, "diag"), (4, 1e-4, "diag"), (30, 0.2, "diag"),
    (30, 1e-4, "none")])
def test_cg_device_stop_equals_host_loop(max_iter, tol, precond):
    from unires_torch.ops.finite_diff import im_divergence, im_gradient

    rng = np.random.default_rng(3)
    dim = (7, 8, 9)
    d = torch.from_numpy(rng.uniform(0.5, 2.0, (3,) + dim).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3,) + dim).astype(np.float32))
    x0 = torch.from_numpy(
        (0.1 * rng.standard_normal((3,) + dim)).astype(np.float32))
    x0[2] = 0.0
    vx = (1.0, 1.0, 1.0)

    def A(V):
        return d * V + 0.3 * torch.stack(
            [im_divergence(im_gradient(V[c], vx), vx) for c in range(3)])

    P = (lambda v: v / d) if precond == "diag" else (lambda v: v)
    want, it_want = _host_loop_cg(A, b, x0, max_iter, tol, P)
    got, it_got = cg_batched(A, b, x0, max_iter=max_iter, tol=tol,
                             precond=P if precond == "diag" else None,
                             return_iters=True)
    assert torch.equal(got, want)
    assert int(it_got) == it_want and (it_want < max_iter or max_iter == 4)


def test_fit_reads_the_host_once_per_chunk(problem):
    """A fit of 6 iterations in chunks of 4: two chunks, each read once."""
    fit_mod = importlib.import_module("unires_torch.pipeline.fit")

    xt, yt, st = copy.deepcopy(problem[1])
    st.max_iter, st.chunk_iters = 6, 4
    n0 = to_host.syncs
    _, _, _, obj, n = fit_mod.fit(xt, yt, st)
    assert to_host.syncs - n0 > 6  # on the CPU every decision is read
    assert n == 6 and obj.shape == (6, 3)
    xt, yt, st = copy.deepcopy(problem[1])
    st.max_iter, st.chunk_iters = 6, 4
    run = fit_mod.FitRun(xt, yt, st)
    run.launch()
    n0 = to_host.syncs
    rows = run.collect()
    assert to_host.syncs == n0 + 1 and len(rows) == 4 and run.n_iter == 4
    run.launch()
    assert len(run.collect()) == 2 and not run.live


class _NoHostRead(TorchDispatchMode):
    """Fails on every operation that reads a tensor's value on the host or
    makes a tensor from host values: a captured graph could hold none."""

    READS = (torch.ops.aten._local_scalar_dense.default,
             torch.ops.aten.nonzero.default, torch.ops.aten.is_nonzero.default,
             torch.ops.aten.equal.default, torch.ops.aten.lift_fresh.default)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"a host read inside the iteration: {func}")
        return func(*args, **(kwargs or {}))


def test_iteration_reads_nothing_but_its_decisions(problem, monkeypatch):
    """Three iterations (rigid and scaling on) under a mode that fails on
    any host read: the only reads are ``utils.graph.cond``'s, which a
    captured graph takes on the device."""
    from unires_torch.utils import graph as ugraph

    def decision(t):
        with _disable_current_modes():
            return to_host(t)

    monkeypatch.setattr(ugraph, "to_host", decision)
    xt, yt, st = copy.deepcopy(problem[1])
    chunk = t_make_fit_chunk(xt, yt, st, 3)
    state = t_init_state(xt, yt, st)
    xdats = [[o.dat for o in xc] for xc in xt]
    with _NoHostRead():
        for _ in range(3):
            chunk.iterate(state, xdats, [None, None])
    assert int(state.n_iter) == 3 and float(state.q.abs().max()) > 0.05
