"""unires_torch.solvers against unires_tpu.solvers.

One ADMM iteration (ys, z, w, objective) from identical state, carried into
the port by unires_torch.pipeline.convert, for each preconditioner; the
batched CG; the standalone objective. Tolerance: relative L2 1e-4 (CG over
float32 inner products in another summation order; the port sums the
objective in float64 where JAX uses compensated float32 sums).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unires_tpu
from __graft_entry__ import _tiny_problem
from unires_torch.models.forward import obs_dyn_args as t_obs_dyn_args
from unires_torch.pipeline.convert import convert_state
from unires_torch.solvers import admm as tadmm
from unires_torch.solvers.cg import cg_batched as t_cg
from unires_tpu.models.forward import obs_dyn_args as j_obs_dyn_args
from unires_tpu.ops.finite_diff import DtD as j_DtD
from unires_tpu.solvers import admm as jadmm
from unires_tpu.solvers.cg import cg_batched as j_cg

torch.set_num_threads(2)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _problem(precond):
    """Two channels from the tiny graft problem, through the JAX init."""
    po, gt, x_obs, M, Minv = _tiny_problem()
    x0 = np.asarray(x_obs)
    noise = np.random.default_rng(5).normal(0.0, 3.0, x0.shape)
    chans = [[x0, po.mat_x], [(0.7 * x0 + noise).astype(np.float32), po.mat_x]]
    sett = unires_tpu.Settings(vx=1.0, do_coreg=False, do_print=0, max_iter=4,
                               sched_num=0, write_out=False, cgs_max_iter=4,
                               precond=precond)
    return unires_tpu.init(chans, sett)


def _dyn(x, sett, dyn_fn):
    Ms = [[dyn_fn(o.po, sett.method)[0] for o in xc] for xc in x]
    Minvs = [[dyn_fn(o.po, sett.method)[1] for o in xc] for xc in x]
    scls = [[float(o.po.scl) for o in xc] for xc in x]
    taus = [[float(np.float32(o.tau)) for o in xc] for xc in x]
    return Ms, Minvs, scls, taus


@pytest.mark.parametrize("precond", ["dct", "jacobi", "none"])
def test_one_admm_iteration_matches_jax(precond):
    xj, yj, sj = _problem(precond)
    C = len(yj)
    shape = (C, 3) + tuple(yj[0].dim)
    rng = np.random.default_rng(7)
    z0 = rng.normal(0.0, 0.5, shape).astype(np.float32)
    w0 = rng.normal(0.0, 0.5, shape).astype(np.float32)
    lams = [float(np.float32(c.lam)) for c in yj]
    rho = float(np.float32(jadmm.step_size(xj, yj, sj)))

    # JAX
    Ms, Minvs, scls, taus = _dyn(xj, sj, j_obs_dyn_args)
    step = jadmm.make_admm_step(xj, yj, sj)
    ys_j, z_j, w_j, jtv_j, obj_j = step(
        jnp.stack([c.dat for c in yj]), jnp.asarray(z0), jnp.asarray(w0),
        tuple(tuple(o.dat for o in xc) for xc in xj),
        tuple(map(tuple, Ms)), tuple(map(tuple, Minvs)),
        tuple(tuple(jnp.float32(s) for s in r) for r in scls),
        tuple(tuple(jnp.float32(t) for t in r) for r in taus),
        jnp.asarray(lams, jnp.float32), jnp.float32(rho))

    # port, from the same state
    xt, yt, st, z_t, w_t = convert_state(xj, yj, sj, "cpu", z=z0, w=w0)
    assert st.device == "cpu" and st.precond == precond
    assert tadmm.step_size(xt, yt, st) == jadmm.step_size(xj, yj, sj)
    Ms, Minvs, scls, taus = _dyn(xt, st, t_obs_dyn_args)
    tstep = tadmm.make_admm_step(xt, yt, st)
    ys_t, z_t, w_t, jtv_t, obj_t = tstep(
        torch.stack([c.dat for c in yt]), z_t, w_t,
        [[o.dat for o in xc] for xc in xt], Ms, Minvs, scls, taus, lams, rho)

    assert obj_t.dtype == torch.float64
    for got, want in ((ys_t, ys_j), (z_t, z_j), (w_t, w_j), (jtv_t, jtv_j)):
        assert tuple(got.shape) == tuple(want.shape)
        assert _rel(got.numpy(), want) < 1e-4
    np.testing.assert_allclose(obj_t.numpy(), np.asarray(obj_j), rtol=1e-4)


def test_objective_matches_jax():
    xj, yj, sj = _problem("dct")
    lams = [float(np.float32(c.lam)) for c in yj]
    Ms, Minvs, scls, taus = _dyn(xj, sj, j_obs_dyn_args)
    want = jadmm.make_compute_nll(xj, yj, sj)(
        jnp.stack([c.dat for c in yj]),
        tuple(tuple(o.dat for o in xc) for xc in xj),
        tuple(map(tuple, Ms)), tuple(map(tuple, Minvs)),
        tuple(tuple(jnp.float32(s) for s in r) for r in scls),
        tuple(tuple(jnp.float32(t) for t in r) for r in taus),
        jnp.asarray(lams, jnp.float32))
    xt, yt, st = convert_state(xj, yj, sj, "cpu")
    Ms, Minvs, scls, taus = _dyn(xt, st, t_obs_dyn_args)
    got = tadmm.make_compute_nll(xt, yt, st)(
        torch.stack([c.dat for c in yt]), [[o.dat for o in xc] for xc in xt],
        Ms, Minvs, scls, taus, lams)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


@pytest.mark.parametrize("max_iter,tol", [(30, 1e-4), (3, 1e-4), (30, 0.3)])
def test_cg_batched_matches_jax(max_iter, tol):
    dim = (7, 8, 9)
    rng = np.random.default_rng(11)
    d = rng.uniform(0.5, 2.0, (3,) + dim).astype(np.float32)
    b = rng.standard_normal((3,) + dim).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((3,) + dim)).astype(np.float32)
    x0[2] = 0.0
    vx = (1.0, 1.0, 1.0)

    def j_A(V):
        return jnp.asarray(d) * V + 0.3 * jnp.stack(
            [j_DtD(V[c], jnp.asarray(vx)) for c in range(3)])

    from unires_torch.ops.finite_diff import im_divergence, im_gradient

    dt = torch.from_numpy(d)

    def t_A(V):
        return dt * V + 0.3 * torch.stack(
            [im_divergence(im_gradient(V[c], vx), vx) for c in range(3)])

    xj, itj = j_cg(j_A, jnp.asarray(b), jnp.asarray(x0), max_iter=max_iter,
                   tol=tol, precond=lambda v: v / jnp.asarray(d),
                   return_iters=True)
    xt, itt = t_cg(t_A, torch.from_numpy(b), torch.from_numpy(x0),
                   max_iter=max_iter, tol=tol, precond=lambda v: v / dt,
                   return_iters=True)
    assert itt == int(itj)
    assert _rel(xt.numpy(), xj) < 1e-4


def _spd_systems(C=3, n=50, seed=0, shift=1.0):
    """Seeded SPD systems with different conditioning per channel."""
    rng = np.random.default_rng(seed)
    mats, bs, x0s = [], [], []
    for c in range(C):
        Q = rng.standard_normal((n, n))
        mats.append((Q @ Q.T + (shift + 5.0 * c) * np.eye(n)).astype(
            np.float32))
        bs.append(rng.standard_normal(n).astype(np.float32))
        x0s.append(rng.standard_normal(n).astype(np.float32))
    return mats, np.stack(bs), np.stack(x0s)


@pytest.mark.parametrize("stop,precond", [
    ("max_gain", False), ("residual", False), ("max_gain", True),
    ("residual", True)])
def test_cg_matches_jax_cg(stop, precond):
    """The unbatched solver on a seeded SPD system, both stopping rules,
    with and without a Jacobi preconditioner: 1e-5 relative (a condition
    number near 10, so that float32 rounding in the two packages' products
    stays below that over the 12 steps)."""
    from unires_torch.solvers import cg as t_cg1
    from unires_tpu.solvers import cg as j_cg1

    mats, b, x0 = _spd_systems(C=1, seed=3, shift=20.0)
    x0 = 0.02 * x0  # a start of the solution's size: no cancellation
    A, d = mats[0], np.diagonal(mats[0]).copy()
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    Aj, dj = jnp.asarray(A), jnp.asarray(d)
    kw = dict(max_iter=12, tol=1e-3, stop=stop)
    got = t_cg1(lambda v: At @ v, torch.from_numpy(b[0]),
                torch.from_numpy(x0[0]),
                precond=(lambda v: v / dt) if precond else None, **kw)
    want = j_cg1(lambda v: Aj @ v, jnp.asarray(b[0]), jnp.asarray(x0[0]),
                 precond=(lambda v: v / dj) if precond else None, **kw)
    assert _rel(got.numpy(), want) < 1e-5
    # and it solved something: the residual fell
    r0 = np.linalg.norm(b[0] - A @ x0[0])
    assert np.linalg.norm(b[0] - A @ got.numpy()) < 0.1 * r0


def test_cg_residual_stop_exits_early_on_a_converged_start():
    from unires_torch.solvers import cg as t_cg1
    from unires_torch.utils.host import to_host

    mats, b, _ = _spd_systems(C=1, seed=4)
    A = torch.from_numpy(mats[0].astype(np.float64))
    x_star = torch.linalg.solve(A, torch.from_numpy(b[0]).double())
    n0 = to_host.syncs
    got = t_cg1(lambda v: A @ v, torch.from_numpy(b[0]).double(), x_star,
                max_iter=20, tol=1e-3, stop="residual")
    assert to_host.syncs - n0 == 1  # one step, one stop test
    assert _rel(got.numpy(), x_star.numpy()) < 1e-6


@pytest.mark.parametrize("c", [0, 1, 2])
def test_cg_batched_entry_follows_cg(c):
    """Each batch entry of cg_batched follows the trajectory the port's
    residual-stop cg gives it alone (tests/test_cg.py:46-70)."""
    from unires_torch.solvers import cg as t_cg1

    mats, b, x0 = _spd_systems()
    ms = [torch.from_numpy(m) for m in mats]
    d = torch.stack([torch.diagonal(m) for m in ms])
    got = t_cg(lambda V: torch.stack([ms[k] @ V[k] for k in range(3)]),
               torch.from_numpy(b), torch.from_numpy(x0), max_iter=30,
               tol=1e-3, precond=lambda V: V / d)
    want = t_cg1(lambda v: ms[c] @ v, torch.from_numpy(b[c]),
                 torch.from_numpy(x0[c]), max_iter=30, tol=1e-3,
                 precond=lambda v: v / d[c], stop="residual")
    np.testing.assert_allclose(got[c].numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)
