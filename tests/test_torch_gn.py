"""The port's even/odd scaling and rigid Gauss-Newton updates against the
JAX package's, and against the oracles of tests/test_gn_updates.py.

Each problem is made once by the JAX pipeline (``_problem`` of
tests/test_gn_updates.py) and carried into the port by ``convert_state``, so
both packages start from the same volumes and geometry. Tolerances: sums
and moments rtol 1e-4 (the JAX package sums in float32, the port in
float64); the fit loop's g, H, GN step and line-searched pose rtol 1e-4
(measured: g 7e-5, H 3e-5, step 1.4e-5, pose 1e-5 relative to the largest
entry, for an observation thick along each of the three axes); the host
updates' scales and poses rtol 1e-3 with an absolute floor of 1e-4 (mm or
rad) for the near-zero entries; the oracles as in
tests/test_gn_updates.py (scale to 0.01, pose to 0.05 mm / 2e-3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantoms import blob_phantom, degrade
from unires_torch.geometry import affine_matrix_classic
from unires_torch.models.forward import obs_dyn_args
from unires_torch.ops.resample import pull
from unires_torch.pipeline.convert import convert_state
from unires_torch.solvers import rigid as trig
from unires_torch.solvers import scaling_gn as tsc
from unires_torch.solvers.fitloop import make_fit_chunk as t_make_fit_chunk
from unires_tpu import Settings, init
from unires_tpu.pipeline.fit import get_sched
from unires_tpu.solvers import rigid as jrig
from unires_tpu.solvers import scaling_gn as jsc
from unires_tpu.solvers.admm import obs_dyn_args as j_obs_dyn_args
from unires_tpu.solvers.fitloop import make_fit_chunk

torch.set_num_threads(2)
RIGID_TRUE = [1.0, -0.8, 0.6, 0.015, -0.01, 0.012]


def _problem(scl_true=0.0, rigid_true=None, noise=20.0, dim=(32, 32, 33),
             seed=0, thick_axis=2):
    """(gt, JAX x, y, sett, port x, y, sett) of tests/test_gn_updates.py."""
    gt = blob_phantom(dim=dim, amplitude=1000.0, seed=seed)
    x_obs, mat_x, _ = degrade(gt, thick_axis=thick_axis, thick=4.0,
                              noise_sd=noise,
                              scl=scl_true, rigid_params=rigid_true,
                              seed=seed)
    sett = Settings(vx=1.0, do_coreg=False, do_print=0, max_iter=6,
                    tolerance=1e-4, sched_num=0, reg_scl=4.0, write_out=False,
                    scaling=False, unified_rigid=False)
    xj, yj, sj = init([[x_obs, mat_x]], sett)
    xt, yt, st = convert_state(xj, yj, sj, "cpu")
    return gt, (xj, yj, sj), (xt, yt, st)


def _close(got, want, rtol=1e-3, atol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


# --- scaling ----------------------------------------------------------------

def test_scaling_stats_match_jax():
    _, (xj, yj, sj), (xt, yt, st) = _problem(scl_true=0.12)
    oj, ot = xj[0][0], xt[0][0]
    pj, sj_fn, llj = jsc.make_scaling_fns(oj.po, sj.method)
    pt, st_fn, llt = tsc.make_scaling_fns(ot.po, st.method)
    Mj, _ = j_obs_dyn_args(oj.po, sj.method, oj.po.rigid)
    Mt, _ = obs_dyn_args(ot.po, st.method, ot.po.rigid)
    y0j = pj(yj[0].dat, Mj)
    y0t = pt(yt[0].dat, Mt)
    np.testing.assert_allclose(y0t.numpy(), np.asarray(y0j), rtol=1e-5,
                               atol=1e-5 * float(np.abs(y0j).max()))
    tau = float(np.float32(oj.tau))
    for s in (0.0, 0.04, -0.07):
        want = [float(v) for v in sj_fn(y0j, oj.dat, jnp.float32(s),
                                        jnp.float32(tau))]
        np.testing.assert_allclose(st_fn(y0t, ot.dat, s, tau), want,
                                   rtol=1e-4)
        np.testing.assert_allclose(
            llt(y0t, ot.dat, s, tau),
            float(llj(y0j, oj.dat, jnp.float32(s), jnp.float32(tau))),
            rtol=1e-4)


def test_update_scaling_matches_jax():
    _, (xj, yj, sj), (xt, yt, st) = _problem(scl_true=0.15, noise=5.0)
    for _ in range(2):
        xj, llj = jsc.update_scaling(xj, yj, sj)
        xt, llt = tsc.update_scaling(xt, yt, st)
        _close(xt[0][0].po.scl, xj[0][0].po.scl)
        assert llt == pytest.approx(llj, rel=1e-4)


def test_update_scaling_matches_jax_at_a_pose():
    """At a non-zero rigid_q both packages project through the uncentred
    expm(q) (the centre-conjugated pose moves the volume ~0.9 mm here)."""
    _, (xj, yj, sj), (xt, yt, st) = _problem(scl_true=0.15, noise=5.0)
    q = np.array([0.5, -0.3, 0.2, 0.03, -0.02, 0.025])
    xj[0][0].rigid_q, xt[0][0].rigid_q = q.copy(), q.copy()
    for _ in range(2):
        xj, llj = jsc.update_scaling(xj, yj, sj)
        xt, llt = tsc.update_scaling(xt, yt, st)
        _close(xt[0][0].po.scl, xj[0][0].po.scl)
        assert llt == pytest.approx(llj, rel=1e-4)


def test_scaling_gradient_matches_finite_difference():
    _, _, (x, y, sett) = _problem(scl_true=0.12)
    o = x[0][0]
    project, stats, ll_at = tsc.make_scaling_fns(o.po, sett.method)
    M, _ = obs_dyn_args(o.po, sett.method, o.po.rigid)
    dat_y0 = project(y[0].dat, M)
    s0, eps, tau = 0.04, 1e-3, float(o.tau)
    ll, gr, hes = stats(dat_y0, o.dat, s0, tau)
    fd = (ll_at(dat_y0, o.dat, s0 + eps, tau)
          - ll_at(dat_y0, o.dat, s0 - eps, tau)) / (2 * eps)
    assert abs(gr - fd) < 0.05 * max(abs(fd), 1.0), (gr, fd)
    assert hes > 0


def test_scaling_update_recovers_true_scale():
    scl_true = 0.15
    gt, _, (x, y, sett) = _problem(scl_true=scl_true, noise=5.0)
    y[0].dat = torch.from_numpy(gt)
    for _ in range(3):
        x, _ = tsc.update_scaling(x, y, sett, max_niter_gn=1,
                                  num_linesearch=6)
    assert abs(x[0][0].po.scl - scl_true) < 0.01, x[0][0].po.scl


# --- rigid ------------------------------------------------------------------

def test_rigid_moments_and_assembly_match_jax():
    gt, (xj, yj, sj), (xt, yt, st) = _problem(rigid_true=RIGID_TRUE,
                                              noise=5.0)
    oj, ot = xj[0][0], xt[0][0]
    msj, _, cj = jrig.make_rigid_fns(oj.po, sj.method)
    mst, mllt, ct = trig.make_rigid_fns(ot.po, st.method)
    assert cj == ct
    M = trig.affine_to_M(np.linalg.solve(ot.po.mat_y, ot.po.mat_yx))
    tau = float(np.float32(oj.tau))
    want = [np.asarray(v, np.float64) for v in msj(
        oj.dat, jnp.asarray(gt), jnp.asarray(M), jnp.float32(0.0),
        jnp.float32(tau))]
    got = mst(ot.dat, torch.from_numpy(gt), M, 0.0, tau)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())
    assert mllt(ot.dat, torch.from_numpy(gt), M, 0.0, tau) == \
        pytest.approx(got[0], rel=1e-12)
    # the assembly from the same moments: both float64 on the host
    dRq = list(np.random.default_rng(0).normal(size=(6, 4, 4)))
    gj, Hj = jrig._assemble(*want[1:], dRq, cj)
    gt_, Ht = trig._assemble(*want[1:], dRq, ct)
    np.testing.assert_allclose(gt_, gj, rtol=1e-10, atol=1e-10 * np.abs(gj).max())
    np.testing.assert_allclose(Ht, Hj, rtol=1e-10, atol=1e-10 * np.abs(Hj).max())


def test_update_rigid_matches_jax():
    gt, (xj, yj, sj), (xt, yt, st) = _problem(rigid_true=RIGID_TRUE,
                                              noise=5.0)
    yj[0].dat = jnp.asarray(gt)
    yt[0].dat = torch.from_numpy(gt)
    for _ in range(2):
        xj, llj = jrig.update_rigid(xj, yj, sj, mean_correct=False,
                                    num_linesearch=6, samp=0)
        xt, llt = trig.update_rigid(xt, yt, st, mean_correct=False,
                                    num_linesearch=6, samp=0)
        _close(xt[0][0].rigid_q, xj[0][0].rigid_q)
        assert llt == pytest.approx(llj, rel=1e-3)


def test_rigid_update_recovers_true_pose():
    gt, _, (x, y, sett) = _problem(rigid_true=RIGID_TRUE, noise=5.0)
    y[0].dat = torch.from_numpy(gt)
    lls = []
    for _ in range(6):
        x, ll = trig.update_rigid(x, y, sett, mean_correct=False,
                                  max_niter_gn=1, num_linesearch=6, samp=0)
        lls.append(ll)
    assert lls[-1] < 0.5 * lls[0], lls
    R_est = x[0][0].po.rigid
    R_true = affine_matrix_classic(RIGID_TRUE)
    assert np.allclose(R_est[:3, 3], R_true[:3, 3], atol=0.05), R_est
    assert np.allclose(R_est[:3, :3], R_true[:3, :3], atol=2e-3)


def test_rigid_mean_correction():
    _, _, (x, y, sett) = _problem()
    x[0][0].rigid_q = np.array([1.0, 2.0, 3.0, 0.01, 0.02, 0.03])
    x, _ = trig.update_rigid(x, y, sett, mean_correct=True, max_niter_gn=0,
                             num_linesearch=0, samp=0)
    assert np.allclose(x[0][0].rigid_q, 0.0, atol=1e-12)
    np.testing.assert_allclose(x[0][0].po.rigid, np.eye(4), atol=1e-12)


# --- the fit loop's per-observation updates ------------------------------------

@pytest.fixture(scope="module", params=[0, 1, 2], ids="thick{}".format)
def loop_updates(request):
    """One rigid and one scaling update of the fit loop, in both packages, at
    a nonzero pose and scale, on the true image resliced onto the recon grid,
    for an observation thick along each axis."""
    gt, (xj, yj, sj), (xt, yt, st) = _problem(scl_true=0.1,
                                              rigid_true=RIGID_TRUE,
                                              noise=5.0,
                                              thick_axis=request.param)
    assert xt[0][0].po.dim_thick == request.param
    # the phantom lives on the identity affine; the recon grid is cropped
    # along the thick axis
    gt = pull(torch.from_numpy(gt), trig.affine_to_M(yt[0].mat),
              tuple(int(d) for d in yt[0].dim)).numpy()
    q0 = np.array([0.3, -0.2, 0.1, 0.004, -0.003, 0.002])
    s0 = 0.05
    out = {}
    for pkg, (x, y, s) in (("jax", (xj, yj, sj)), ("torch", (xt, yt, st))):
        s.unified_rigid = True  # format_y turns it off for one image
        s.scaling = True
        get_sched(1, s)
    chunk = make_fit_chunk(xj, yj, sj, 1)
    dbg = chunk._debug
    tau = float(np.float32(xj[0][0].tau))
    ysj, datj = jnp.asarray(gt), xj[0][0].dat
    qj, dj = dbg["rigid_obs"](ysj, datj, jnp.asarray(q0, jnp.float32),
                              jnp.float32(s0), jnp.float32(tau), 0,
                              dbg["geom"], debug=True)
    Msj, _ = dbg["maps_from_q"](jnp.asarray(q0[None], jnp.float32),
                                dbg["geom"][0], dbg["geom"][1])
    sj_new = dbg["scaling_obs"](ysj, datj, Msj[0][0], jnp.float32(s0),
                                jnp.float32(tau), 0)
    out["jax"] = dict(delta=np.asarray(dj["delta"]), ll=float(dj["ll"]),
                      g=np.asarray(dj["g"]), H=np.asarray(dj["H"]),
                      q=np.asarray(qj), s=float(sj_new))
    it = t_make_fit_chunk(xt, yt, st, 1)
    yst, datt = torch.from_numpy(gt), xt[0][0].dat
    delta, ll, extra = it.rigid_stats(yst, datt, q0, s0, 0, debug=True)
    q_new = it.rigid_ls(yst, datt, q0, s0, 0, delta, ll)
    Ms, _ = it.maps(q0[None])
    out["torch"] = dict(delta=delta.numpy(), ll=float(ll),
                        g=extra["g"].numpy(), H=extra["H"].numpy(),
                        q=q_new.numpy(),
                        s=float(it.scaling_obs(yst, datt, Ms[0][0], s0, 0)))
    return out


def test_fit_loop_rigid_update_matches_jax(loop_updates):
    j, t = loop_updates["jax"], loop_updates["torch"]
    assert t["ll"] == pytest.approx(j["ll"], rel=1e-4)
    np.testing.assert_allclose(t["g"], j["g"], rtol=1e-4,
                               atol=1e-4 * np.abs(j["g"]).max())
    np.testing.assert_allclose(t["H"], j["H"], rtol=1e-4,
                               atol=1e-4 * np.abs(j["H"]).max())
    _close(t["delta"], j["delta"], rtol=1e-4, atol=1e-6)
    _close(t["q"], j["q"], rtol=1e-4, atol=1e-6)


def test_fit_loop_scaling_update_matches_jax(loop_updates):
    j, t = loop_updates["jax"], loop_updates["torch"]
    _close(t["s"], j["s"], rtol=1e-4, atol=1e-6)
