"""unires_torch's init + fit against unires_tpu's, both run to convergence on
the CPU from the same numpy inputs.

A misaligned 2-channel blob problem (16x16x17, each channel at its own rigid
pose; sigma = 10 noise) goes through both packages' ``init`` and ``fit``
with co-registration, unified rigid and even/odd scaling on and
``max_iter=200``, which neither reaches:

* ``sr_sched``: super-resolution (4 mm slices along z and x, scaling 0.1),
  ``sched_num=1`` and tolerance 1e-3: one lambda step, then the
  convergence countdown;
* ``sr_countdown``: the same with ``sched_num=0`` and tolerance 3e-3: the
  countdown alone;
* ``denoising``: 1 mm observations, ``sched_num=0``, tolerance 3e-3.

The fits are chaotic in float32: a difference of a few roundings in a
rigid line search's comparison or in a gain against its gate changes the
path that follows. So each tolerance is about twice the larger of two
measured differences (sr_sched / sr_countdown / denoising): the port's from
the JAX package, and the JAX package's from itself when its inputs are
multiplied by (1 + 1e-6 N(0, 1)) (three draws per case, the largest shown):

* ``n_iter``: measured 49 / 27 / 27 in both and in every JAX draw; one
  more JAX draw of ``sr_sched`` stopped at 50, so that case is held to +-1;
* the objective trace entry by entry, relative, per column: nlyx (the
  total) port 4.5e-4 / 2.5e-4 / 1.2e-4, JAX 1.2e-3 / 1.1e-3 / 3.6e-4;
  nlxy (the data term) port 6.4e-3 / 2.8e-3 / 1.5e-3, JAX 1.7e-2 /
  8.2e-3 / 1.7e-3; nly (the prior) port 2.8e-4 / 2.2e-4 / 3.1e-5, JAX
  6.3e-4 / 3.3e-4 / 4.5e-5; the last total, relative: port 3.1e-4 /
  2.5e-4 / 1.1e-4, JAX 8.0e-4 / 8.8e-4 / 6.9e-5;
* the coreg matrices: translations port 2.1e-3 mm, JAX 3.5e-3; rotation
  entries port 7.8e-5, JAX 2.2e-4;
* the final volumes, relative L2: port 8.7e-4 / 9.0e-4 / 1.3e-4, JAX
  2.2e-3 / 2.2e-3 / 1.2e-4;
* ``rigid_q``: translations port 2.5e-3 mm, JAX 4.9e-3; rotations port
  7.2e-4 rad, JAX 1.8e-3; scales port 6.8e-5, JAX 1.7e-4;
* PSNR against the ground truth on the recon grid: port 0.004 / 0.006 /
  0.002 dB, JAX 0.018 / 0.013 / 0.002.

The one fault these comparisons found: at sigma = 30 the port's coreg
stood 0.05 mm from the JAX package's however the inputs were perturbed.
Its coarse level (4x4x5 voxels) starts at the identity map, where every
moved intensity is a voxel's and the mover's extremes normalise to the end
bins exactly: the soft bin weights max(0, 1 - |m - b|) sit on their kinks,
and the port differentiated them as torch does (|x|' = 0 at 0, the clamp
passing at its edge), the JAX package as JAX does (|x|' = 1 at 0, a tie of
the max taking half). Held here: the cotangent at ties against JAX's
autodiff (float32, 1e-5 relative), and the coarse level's descent against
the JAX optimiser (measured 0.019 mm / 5.9e-6 rad after, 0.76 mm /
1.2e-3 before; held to 0.05 mm / 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unires_torch
import unires_tpu
from phantoms import blob_phantom, degrade
from unires_torch.ops.resample import affine_to_M, pull
from unires_torch.pipeline import registration as treg
from unires_torch.pipeline.fit import fit as t_fit
from unires_tpu.pipeline import registration as jreg
from unires_tpu.pipeline.fit import fit as j_fit

torch.set_num_threads(2)

DIM = (16, 16, 17)
POSES = ([1.0, -0.5, 0.4, 0.02, -0.01, 0.015],
         [-0.8, 0.6, -0.3, -0.015, 0.01, -0.01])
BASE = dict(vx=1.0, do_print=0, write_out=False, do_coreg=True,
            unified_rigid=True, scaling=True, max_iter=200,
            coreg_params=dict(cost_fun="nmi", group="SE", samp=1, fwhm=7.0,
                              mean_space=False, levels=(4.0,)))
# case: (slice thickness, simulated scaling, sched_num, tolerance)
CASES = {"sr_sched": (4.0, 0.1, 1, 1e-3),
         "sr_countdown": (4.0, 0.1, 0, 3e-3),
         "denoising": (1.0, 0.0, 0, 3e-3)}
N_ITER_TOL = {"sr_sched": 1, "sr_countdown": 0, "denoising": 0}
TRACE_TOL = (3e-3, 4e-2, 2e-3)  # relative: nlyx, nlxy, nly
LAST_TOL, VOL_TOL, PSNR_TOL = 2e-3, 5e-3, 0.05
COREG_TOL = (0.01, 5e-4)  # mm, rotation entries
Q_TOL, SCL_TOL = (0.015, 4e-3), 5e-4  # (mm, rad), absolute


def _problem(noise, thick=4.0, scl=0.1):
    """The ground truth and the two channels [[x, mat], ...]."""
    gt = blob_phantom(dim=DIM, amplitude=1000.0, seed=5)
    return gt, [list(degrade(gt, thick_axis=ax, thick=thick, noise_sd=noise,
                             seed=seed, scl=scl, rigid_params=rp)[:2])
                for ax, seed, rp in zip((2, 0), (11, 22), POSES)]


def _psnr(y, gt):
    """PSNR of channel 0 against the ground truth resampled on its grid."""
    M = affine_to_M(np.linalg.solve(np.eye(4), y[0].mat))
    ref = pull(torch.from_numpy(gt), M, y[0].dim).numpy()
    rec = np.asarray(y[0].dat, np.float64)
    msk = ref > 0
    mse = float(np.mean((rec[msk] - ref[msk]) ** 2))
    return 10.0 * np.log10(float(ref.max()) ** 2 / mse)


@pytest.fixture(scope="module", params=list(CASES))
def converged(request):
    thick, scl, sched_num, tol = CASES[request.param]
    gt, chans = _problem(10.0, thick, scl)
    kw = dict(BASE, sched_num=sched_num, tolerance=tol)
    out = {"case": request.param}
    for name, pkg, fit, extra in (("jax", unires_tpu, j_fit, {}),
                                  ("torch", unires_torch, t_fit,
                                   dict(device="cpu"))):
        x, y, sett = pkg.init(chans, pkg.Settings(**kw, **extra))
        mat_coreg = np.asarray(sett.mat_coreg)
        y, _, _, obj, n_iter = fit(x, y, sett)
        out[name] = dict(
            x=x, y=y, sett=sett, obj=np.asarray(obj, np.float64),
            n_iter=n_iter, mat_coreg=mat_coreg, psnr=_psnr(y, gt),
            q=np.stack([o.rigid_q for xc in x for o in xc]),
            scl=np.array([o.po.scl for xc in x for o in xc]))
    return out


def test_both_converge_in_as_many_iterations(converged):
    j, t = converged["jax"], converged["torch"]
    assert j["sett"].method == t["sett"].method == (
        "denoising" if converged["case"] == "denoising"
        else "super-resolution")
    assert 0 < j["n_iter"] < BASE["max_iter"]
    assert 0 < t["n_iter"] < BASE["max_iter"]
    assert abs(t["n_iter"] - j["n_iter"]) <= N_ITER_TOL[converged["case"]]
    assert t["obj"].shape == (t["n_iter"], 3)


def test_coreg_matches_jax(converged):
    mj, mt = converged["jax"]["mat_coreg"], converged["torch"]["mat_coreg"]
    assert mt.shape == mj.shape == (2, 4, 4)
    np.testing.assert_allclose(mt[:, :3, 3], mj[:, :3, 3],
                               atol=COREG_TOL[0])
    np.testing.assert_allclose(mt[:, :3, :3], mj[:, :3, :3],
                               atol=COREG_TOL[1])


def test_objective_traces_match_jax(converged):
    oj, ot = converged["jax"]["obj"], converged["torch"]["obj"]
    n = min(len(oj), len(ot))
    for col, tol in enumerate(TRACE_TOL):
        np.testing.assert_allclose(ot[:n, col], oj[:n, col], rtol=tol)
    assert ot[-1, 0] == pytest.approx(oj[-1, 0], rel=LAST_TOL)
    assert ot[-1, 0] < 0.5 * ot[0, 0]


def test_volumes_match_jax(converged):
    for yj, yt in zip(converged["jax"]["y"], converged["torch"]["y"]):
        a = np.asarray(yj.dat, np.float64)
        b = yt.dat.numpy().astype(np.float64)
        assert b.shape == a.shape
        assert np.linalg.norm(b - a) / np.linalg.norm(a) < VOL_TOL


def test_poses_and_scales_match_jax(converged):
    j, t = converged["jax"], converged["torch"]
    assert np.abs(t["q"][:, :3]).max() > 0.05  # the poses moved
    np.testing.assert_allclose(t["q"][:, :3], j["q"][:, :3], atol=Q_TOL[0])
    np.testing.assert_allclose(t["q"][:, 3:], j["q"][:, 3:], atol=Q_TOL[1])
    np.testing.assert_allclose(t["scl"], j["scl"], atol=SCL_TOL)


def test_quality_matches_jax(converged):
    j, t = converged["jax"], converged["torch"]
    assert t["psnr"] == pytest.approx(j["psnr"], abs=PSNR_TOL)
    assert t["psnr"] > 20.0


# --- the fault: the NMI cotangent at the soft bins' kinks ---------------------

def _jax_hist_loss(fix, mmin, mmax, bins=64):
    """The JAX optimiser's NMI of the moved intensities (its ``hist_loss``,
    unires_tpu/pipeline/registration.py:390-410, in one chunk)."""
    f = jnp.asarray(fix.reshape(-1))
    fn = (f - f.min()) / jnp.maximum(f.max() - f.min(), 1e-12) * (bins - 1)

    def loss(movf):
        mn = (movf - mmin) / jnp.maximum(mmax - mmin, 1e-12) * (bins - 1)
        joint = jnp.dot(jreg._soft_hist_weights(fn, bins),
                        jreg._soft_hist_weights(mn, bins).T,
                        precision=jax.lax.Precision.HIGHEST)
        joint = joint / jnp.maximum(jnp.sum(joint), 1e-12)
        pf, pm, eps = jnp.sum(joint, axis=1), jnp.sum(joint, axis=0), 1e-12
        hf = -jnp.sum(pf * jnp.log(pf + eps))
        hm = -jnp.sum(pm * jnp.log(pm + eps))
        hj = -jnp.sum(joint * jnp.log(joint + eps))
        return -(hf + hm) / jnp.maximum(hj, eps)

    return loss


def test_nmi_cotangent_at_ties_matches_jax():
    """At the identity map the moved intensities are the mover's voxels:
    its minimum and maximum fall on bins 0 and 63 exactly, at the kinks of
    their own bins' weights and of the neighbours'."""
    rng = np.random.default_rng(4)
    fix = (rng.random((4, 4, 5), dtype=np.float32) * 800.0).astype(np.float32)
    mov = (rng.random((4, 4, 5), dtype=np.float32) * 600.0).astype(np.float32)
    lev = treg._NMILevel(torch.from_numpy(fix), torch.from_numpy(mov),
                         np.eye(4), np.eye(4))
    movf = pull(torch.from_numpy(mov), np.eye(4)[:3], mov.shape).reshape(-1)
    assert torch.equal(movf, torch.from_numpy(mov.reshape(-1)))
    loss, ct = lev._loss_cotangent(movf)
    jloss = _jax_hist_loss(fix, float(mov.min()), float(mov.max()))
    want = np.asarray(jax.grad(jloss)(jnp.asarray(mov.reshape(-1))))
    assert float(loss) == pytest.approx(float(jloss(jnp.asarray(
        mov.reshape(-1)))), rel=1e-6)
    np.testing.assert_allclose(ct.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_coarse_coreg_level_matches_jax():
    """The 4 mm level of the sigma = 30 problem's coreg (4x4x5 voxels),
    from the identity, through the port's level optimiser and the JAX
    package's, on the JAX package's pyramids."""
    (x0, m0), (x1, m1) = _problem(30.0)[1]
    levels, fwhms = (4.0, 1.0), [7.0, 7.0]
    fd, fm = jreg._iso_pyramid(x0, m0, levels, fwhms)[0]
    md, mm = jreg._iso_pyramid(x1, m1, levels, fwhms,
                               box=treg._world_box([(m1, x1.shape)]))[0]
    wc = treg._fix_centre(x0.shape, m0)
    qj, _ = jreg._opt_level(fd, fm, md, mm, np.zeros(6), wc, "SE", 64, 150,
                            None)
    qt = treg._opt_level(torch.tensor(np.asarray(fd)), fm,
                         [(torch.tensor(np.asarray(md)), mm)],
                         np.zeros((1, 6)), wc)
    qj = np.asarray(qj, np.float64)
    assert np.abs(qj[:3]).max() > 0.5  # the level moved the mover
    np.testing.assert_allclose(qt[0, :3], qj[:3], atol=0.05)
    np.testing.assert_allclose(qt[0, 3:], qj[3:], atol=1e-4)


def test_chip_smoke_jax_diffs_reads_each_figure():
    """``chip_smoke.jax_diffs``, which the card's phases 5 and 9 hold to
    ``JAX_TOL``: zero for the reference's own figures, one name for each
    tolerance, and a moved figure reported under its name as moved (signed
    for a number, relative for the names in ``JAX_REL``)."""
    import chip_smoke

    ref = chip_smoke._jax_reference()
    fig = chip_smoke._jax_figures(ref)
    d = chip_smoke.jax_diffs(fig, converged=True)
    assert set(d) == set(chip_smoke.JAX_TOL)
    assert all(v == 0.0 for v in d.values())
    first8 = dict(fig, nll=np.asarray(ref["nll"][:8]))
    assert set(chip_smoke.jax_diffs(first8, converged=False)) == {
        "inputs", "tau", "coreg_mm", "coreg_rot", "grid_dim", "grid_mat",
        "mse_tri", "nll8"}
    mat = np.array(ref["init"]["mat_coreg"])
    mat[1, 0, 3] += 0.03
    nll = np.array(ref["nll"])
    nll[3] *= 1.0 + 4e-4
    moved = dict(fig, mat_coreg=mat, nll=nll, n_iter=ref["n_iter"] - 2,
                 psnr=ref["psnr"] + 0.05,
                 inputs=np.array(fig["inputs"]) * (1.0 + 3e-6))
    d = chip_smoke.jax_diffs(moved, converged=True)
    assert d["coreg_mm"] == pytest.approx(0.03, rel=1e-9)
    assert d["nll8"] == pytest.approx(4e-4, rel=1e-6)
    assert d["trace"] == pytest.approx(4e-4, rel=1e-6)
    assert d["inputs"] == pytest.approx(3e-6, rel=1e-6)
    assert d["n_iter"] == -2.0
    assert d["psnr"] == pytest.approx(0.05, rel=1e-9)
    assert d["coreg_rot"] == d["tau"] == d["last"] == 0.0
