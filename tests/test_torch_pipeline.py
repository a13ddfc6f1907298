"""unires_torch's init + fit against unires_tpu's, end to end on the CPU.

A tiny 2-channel super-resolution problem, max_iter=6 and tolerance=0, no
co-registration: tau, lam0 and rho to relative 1e-6 (the same host code), the
initial y and the final y to relative L2 1e-3 and the objective trace to
relative 1e-3 (six coupled float32 iterations; the port sums the objective
in float64).

The misaligned problem (two channels with rigid misalignment and even/odd
scaling 0.1; co-registration on a 4 mm and a 1 mm level, unified rigid and
scaling on; 4 iterations): each tolerance is a few times the difference
measured on the CPU. Coreg mats to 0.01 mm / 5e-4 (measured 1.4e-3 mm /
4.5e-5), the objective trace to relative 2e-4 (4.1e-5), the fitted scales to
3e-5 (6.6e-6), q to 1e-3 mm / 7e-4 (2.8e-4 / 2.2e-4), R to 6e-3 mm / 5e-4
(2.0e-3 / 1.6e-4). A fit continued from a JAX mid-fit state starts from
identical poses: its trace to relative 2e-6 (measured 2.3e-7) and its q to
4e-5 mm / 1e-5 (3.9e-6 / 8.5e-7).
"""
import copy
import importlib
import os

import numpy as np
import pytest
import torch

import unires_torch
import unires_tpu
from phantoms import blob_phantom, degrade
from unires_torch.pipeline.convert import convert_state
from unires_torch.pipeline.fit import fit as t_fit
from unires_torch.pipeline.nifti import load, save
from unires_tpu.pipeline.fit import fit as j_fit

torch.set_num_threads(2)

KW = dict(vx=1.0, do_coreg=False, do_print=0, max_iter=6, tolerance=0,
          write_out=False)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def chans():
    gt = blob_phantom(dim=(16, 16, 17), amplitude=1000.0, seed=5)
    out = []
    for ax, seed in ((2, 11), (0, 22)):
        x, mat, _ = degrade(gt, thick_axis=ax, thick=4.0, noise_sd=30.0,
                            seed=seed)
        out.append([x, mat])
    return out


@pytest.fixture(scope="module")
def fitted(chans):
    xj, yj, sj = unires_tpu.init(chans, unires_tpu.Settings(**KW))
    xt, yt, st = unires_torch.init(chans, unires_torch.Settings(device="cpu",
                                                                **KW))
    init = dict(tau=([o.tau for c in xj for o in c],
                     [o.tau for c in xt for o in c]),
                lam0=([c.lam0 for c in yj], [c.lam0 for c in yt]),
                y0=([np.asarray(c.dat) for c in yj],
                    [c.dat.numpy().copy() for c in yt]),
                rho=(unires_tpu.solvers.admm.step_size(xj, yj, sj),
                     unires_torch.solvers.admm.step_size(xt, yt, st)))
    yj, _, _, obj_j, n_j = j_fit(xj, yj, sj)
    yt, R, jtv, obj_t, n_t = t_fit(xt, yt, st)
    return init, (yj, obj_j, n_j), (yt, obj_t, n_t, R, jtv)


def test_init_matches_jax(fitted):
    init = fitted[0]
    for key in ("tau", "lam0", "rho"):
        np.testing.assert_allclose(init[key][1], init[key][0], rtol=1e-6)
    for a, b in zip(*init["y0"]):
        assert a.shape == b.shape
        assert _rel(b, a) < 1e-3


def test_fit_trace_matches_jax(fitted):
    _, (yj, obj_j, n_j), (yt, obj_t, n_t, R, jtv) = fitted
    assert n_t == n_j == KW["max_iter"]
    assert obj_t.shape == obj_j.shape == (KW["max_iter"], 3)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-3)
    assert obj_t[-1, 0] < obj_t[0, 0]
    for cj, ct in zip(yj, yt):
        assert _rel(ct.dat.numpy(), np.asarray(cj.dat)) < 1e-3
        assert ct.lam == pytest.approx(cj.lam, rel=1e-6)
    np.testing.assert_allclose(R, np.stack([np.eye(4)] * 2), atol=1e-12)
    assert torch.isfinite(jtv).all()


def test_fit_from_converted_jax_state_matches(chans, fitted):
    """The converter carries the JAX init's state into the port unchanged:
    a fit from it retraces the port's own fit."""
    xj, yj, sj = unires_tpu.init(chans, unires_tpu.Settings(**KW))
    xt, yt, st = convert_state(xj, yj, sj, "cpu")
    assert st.device == "cpu" and st.method == sj.method
    for cj, ct in zip(yj, yt):
        np.testing.assert_array_equal(ct.dat.numpy(), np.asarray(cj.dat))
    for oj, ot in zip(xj[1], xt[1]):
        assert (ot.tau, ot.mu, ot.po.dim_yx) == (oj.tau, oj.mu, oj.po.dim_yx)
    _, _, _, obj_t, _ = t_fit(xt, yt, st)
    _, (_, obj_j, _), (_, obj_own, _, _, _) = fitted
    np.testing.assert_allclose(obj_t, obj_own, rtol=1e-5)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-3)


def test_preproc_writes_niftis(chans, tmp_path):
    paths = []
    for c, (x, mat) in enumerate(chans):
        p = str(tmp_path / f"chan{c}.nii.gz")
        save(x, p, affine=mat)
        paths.append(p)
    sett = unires_torch.Settings(**dict(KW, device="cpu", max_iter=2,
                                        write_out=True,
                                        dir_out=str(tmp_path / "out")))
    dat_y, mat_y, pth_y = unires_torch.preproc(paths, sett)
    assert dat_y.shape[-1] == 2 and len(pth_y) == 2
    for p, c in zip(pth_y, range(2)):
        assert os.path.basename(p) == f"u_chan{c}.nii.gz"
        got, hdr = load(p)
        np.testing.assert_array_equal(got, dat_y[..., c])
        np.testing.assert_allclose(hdr.affine, mat_y, atol=1e-4)


def test_denoising_fit_matches_jax():
    """Same grid in and out: 'denoising' without projection operators."""
    rng = np.random.default_rng(4)
    gt = blob_phantom(dim=(14, 15, 16), amplitude=1000.0, seed=6)
    chans = [[(gt + rng.normal(0.0, 40.0, gt.shape)).astype(np.float32),
              np.eye(4)] for _ in range(2)]
    kw = dict(KW, max_iter=3)
    xj, yj, sj = unires_tpu.init(chans, unires_tpu.Settings(**kw))
    xt, yt, st = unires_torch.init(chans, unires_torch.Settings(device="cpu",
                                                                **kw))
    assert (st.method, st.do_proj) == (sj.method, sj.do_proj) == (
        "denoising", False)
    yj, _, _, obj_j, _ = j_fit(xj, yj, sj)
    yt, _, _, obj_t, _ = t_fit(xt, yt, st)
    np.testing.assert_allclose(obj_t, obj_j, rtol=1e-3)
    for cj, ct in zip(yj, yt):
        assert _rel(ct.dat.numpy(), np.asarray(cj.dat)) < 1e-3


def test_schedule_and_gain_match_jax():
    # the modules, not the ``fit`` functions the packages re-export
    tf = importlib.import_module("unires_torch.pipeline.fit")
    jf = importlib.import_module("unires_tpu.pipeline.fit")

    for N, reg_scl, sched_num in ((3, 4.0, 3), (1, 4.0, 3), (2, [8.0, 2.0], 1)):
        sj = jf.get_sched(N, unires_tpu.Settings(reg_scl=reg_scl,
                                                 sched_num=sched_num))
        st = tf.get_sched(N, unires_torch.Settings(reg_scl=reg_scl,
                                                   sched_num=sched_num))
        np.testing.assert_array_equal(st.reg_scl, sj.reg_scl)
        assert st.sched_num == sj.sched_num
    for trace in ([5.0], [5.0, 4.0], [5.0, 4.0, 4.5, 1.0], [2.0, 2.0]):
        assert tf.get_gain(trace) == jf.get_gain(trace)


def test_single_channel_clean_fov_matches_jax(chans):
    """One image: format_y turns clean_fov on; max_iter=0 keeps the init
    reslice, so the fit only cleans the FOV."""
    kw = dict(KW, max_iter=0)
    xj, yj, sj = unires_tpu.init(chans[:1], unires_tpu.Settings(**kw))
    xt, yt, st = unires_torch.init(chans[:1], unires_torch.Settings(
        device="cpu", **kw))
    assert st.clean_fov and sj.clean_fov
    yj, _, _, _, _ = j_fit(xj, yj, sj)
    yt, _, _, obj, n = t_fit(xt, yt, st)
    assert n == 0 and obj.shape == (0, 3)
    got, want = yt[0].dat.numpy(), np.asarray(yj[0].dat)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert _rel(got, want) < 1e-6


MIS_KW = dict(KW, do_coreg=True, unified_rigid=True, scaling=True,
              max_iter=4, chunk_iters=2,
              coreg_params=dict(cost_fun="nmi", group="SE", samp=1, fwhm=7.0,
                                mean_space=False, levels=(4.0,)))
MIS_POSES = ([1.0, -0.5, 0.4, 0.02, -0.01, 0.015],
             [-0.8, 0.6, -0.3, -0.015, 0.01, -0.01])


@pytest.fixture(scope="module")
def misaligned():
    gt = blob_phantom(dim=(24, 24, 25), amplitude=1000.0, seed=5)
    chans = []
    for ax, seed, rp in zip((2, 0), (11, 22), MIS_POSES):
        x, mat, _ = degrade(gt, thick_axis=ax, thick=4.0, noise_sd=30.0,
                            seed=seed, scl=0.1, rigid_params=rp)
        chans.append([x, mat])
    xj, yj, sj = unires_tpu.init(chans, unires_tpu.Settings(**MIS_KW))
    xt, yt, st = unires_torch.init(chans, unires_torch.Settings(
        device="cpu", **MIS_KW))
    start = copy.deepcopy((xj, yj, sj))  # for the mid-fit continuation
    yj, Rj, _, obj_j, _ = j_fit(xj, yj, sj)
    yt, Rt, _, obj_t, _ = t_fit(xt, yt, st)
    return dict(start=start, jax=(xj, sj, Rj, obj_j), torch=(xt, st, Rt, obj_t))


def _qs(x):
    return np.stack([o.rigid_q for xc in x for o in xc])


def test_misaligned_coreg_matches_jax(misaligned):
    (_, sj, _, _), (_, st, _, _) = misaligned["jax"], misaligned["torch"]
    mj, mt = np.asarray(sj.mat_coreg), np.asarray(st.mat_coreg)
    assert mt.shape == mj.shape == (2, 4, 4)
    np.testing.assert_allclose(mt[:, :3, 3], mj[:, :3, 3], atol=0.01)
    np.testing.assert_allclose(mt[:, :3, :3], mj[:, :3, :3], atol=5e-4)


def test_misaligned_fit_matches_jax(misaligned):
    (xj, _, Rj, obj_j), (xt, _, Rt, obj_t) = (misaligned["jax"],
                                              misaligned["torch"])
    assert obj_t.shape == obj_j.shape == (MIS_KW["max_iter"], 3)
    np.testing.assert_allclose(obj_t, obj_j, rtol=2e-4)
    assert obj_t[-1, 0] < obj_t[0, 0]
    qj, qt = _qs(xj), _qs(xt)
    assert np.abs(qt).max() > 0.05  # the poses moved
    np.testing.assert_allclose(qt[:, :3], qj[:, :3], atol=1e-3)
    np.testing.assert_allclose(qt[:, 3:], qj[:, 3:], atol=7e-4)
    sclj = [o.po.scl for xc in xj for o in xc]
    sclt = [o.po.scl for xc in xt for o in xc]
    assert min(sclt) > 0.05  # towards the simulated 0.1
    np.testing.assert_allclose(sclt, sclj, atol=3e-5)
    np.testing.assert_allclose(Rt[:, :3, :3], Rj[:, :3, :3], atol=5e-4)
    np.testing.assert_allclose(Rt[:, :3, 3], Rj[:, :3, 3], atol=6e-3)


def test_fit_continues_jax_mid_fit_state(misaligned):
    """convert_state carries a JAX FitState (poses, scales, z, w, schedule)
    after one 2-iteration chunk; the port's continuation retraces the JAX
    package's second chunk."""
    from unires_tpu.pipeline.fit import _gather_dyn_taus, _gather_subdats
    from unires_tpu.pipeline.fit import get_sched as j_get_sched
    from unires_tpu.solvers.fitloop import init_state as j_init_state
    from unires_tpu.solvers.fitloop import make_fit_chunk

    xj, yj, sj = misaligned["start"]
    sj = j_get_sched(2, sj)
    chunk = make_fit_chunk(xj, yj, sj, 2)
    xd = tuple(tuple(o.dat for o in xc) for xc in xj)
    args = (xd, _gather_dyn_taus(xj), _gather_subdats(xj, sj))
    st, _, _, _ = chunk(j_init_state(xj, yj, sj), *args)
    xt, yt, stt, state = convert_state(xj, yj, sj, "cpu", state=st)
    assert state.n_iter == 2 and state.q.shape == (2, 6)
    np.testing.assert_array_equal(_qs(xt), np.asarray(st.q, np.float64))
    st2, objs2, _, _ = chunk(st, *args)
    _, _, _, obj_t, n = t_fit(xt, yt, stt, state=state)
    assert n == 2
    np.testing.assert_allclose(obj_t, np.asarray(objs2, np.float64),
                               rtol=2e-6)
    q2 = np.asarray(st2.q, np.float64)
    np.testing.assert_allclose(_qs(xt)[:, :3], q2[:, :3], atol=4e-5)
    np.testing.assert_allclose(_qs(xt)[:, 3:], q2[:, 3:], atol=1e-5)


# the six settings that raised in the port until it covered them; the
# names ``UNPORTED`` and ``test_unported_settings_raise`` are kept from then
UNPORTED = [dict(checkpoint_every=2), dict(resume=True), dict(shard="batch"),
            dict(profile_dir="p"), dict(plot_conv=True), dict(show_jtv=True)]


@pytest.mark.parametrize("extra", UNPORTED, ids=lambda d: next(iter(d)))
def test_unported_settings_raise(chans, extra, tmp_path, monkeypatch):
    """Every one of them now RUNS: a 2-iteration fit with the setting on
    gives the trace of the fit without it, and leaves behind what the
    setting asks for."""
    monkeypatch.delenv("DISPLAY", raising=False)
    kw = dict(KW, device="cpu", max_iter=2)
    want = t_fit(*unires_torch.init(chans, unires_torch.Settings(**kw)))[3]
    extra = dict(extra)
    ckpt = str(tmp_path / "state.npz")
    if "checkpoint_every" in extra or "resume" in extra:
        extra["checkpoint_path"] = ckpt
    if "profile_dir" in extra:
        extra["profile_dir"] = str(tmp_path / "p")
    sett = unires_torch.Settings(**kw, **extra)
    _, _, _, obj, n = t_fit(*unires_torch.init(chans, sett))
    assert n == 2
    np.testing.assert_array_equal(obj, want)
    assert os.path.exists(ckpt) == ("checkpoint_every" in extra)
    if "profile_dir" in extra:
        assert [f for f in os.listdir(extra["profile_dir"])
                if f.endswith(".pt.trace.json")]
    if "plot_conv" in extra or "show_jtv" in extra:
        import matplotlib.pyplot as plt

        assert (99 if "plot_conv" in extra else 98) in plt.get_fignums()
        plt.close("all")


def test_cuda_device_without_cuda_raises(chans):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        unires_torch.init(chans, unires_torch.Settings(**KW))
