"""unires_torch's init + fit against unires_tpu's, end to end on the CPU.

A tiny 2-channel super-resolution problem, max_iter=6 and tolerance=0, no
co-registration: tau, lam0 and rho to relative 1e-6 (the same host code), the
initial y and the final y to relative L2 1e-3 and the objective trace to
relative 1e-3 (six coupled float32 iterations; the port sums the objective
in float64).
"""
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


UNPORTED = [dict(do_coreg=True), dict(do_atlas_align=True),
            dict(unified_rigid=True), dict(scaling=True),
            dict(do_res_origin=True), dict(label=("l.nii.gz", (0, 0))),
            dict(force_inplane_res=True), dict(checkpoint_every=5),
            dict(resume=True), dict(shard="batch"), dict(profile_dir="p"),
            dict(common_output=True), dict(plot_conv=True),
            dict(show_jtv=True)]


@pytest.mark.parametrize("extra", UNPORTED, ids=lambda d: next(iter(d)))
def test_unported_settings_raise(chans, extra):
    sett = unires_torch.Settings(**dict(KW, device="cpu", **extra))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        unires_torch.init(chans, sett)


def test_cuda_device_without_cuda_raises(chans):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        unires_torch.init(chans, unires_torch.Settings(**KW))
