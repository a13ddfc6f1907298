"""Checkpoint / resume of the port, alone and across the two packages.

The file format is shared key for key, so a checkpoint written by
``unires_tpu`` resumes in ``unires_torch`` and the other way round. A
resumed fit is held to the JAX test's tolerance (tests/test_checkpoint.py:
volumes to 1e-3 of their scale), not to bitwise equality: the file leaves
out the CG preconditioner's data-term diagonals, so a resume recomputes them
from the restored poses, where an uninterrupted run with ``unified_rigid``
keeps those of the last ``chunk_iters`` boundary. That moves CG's path, not
its fixed point. The objective trace is held to 1e-4 relative.
"""
import os

import numpy as np
import pytest
import torch

import unires_torch
import unires_tpu
from phantoms import blob_phantom, degrade
from unires_torch.pipeline import checkpoint as t_ckpt
from unires_torch.pipeline.fit import fit as t_fit
from unires_tpu.pipeline import checkpoint as j_ckpt
from unires_tpu.pipeline.fit import fit as j_fit

torch.set_num_threads(2)

KEYS = {"ys", "z", "w", "lams", "lam0s", "rigid_q", "scls", "obj_trace",
        "rho", "cnt_scl", "cnt_scl_iter", "n_iter", "countdown0",
        "countdown1"}
STATE = dict(rho=1.5, cnt_scl=1, cnt_scl_iter=4, n_iter=7, countdown0=5,
             countdown1=2, obj_trace=np.arange(9.0).reshape(3, 3))
Q = np.array([0.1, 0.2, 0.3, 0.001, 0.002, 0.003])

CASES = {
    "one_channel": (1, dict(sched_num=0)),
    # co-registered first: from the raw misalignment no line search of
    # these few iterations accepts a step, and the poses would stay 0
    "two_channels_gn": (2, dict(
        scaling=True, unified_rigid=True, sched_num=1, chunk_iters=4,
        do_coreg=True, coreg_params=dict(
            cost_fun="nmi", group="SE", samp=1, fwhm=7.0, mean_space=False,
            levels=(4.0,)))),
}


def _data(n_chan):
    gt = blob_phantom(dim=(24, 24, 25), amplitude=1000.0, seed=2)
    out = []
    poses = ([1.0, -0.5, 0.4, 0.02, -0.01, 0.015],
             [-0.8, 0.6, -0.3, -0.015, 0.01, -0.01])
    for ax, seed, rp in ((2, 2, poses[0]), (1, 12, poses[1]))[:n_chan]:
        gn = dict(scl=0.05, rigid_params=rp) if n_chan > 1 else {}
        x_obs, mat_x, _ = degrade(gt, thick_axis=ax, thick=4.0, noise_sd=30.0,
                                  seed=seed, **gn)
        out.append([np.asarray(x_obs), mat_x])
    return out


def _sett(pkg, **kw):
    base = dict(vx=1.0, do_coreg=False, do_print=0, sched_num=0, reg_scl=4.0,
                write_out=False, tolerance=1e-4)
    base.update(kw)
    if pkg is unires_torch:
        base["device"] = "cpu"
    return pkg.Settings(**base)


def _problem(pkg, n_chan=1, **kw):
    return pkg.init(_data(n_chan), _sett(pkg, **kw))


def _vols(y):
    return [np.asarray(c.dat) for c in y]


def _assert_close_fit(got, want, trace_rtol=1e-4):
    (y_g, R_g, _, obj_g, n_g), (y_w, R_w, _, obj_w, n_w) = got, want
    assert n_g == n_w and obj_g.shape == obj_w.shape
    np.testing.assert_allclose(obj_g, obj_w, rtol=trace_rtol)
    for a, b in zip(_vols(y_g), _vols(y_w)):
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    np.testing.assert_allclose(R_g, R_w, atol=1e-3)


def test_checkpoint_roundtrip_every_field(tmp_path):
    path = str(tmp_path / "s.npz")
    x, y, sett = _problem(unires_torch, max_iter=2)
    z = torch.ones((1, 3) + tuple(y[0].dim))
    w = 2 * z
    x[0][0].rigid_q = Q.copy()
    x[0][0].po.scl = 0.05
    y[0].lam = 3.25
    ys0 = y[0].dat.clone()
    assert t_ckpt.save_checkpoint(path, x, y, z, w, STATE) == path
    ck = t_ckpt.load_checkpoint(path)
    assert set(ck) == KEYS

    x2, y2, _ = _problem(unires_torch, max_iter=2)
    z2, w2, st = t_ckpt.restore_into(ck, x2, y2)
    assert torch.equal(z2, z) and torch.equal(w2, w)
    assert torch.equal(y2[0].dat, ys0)
    assert (y2[0].lam, y2[0].lam0) == (3.25, y[0].lam0)
    np.testing.assert_array_equal(x2[0][0].rigid_q, Q)
    assert x2[0][0].rigid_q.dtype == np.float64
    assert x2[0][0].po.scl == 0.05
    from unires_torch.geometry import affine_basis, fov_centre, rigid_from_q
    np.testing.assert_array_equal(
        x2[0][0].po.rigid, rigid_from_q(Q, affine_basis("SE"),
                                        fov_centre(y2[0].mat, y2[0].dim)))
    assert {k: st[k] for k in STATE if k != "obj_trace"} == \
        {k: v for k, v in STATE.items() if k != "obj_trace"}
    np.testing.assert_array_equal(np.stack(st["obj_trace"]),
                                  STATE["obj_trace"])


def test_restore_rejects_a_channel_mismatch(tmp_path):
    path = str(tmp_path / "s.npz")
    x, y, _ = _problem(unires_torch, max_iter=2)
    z = torch.zeros((1, 3) + tuple(y[0].dim))
    t_ckpt.save_checkpoint(path, x, y, z, z, STATE)
    x2, y2, _ = _problem(unires_torch, n_chan=2, max_iter=2)
    with pytest.raises(ValueError, match="channels"):
        t_ckpt.restore_into(t_ckpt.load_checkpoint(path), x2, y2)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_file_crosses_the_packages(tmp_path, writer):
    """A file saved by one package restores field for field in the other."""
    import jax.numpy as jnp

    path = str(tmp_path / "s.npz")
    pkgs = {"jax": (unires_tpu, j_ckpt), "torch": (unires_torch, t_ckpt)}
    (wp, wck), (rp, rck) = pkgs[writer], pkgs[
        "torch" if writer == "jax" else "jax"]
    x, y, _ = _problem(wp, max_iter=2)
    rng = np.random.default_rng(0)
    z_np = rng.standard_normal((1, 3) + tuple(y[0].dim)).astype(np.float32)
    conv = jnp.asarray if writer == "jax" else torch.from_numpy
    x[0][0].rigid_q = Q.copy()
    x[0][0].po.scl = 0.05
    y[0].lam = 3.25
    wck.save_checkpoint(path, x, y, conv(z_np), conv(2 * z_np), STATE)

    x2, y2, _ = _problem(rp, max_iter=2)
    ck = rck.load_checkpoint(path)
    assert set(ck) == KEYS
    z2, w2, st = rck.restore_into(ck, x2, y2)
    np.testing.assert_array_equal(np.asarray(z2), z_np)
    np.testing.assert_array_equal(np.asarray(w2), 2 * z_np)
    np.testing.assert_array_equal(np.asarray(y2[0].dat), np.asarray(y[0].dat))
    assert (y2[0].lam, y2[0].lam0) == (3.25, y[0].lam0)
    np.testing.assert_array_equal(x2[0][0].rigid_q, Q)
    assert x2[0][0].po.scl == 0.05
    from unires_torch.geometry import affine_basis, fov_centre, rigid_from_q
    np.testing.assert_allclose(
        x2[0][0].po.rigid, rigid_from_q(Q, affine_basis("SE"), fov_centre(
            np.asarray(y2[0].mat), y2[0].dim)), rtol=0, atol=1e-12)
    for k in ("rho", "cnt_scl", "cnt_scl_iter", "n_iter", "countdown0",
              "countdown1"):
        assert st[k] == STATE[k], k
    np.testing.assert_array_equal(np.stack(st["obj_trace"]),
                                  STATE["obj_trace"])


@pytest.mark.parametrize("case", list(CASES))
def test_resume_matches_uninterrupted(tmp_path, case):
    n_chan, kw = CASES[case]
    path = str(tmp_path / "state.npz")
    full = t_fit(*_problem(unires_torch, n_chan, max_iter=12, **kw))

    cut = t_fit(*_problem(unires_torch, n_chan, max_iter=6,
                          checkpoint_every=3, checkpoint_path=path, **kw))
    ck = t_ckpt.load_checkpoint(path)
    assert int(ck["n_iter"]) == 5 and ck["obj_trace"].shape == (6, 3)
    if n_chan > 1:
        assert np.abs(ck["rigid_q"]).max() > 0 and np.abs(ck["scls"]).max() > 0

    res = t_fit(*_problem(unires_torch, n_chan, max_iter=12,
                          checkpoint_every=3, checkpoint_path=path,
                          resume=True, **kw))
    # the trace holds the iterations before the checkpoint too
    np.testing.assert_array_equal(res[3][:6], cut[3])
    _assert_close_fit(res, full)
    assert int(t_ckpt.load_checkpoint(path)["n_iter"]) == 11


def test_port_resumes_a_jax_checkpoint(tmp_path):
    """The JAX package runs 6 and checkpoints; the port resumes that file to
    12 and is held against the JAX package's uninterrupted 12. The trace to
    1e-3 relative: the tolerance of the two packages' fits against each
    other (tests/test_torch_pipeline.py)."""
    path = str(tmp_path / "state.npz")
    full = j_fit(*_problem(unires_tpu, max_iter=12))
    j_fit(*_problem(unires_tpu, max_iter=6, checkpoint_every=3,
                    checkpoint_path=path))
    assert os.path.exists(path)
    res = t_fit(*_problem(unires_torch, max_iter=12, checkpoint_path=path,
                          resume=True))
    assert res[4] == 12
    _assert_close_fit(res, (full[0], full[1], None,
                            np.asarray(full[3], np.float64), full[4]),
                      trace_rtol=1e-3)


def test_jax_resumes_a_port_checkpoint(tmp_path):
    path = str(tmp_path / "state.npz")
    full = j_fit(*_problem(unires_tpu, max_iter=12))
    t_fit(*_problem(unires_torch, max_iter=6, checkpoint_every=3,
                    checkpoint_path=path))
    y, _, _, obj, n = j_fit(*_problem(unires_tpu, max_iter=12,
                                      checkpoint_path=path, resume=True))
    assert n == 12
    ref = np.asarray(full[0][0].dat)
    assert np.abs(np.asarray(y[0].dat) - ref).max() <= 1e-3 * np.abs(ref).max()


def test_resume_without_a_file_starts_fresh(tmp_path):
    path = str(tmp_path / "none.npz")
    fresh = t_fit(*_problem(unires_torch, max_iter=3))
    res = t_fit(*_problem(unires_torch, max_iter=3, resume=True,
                          checkpoint_path=path))
    assert res[4] == 3 and not os.path.exists(path)
    np.testing.assert_array_equal(res[3], fresh[3])


def test_failed_write_leaves_the_previous_file(tmp_path, monkeypatch):
    path = str(tmp_path / "s.npz")
    x, y, _ = _problem(unires_torch, max_iter=2)
    z = torch.zeros((1, 3) + tuple(y[0].dim))
    t_ckpt.save_checkpoint(path, x, y, z, z, STATE)
    before = open(path, "rb").read()

    def broken(file, **payload):
        with open(file + ".npz", "wb") as f:
            f.write(b"half a file")
        raise OSError("disk full")

    monkeypatch.setattr(t_ckpt.np, "savez_compressed", broken)
    with pytest.raises(OSError, match="disk full"):
        t_ckpt.save_checkpoint(path, x, y, z, z, dict(STATE, n_iter=99))
    assert open(path, "rb").read() == before
    assert int(t_ckpt.load_checkpoint(path)["n_iter"]) == 7
