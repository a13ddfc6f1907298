"""The batch-of-subjects fit of the port (``unires_torch.parallel.fit_batch``,
``preproc_batch``) against the port's single fits and against the JAX
package's ``fit_batch``.

A batch must reproduce B independent ``pipeline.fit.fit`` runs: on one
worker every subject runs the same operations in the same order as alone
(``n_iter`` equal, traces to 1e-6 relative, volumes to 1e-5 of their scale),
and two CPU workers (one host thread each) give the same. Against the JAX
package the tolerances are those of tests/test_fit_batch.py:88-102 (trace
rtol 1e-4, volumes 1e-3 of scale, q and scl 1e-4).
"""
import copy

import numpy as np
import pytest
import torch

import unires_torch
import unires_tpu
from phantoms import blob_phantom, degrade
from unires_torch.parallel.fit_batch import (assign_devices, batch_devices,
                                             check_homogeneous, fit_batch)
from unires_torch.pipeline.fit import fit as t_fit
from unires_torch.solvers.fitloop import FitChunk
from unires_torch.utils import trace
from unires_tpu.parallel.fit_batch import fit_batch as j_fit_batch

torch.set_num_threads(2)


def _subject_data(seed, dim=(16, 16, 17)):
    """2-channel subject: thick-z and thick-y acquisitions of one anatomy."""
    gt = blob_phantom(dim=dim, amplitude=1000.0, seed=seed)
    x0, m0, _ = degrade(gt, thick_axis=2, thick=4.0, noise_sd=5.0, seed=seed)
    x1, m1, _ = degrade(gt, thick_axis=1, thick=4.0, noise_sd=5.0,
                        seed=seed + 10)
    return [[np.asarray(x0), m0], [np.asarray(x1), m1]]


def _sett(pkg=unires_torch, **kw):
    base = dict(vx=1.0, do_coreg=False, do_print=0, sched_num=0, reg_scl=4.0,
                write_out=False, tolerance=1e-6, max_iter=8, chunk_iters=4,
                cgs_max_iter=4, scaling=True, unified_rigid=True)
    base.update(kw)
    if pkg is unires_torch:
        base["device"] = "cpu"
    return pkg.Settings(**base)


def _inits(pkg, subjects, **kw):
    xs, ys, sett = [], [], None
    for data in subjects:
        xb, yb, sett = pkg.init(copy.deepcopy(data), _sett(pkg, **kw))
        xs.append(xb)
        ys.append(yb)
    return xs, ys, sett


def _summary(x, y, R, obj, n_iter):
    return dict(y=[np.asarray(c.dat) for c in y], R=np.asarray(R),
                obj=np.asarray(obj, np.float64), n_iter=n_iter,
                q=np.stack([np.asarray(o.rigid_q) for xc in x for o in xc]),
                scl=np.array([o.po.scl for xc in x for o in xc]))


SUBJECTS = [_subject_data(0), _subject_data(7)]


@pytest.fixture(scope="module")
def singles():
    out = []
    for data in SUBJECTS:
        x, y, sett = unires_torch.init(copy.deepcopy(data), _sett())
        y, R, _, obj, n_iter = t_fit(x, y, sett)
        out.append(_summary(x, y, R, obj, n_iter))
    return out


@pytest.mark.parametrize("B,n,want", [
    (1, 1, [0]), (1, 4, [0]), (2, 1, [0, 0]), (2, 2, [0, 1]),
    (2, 4, [0, 1]), (3, 2, [0, 0, 0]), (3, 4, [0, 1, 2]),
    (4, 2, [0, 1, 0, 1]), (4, 4, [0, 1, 2, 3]), (6, 1, [0] * 6),
    (6, 2, [0, 1] * 3), (6, 4, [0, 1, 2] * 2)])
def test_assign_devices(B, n, want):
    assert assign_devices(B, n) == want


def test_batch_devices_of_a_cpu_run_is_the_cpu():
    assert batch_devices(_sett()) == [torch.device("cpu")]


def _two(**second):
    """Inits of subject 0 and of a second subject built with ``second``."""
    xs, ys = [], []
    for seed, kw in ((0, {}), (1, second)):
        data = _subject_data(seed, dim=kw.pop("dim", (16, 16, 17)))
        data = data[:kw.pop("n_chan", 2)]
        x, y, _ = unires_torch.init(data, _sett(max_iter=0, **kw))
        xs.append(x)
        ys.append(y)
    return xs, ys


@pytest.mark.parametrize("second,match", [
    (dict(dim=(16, 16, 21), n_chan=1), "channel/repeat structure"),
    (dict(dim=(16, 16, 21)), "recon grid"),
    (dict(ct=True), "CT flags"),
], ids=["structure", "grid", "ct"])
def test_check_homogeneous_rejects(second, match):
    xs, ys = _two(**second)
    with pytest.raises(ValueError, match=f"batch subject 1: {match}"):
        check_homogeneous(xs, ys, _sett())


def test_check_homogeneous_rejects_observation_geometry():
    """Subject 1's first channel is thick along x instead of z, on subject
    0's recon grid: the message names subject, channel and repeat."""
    xs, ys = _two()
    gt = blob_phantom(dim=(16, 16, 17), amplitude=1000.0, seed=1)
    x0, m0, _ = degrade(gt, thick_axis=0, thick=4.0, noise_sd=5.0, seed=1)
    data = [[np.asarray(x0), m0], _subject_data(1)[1]]
    x, y, _ = unires_torch.init(data, _sett(
        max_iter=0, force_y_space=(ys[0][0].mat, ys[0][0].dim)))
    with pytest.raises(ValueError,
                       match="batch subject 1 channel 0 repeat 0"):
        check_homogeneous([xs[0], x], [ys[0], y], _sett())


def test_check_homogeneous_accepts_a_homogeneous_batch():
    xs, ys = _two()
    check_homogeneous(xs, ys, _sett())


@pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]],
                         ids=["one_worker", "two_cpu_workers"])
def test_fit_batch_matches_single_fits(singles, devices):
    """2 different subjects, full algorithm (ADMM + scaling GN + rigid GN +
    convergence): the batch must reproduce each single fit."""
    xs, ys, sett = _inits(unires_torch, SUBJECTS)
    results = fit_batch(xs, ys, sett, devices=devices)
    assert len(results) == 2
    for b, (ref, (yb, Rb, jtvb, objb, n_b)) in enumerate(zip(singles,
                                                             results)):
        got = _summary(xs[b], yb, Rb, objb, n_b)
        assert got["n_iter"] == ref["n_iter"] == 8
        assert got["obj"].shape == ref["obj"].shape
        np.testing.assert_allclose(got["obj"], ref["obj"], rtol=1e-6)
        for a, w in zip(got["y"], ref["y"]):
            assert np.abs(a - w).max() <= 1e-5 * np.abs(w).max()
        np.testing.assert_allclose(got["q"], ref["q"], atol=1e-6)
        np.testing.assert_allclose(got["scl"], ref["scl"], atol=1e-6)
        np.testing.assert_allclose(got["R"], ref["R"], atol=1e-6)
        assert tuple(jtvb.shape) == tuple(yb[0].dim)
    # the subjects differ, so a batch that mixed them up would show
    assert not np.allclose(singles[0]["obj"], singles[1]["obj"], rtol=1e-3)


def test_fit_batch_matches_jax_fit_batch():
    xs, ys, sett = _inits(unires_torch, SUBJECTS)
    got = fit_batch(xs, ys, sett)
    xj, yj, sj = _inits(unires_tpu, SUBJECTS)
    want = j_fit_batch(xj, yj, sj)
    for b in range(2):
        g = _summary(xs[b], got[b][0], got[b][1], got[b][3], got[b][4])
        w = _summary(xj[b], want[b][0], want[b][1], want[b][3], want[b][4])
        assert g["n_iter"] == w["n_iter"]
        np.testing.assert_allclose(g["obj"], w["obj"], rtol=1e-4)
        for a, r in zip(g["y"], w["y"]):
            assert np.abs(a - r).max() <= 1e-3 * np.abs(r).max()
        np.testing.assert_allclose(g["q"], w["q"], atol=1e-4)
        np.testing.assert_allclose(g["scl"], w["scl"], atol=1e-4)
        np.testing.assert_allclose(g["R"], w["R"], atol=1e-4)


def test_fit_batch_max_iter_0_returns_identities():
    xs, ys, sett = _inits(unires_torch, SUBJECTS, max_iter=0)
    y0 = [[c.dat.clone() for c in yb] for yb in ys]
    res = fit_batch(xs, ys, sett)
    for b, (y, R, jtv, obj, n) in enumerate(res):
        assert n == 0 and jtv is None and len(obj) == 0
        np.testing.assert_array_equal(R, np.stack([np.eye(4)] * 2))
        assert all(torch.equal(c.dat, d) for c, d in zip(y, y0[b]))
    assert fit_batch([], [], sett) == []


def _one_subject(form, **kw):
    """Subject 0 fitted alone by ``pipeline.fit.fit`` (``form`` "fit")
    or by ``fit_batch`` as a batch of one ("batch"): its init, the result
    and the spans the fit opened."""
    x, y, sett = unires_torch.init(copy.deepcopy(SUBJECTS[0]), _sett(**kw))
    since = trace.serial()
    res = t_fit(x, y, sett) if form == "fit" else fit_batch([x], [y],
                                                              sett)[0]
    return x, res, trace.spans(since=since)


def test_a_batch_of_one_is_the_single_fit_bitwise():
    """One subject through ``pipeline.fit.fit`` and through ``fit_batch``
    alone run the same stepper over the same iteration: bitwise equal
    volumes, rigid matrices, poses, scales, objective trace and ``n_iter``,
    and spans of the same names and attribute keys."""
    (xa, a, spans_a), (xb, b, spans_b) = (_one_subject(d)
                                          for d in ("fit", "batch"))
    assert all(torch.equal(ca.dat, cb.dat) for ca, cb in zip(a[0], b[0]))
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[3], b[3])
    assert a[4] == b[4] == 8 and a[3].shape == (8, 3)
    for oa, ob in zip((o for xc in xa for o in xc),
                      (o for xc in xb for o in xc)):
        np.testing.assert_array_equal(oa.rigid_q, ob.rigid_q)
        assert oa.po.scl == ob.po.scl
    assert sorted((s.name, sorted(s.attrs)) for s in spans_a) == sorted(
        (s.name, sorted(s.attrs)) for s in spans_b)
    assert {s.name for s in spans_a} == {"fit", "fit.setup", "fit.chunk",
                                         "fit.chunk.launch",
                                         "fit.chunk.read", "fit.finish"}
    fit, = [s for s in spans_a if s.name == "fit"]
    assert set(fit.attrs) == {"B", "n_iter", "syncs", "method", "stencils",
                              "resamples", "blurs", "gn_stats"}


@pytest.mark.parametrize("form", ["fit", "batch"])
def test_the_chunk_gets_the_same_state_and_data_at_every_step(form,
                                                              monkeypatch):
    """Across the chunks of one fit the stepper hands the chunk the same
    state object and the same data tensors, the key on which a captured
    chunk decides to capture anew: a captured fit captures once."""
    keys = []
    call = FitChunk.__call__

    def spy(self, st, xdats, subdats=None, n=None):
        keys.append((id(st), tuple(d.data_ptr() for xc in xdats for d in xc),
                     tuple(0 if d is None else d.data_ptr()
                           for d in subdats or ())))
        return call(self, st, xdats, subdats, n)

    monkeypatch.setattr(FitChunk, "__call__", spy)
    _, res, _ = _one_subject(form, max_iter=6, chunk_iters=2, tolerance=0)
    assert res[4] == 6 and len(keys) == 3 and len(set(keys)) == 1


def test_fit_batch_logs_one_line_per_round(capsys):
    xs, ys, sett = _inits(unires_torch, SUBJECTS, max_iter=2)
    sett.do_print = 1
    sett.chunk_iters = 1  # a round is a chunk: two of one iteration each
    fit_batch(xs, ys, sett)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("batch-fit:")]
    assert len(lines) == 2
    assert lines[-1].startswith("batch-fit: iter<= 2 done 2/2 obj0 ")


def test_preproc_batch_puts_subject_1_on_subject_0s_grid(tmp_path):
    """Subject 1 lies 3.3 mm off in the scanner; with ``force_y_space``
    from subject 0 both reconstructions share subject 0's grid and affine."""
    from unires_torch.pipeline.nifti import load, save

    subjects = []
    for b in range(2):
        grp = []
        for c, (arr, mat) in enumerate(_subject_data(b)):
            mat = mat.copy()
            mat[0, 3] += 3.3 * b
            p = str(tmp_path / f"s{b}_c{c}.nii")
            save(arr, p, affine=mat)
            grp.append(p)
        subjects.append(grp)
    sett = _sett(max_iter=2, scaling=False, unified_rigid=False,
                 write_out=True, dir_out=str(tmp_path / "out"))
    res = unires_torch.preproc_batch(subjects, sett)
    assert sett.shard == "batch" and len(res) == 2
    (d0, m0, p0), (d1, m1, p1) = res
    assert d0.shape == d1.shape and d0.shape[-1] == 2
    np.testing.assert_array_equal(m0, m1)
    assert [p.rsplit("/", 1)[1] for p in p0 + p1] == [
        "u_s0_c0.nii", "u_s0_c1.nii", "u_s1_c0.nii", "u_s1_c1.nii"]
    for p, want in zip(p0 + p1, (d0[..., 0], d0[..., 1], d1[..., 0],
                                 d1[..., 1])):
        got, hdr = load(p)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(hdr.affine, m0, atol=1e-4)
    # alone, subject 1 gets a grid of its own
    x1, y1, _ = unires_torch.init(subjects[1], _sett(max_iter=0))
    assert not np.allclose(y1[0].mat, m0, atol=1e-3)
