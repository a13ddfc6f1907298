"""What the fit chunk computes on the device instead of the host, against
the host's versions and the JAX package's.

* The push plan (``ops.resample.push_plan``, float64 torch ops) against
  the host's ``push_window`` / ``push_reach`` / ``inverse_map`` on 200
  seeded random rigid maps (with a scale per axis) and the fit's maps:
  equal windows and equal float32 bits of the reach and the inverse.
* The float64 torch Lie functions (``ops.lie``) against the port's scipy
  ``expm`` / ``dexpm`` and numpy ``inv44`` / ``compose_maps`` (1e-12
  absolute on entries of order 1 to 100; the maps' float32 bits equal), and
  against the JAX package's float32 ``ops/lie.py``: 2e-5 absolute (its
  float32 rounding). JAX differentiates its float32 closed form, which
  loses digits to cancellation at small angles (up to 2e-2 off the exact
  derivative at the fit's poses, measured against scipy): there the port's
  difference to JAX is scipy's difference to JAX, to 1e-6.
* The wrappers with maps given as tensors (the CPU path reads them as the
  host maps) and with the push plan as ``Minv``: bitwise equal.
* ``utils.graph.cond`` on the CPU: one counted read per decision.
* One co-registration level's loss and gradient (``_NMILevel.vg``, device
  tensors), its histogram summed chunk by chunk, against the formula it
  replaced (every chunk's weights held at once, autograd through the whole
  histogram), written out below, on levels of two and of nine chunks: the
  same float32 roundings, so equal to 1e-6 relative (measured: the loss
  and the cotangent bitwise, the gradient, whose float64 exponential and
  contraction are now torch's, to 6e-16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unires_torch.geometry import (affine_basis, affine_diag,
                                   affine_matrix_classic, dexpm, expm)
from unires_torch.models.proj_op import proj_info
from unires_torch.ops import lie as tlie
from unires_torch.ops import resample as tr
from unires_torch.pipeline import registration as treg
from unires_torch.utils.graph import cond
from unires_torch.utils.host import to_host
from unires_tpu.ops import lie as jlie

torch.set_num_threads(2)

SRC, TGT = (40, 50, 30), (30, 41, 29)


def _random_maps(n=200, seed=0):
    """(3, 4) float32 maps: rigid (+-5 mm, +-0.5 rad) times a scale per
    axis in [0.3, 4]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = np.r_[rng.uniform(-5, 5, 3), rng.uniform(-0.5, 0.5, 3)]
        A = affine_matrix_classic(p) @ affine_diag(rng.uniform(0.3, 4.0, 3))
        out.append(tr.affine_to_M(A))
    return out


def _fit_maps():
    """The fit's maps: a 4 mm observation of the 181x217x181 grid at a
    ~1 degree pose, pull's map (super-resolution) and its reslice."""
    po = proj_info((181, 217, 181), np.eye(4), (181, 217, 46),
                   affine_diag([1.0, 1.0, 4.0]),
                   rigid=affine_matrix_classic([1.0, -0.7, 0.6, 0.017,
                                                -0.012, 0.01]),
                   prof_ip=2, prof_tp=0)
    return [(tr.affine_to_M(po.M_sr()), po.dim_yx, po.dim_y),
            (tr.affine_to_M(np.linalg.solve(po.mat_x, po.mat_y)), po.dim_y,
             po.dim_x)]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("given_minv", [False, True])
def test_device_push_plan_equals_the_host_plan(order, given_minv):
    cases = [(M, SRC, TGT) for M in _random_maps()] + _fit_maps()
    for M, src, tgt in cases:
        Minv = tr.inverse_map(M)
        host = tr._push_plan(M.tobytes(),
                             Minv.tobytes() if given_minv else None, order,
                             tuple(src), tuple(tgt))
        dev = tr.push_plan(torch.from_numpy(M),
                           torch.from_numpy(Minv) if given_minv else None,
                           order, src, tgt).numpy()
        assert tuple(dev[27:30]) == tr.push_window(M)
        np.testing.assert_array_equal(dev[12:24], Minv.ravel())
        np.testing.assert_array_equal(
            dev[24:27].view(np.uint32),
            tr.push_reach(M, Minv, order, src, tgt).view(np.uint32))
        np.testing.assert_array_equal(dev.view(np.uint32),
                                      host.view(np.uint32))


def test_device_push_plan_is_batched():
    maps = np.stack(_random_maps(7, seed=4))
    one = [tr.push_plan(torch.from_numpy(M), None, 1, SRC, TGT)
           for M in maps]
    assert torch.equal(tr.push_plan(torch.from_numpy(maps), None, 1, SRC, TGT),
                       torch.stack(one))


def _poses(n=40, seed=1):
    """SE(3) parameters from 1e-7 to tens of mm / about a radian."""
    rng = np.random.default_rng(seed)
    return [np.r_[rng.uniform(-10, 10, 3), rng.uniform(-1, 1, 3)]
            * 10.0 ** rng.uniform(-7, 0) for _ in range(n)]


def test_lie_functions_match_scipy():
    B = affine_basis("SE")
    Bt = torch.from_numpy(B)
    qs = _poses()
    Q = torch.from_numpy(np.stack(qs))
    R_all = tlie.se3_expm(Q, Bt).numpy()  # batched
    R2_all, dR_all = (t.numpy() for t in tlie.se3_dexpm(Q, Bt))
    for q, R, R2, dR in zip(qs, R_all, R2_all, dR_all):
        R_h, dR_h = dexpm(q, B)
        np.testing.assert_allclose(R, expm(q, B), rtol=0, atol=1e-12)
        np.testing.assert_allclose(R2, R_h, rtol=0, atol=1e-12)
        np.testing.assert_allclose(dR, dR_h, rtol=0, atol=1e-12)
    # any basis: the CSO group (rigid + isotropic scale)
    Bc = affine_basis("CSO")
    for q in qs[:10]:
        qc = np.r_[q, 0.05]
        got = tlie.group_expm(torch.from_numpy(qc), torch.from_numpy(Bc))
        np.testing.assert_allclose(got.numpy(), expm(qc, Bc), rtol=0,
                                   atol=1e-12)


def test_inv44_and_compose_maps_match_numpy():
    rng = np.random.default_rng(2)
    B = affine_basis("SE")
    for q in _poses(20, seed=3):
        pre = np.linalg.inv(affine_diag(rng.uniform(0.5, 2.0, 3))
                            @ affine_matrix_classic(rng.uniform(-40, 40, 3)))
        post = affine_matrix_classic(rng.uniform(-90, 90, 3)) @ affine_diag(
            [1.0, 1.0, 4.0])
        R = expm(q, B)
        M4 = pre @ R @ post
        np.testing.assert_allclose(tlie.inv44(torch.from_numpy(M4)).numpy(),
                                   tlie.inv44(M4), rtol=1e-13, atol=1e-12)
        M, Minv = tlie.compose_maps(torch.from_numpy(pre), torch.from_numpy(R),
                                    torch.from_numpy(post))
        Mh, Minvh = tlie.compose_maps(pre, R, post)
        assert M.dtype == torch.float32 and M.is_contiguous()
        np.testing.assert_array_equal(M.numpy(), Mh)
        np.testing.assert_array_equal(Minv.numpy(), Minvh)


def test_lie_functions_match_jax():
    B = affine_basis("SE")
    Bj = jnp.asarray(B, jnp.float32)
    Bt = torch.from_numpy(B)
    for q in _poses(20, seed=5):
        q = q * 0.1  # the fit's poses: mm and tens of mrad
        np.testing.assert_allclose(
            tlie.se3_expm(torch.from_numpy(q), Bt).numpy(),
            np.asarray(jlie.se3_expm(jnp.asarray(q, jnp.float32), Bj)),
            rtol=0, atol=2e-5)
        q32 = q.astype(np.float32).astype(np.float64)  # JAX's input
        R, dR = tlie.se3_dexpm(torch.from_numpy(q32), Bt)
        dRj = np.asarray(jlie.se3_dexpm(jnp.asarray(q32, jnp.float32),
                                        Bj)[1], np.float64)
        np.testing.assert_allclose(dR.numpy() - dRj, dexpm(q32, B)[1] - dRj,
                                   rtol=0, atol=1e-6)
        X = np.einsum("k,kij->ij", q, B)
        np.testing.assert_allclose(
            tlie.expm44(torch.from_numpy(X)).numpy(),
            np.asarray(jlie.expm44(jnp.asarray(X, jnp.float32))), rtol=0,
            atol=2e-5)
        M4 = affine_matrix_classic([20.0, -10.0, 5.0]) @ R.numpy()
        np.testing.assert_allclose(
            tlie.inv44(torch.from_numpy(M4)).numpy(),
            np.asarray(jlie.inv44(jnp.asarray(M4, jnp.float32))), rtol=1e-5,
            atol=2e-5)


def test_wrappers_take_maps_as_tensors():
    """On the CPU a wrapper reads a tensor map as the host map, and push
    takes the maps' plan as ``Minv``: bitwise the host maps' results."""
    rng = np.random.default_rng(6)
    vol = torch.from_numpy(rng.random(TGT, dtype=np.float32))
    vals = torch.from_numpy(rng.random(SRC, dtype=np.float32))
    for M in _random_maps(3, seed=7):
        Mt = torch.from_numpy(M)
        Minv = tr.inverse_map(M)
        plan = tr.push_plan(Mt, torch.from_numpy(Minv), 1, SRC, TGT)
        assert torch.equal(tr.pull(vol, Mt, SRC), tr.pull(vol, M, SRC))
        assert torch.equal(tr.pull_grad(vol, Mt, SRC),
                           tr.pull_grad(vol, M, SRC))
        assert torch.equal(tr.push(vals, Mt, TGT, Minv=plan),
                           tr.push(vals, M, TGT, Minv=Minv))


def test_cond_reads_each_decision_once_on_the_cpu():
    ran = []
    n0 = to_host.syncs
    assert cond(torch.tensor(True), lambda: ran.append(1)) is True
    assert cond(torch.tensor(False), lambda: ran.append(2)) is False
    assert ran == [1] and to_host.syncs == n0 + 2


# --- one co-registration level: the histogram chunk by chunk --------------------

def _old_level(lev, q):
    """(loss, gradient) as the level computed them before: every chunk's
    fixed weights held at once, autograd through the whole histogram."""
    pre4, post4, basis = (t.numpy() for t in (lev.pre4, lev.post4, lev.basis))
    R, dR = dexpm(q, basis)
    M = tlie.compose_maps(pre4, R, post4)[0]
    fix = torch.cat(lev.fn)
    Wf = [treg._soft_weights(c) for c in torch.split(fix, treg._CHUNK)]
    movf = treg.pull(lev.mov, M, lev.fix_dim).reshape(-1).requires_grad_()
    with torch.enable_grad():
        mn = treg._normalise(movf, lev.mmin, lev.mmax)
        joint = None
        for W, c in zip(Wf, torch.split(mn, treg._CHUNK)):
            part = W @ treg._soft_weights(c).T
            joint = part if joint is None else joint + part
        joint = joint / torch.clamp(joint.sum(), min=1e-12)
        pf, pm = joint.sum(dim=1), joint.sum(dim=0)
        eps = 1e-12
        hf = -torch.sum(pf * torch.log(pf + eps))
        hm = -torch.sum(pm * torch.log(pm + eps))
        hj = -torch.sum(joint * torch.log(joint + eps))
        L = -(hf + hm) / torch.clamp(hj, min=eps)
        ct, = torch.autograd.grad(L, movf)
    pg = treg.pull_grad(lev.mov, M, lev.fix_dim)
    W = ct.reshape(lev.fix_dim)[None] * pg.permute(3, 0, 1, 2)
    mom = treg._moments(W, lev.coords, order=1).numpy()
    B = np.einsum("ij,kjl,lm->kim", pre4, dR, post4)
    ccf = B[:, :3, 3] + B[:, :3, :3] @ np.asarray(lev.center)
    g = ccf @ mom[:, 0] + np.einsum("kde,de->k", B[:, :3, :3], mom[:, 1:])
    return float(L), g, ct


@pytest.mark.parametrize("dim,chunk", [((44, 44, 40), 1 << 16),
                                       ((24, 24, 20), 1300)])
def test_coreg_level_chunked_matches_the_held_histogram(dim, chunk,
                                                        monkeypatch):
    monkeypatch.setattr(treg, "_CHUNK", chunk)
    n_chunks = -(-int(np.prod(dim)) // chunk)
    assert n_chunks in (2, 9)
    rng = np.random.default_rng(8)
    fix = torch.from_numpy(rng.random(dim, dtype=np.float32) * 100.0)
    ramp = np.linspace(0.0, 30.0, dim[2], dtype=np.float32)
    mov = torch.from_numpy(rng.random(dim, dtype=np.float32) * 50.0 + ramp)
    pre4 = np.linalg.inv(affine_matrix_classic([0.4, -0.3, 0.2]))
    lev = treg._NMILevel(fix, mov, pre4, np.eye(4))
    for q in (np.zeros(6), np.array([0.5, 0.2, -0.3, 0.01, 0.02, -0.015])):
        loss, g = lev.vg(torch.from_numpy(q))
        loss, g = float(loss), g.numpy()
        loss_old, g_old, ct_old = _old_level(lev, q)
        assert loss == pytest.approx(loss_old, rel=1e-6)
        np.testing.assert_allclose(g, g_old, rtol=1e-6,
                                   atol=1e-6 * np.abs(g_old).max())
        R, _ = dexpm(q, lev.basis.numpy())
        M = tlie.compose_maps(lev.pre4.numpy(), R, lev.post4.numpy())[0]
        _, ct = lev._loss_cotangent(
            treg.pull(lev.mov, M, lev.fix_dim).reshape(-1))
        np.testing.assert_allclose(ct.numpy(), ct_old.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(ct_old.abs().max()))
