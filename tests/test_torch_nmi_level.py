"""The port's device-resident NMI level optimiser
(``pipeline.registration.NMILevelOpt``, one CUDA graph with a WHILE node per
level on the card) on the CPU, where the same code runs uncaptured.

* One coarse level (a blob pair on a 4 mm grid) against the JAX package's
  ``_nmi_opt_cached`` (its XLA path), SE and CSO: the two descents take the
  same accept / reject decisions on float32 losses only up to near-ties
  (JAX keeps q in float32, the port in float64), so q agrees to 0.05 mm /
  2e-3 (rotations, log-scale) and the final loss to 1e-4 relative.
* The movers of a level batched in one optimiser against each mover alone:
  bit for bit (each mover's arithmetic is its own; the batch only waits
  for its slowest mover).
* The descent against the host loop it replaced (``_descend``, copied below
  as the oracle, evaluating through the same level): the same number of
  evaluations and q to 1e-6 relative (measured: bitwise).
* ``ops.lie.group_dexpm`` against scipy's Frechet derivative
  (``geometry.dexpm``) to 1e-12 and the JAX package's ``jacfwd`` of its
  float32 ``group_expm`` to 2e-5 (float32 rounding).
* ``utils.graph.while_loop`` on the CPU: one counted host read per turn
  and one to stop.
* One descent turn, and a whole level, under a dispatch mode that fails on
  any host read (the CPU's proxy for "can be captured"): the only reads
  are the decisions of ``utils.graph``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from phantoms import blob_phantom
from test_torch_fitchunk import _NoHostRead
from unires_torch.geometry import (affine_basis, affine_diag,
                                   affine_translation, dexpm)
from unires_torch.ops import lie as tlie
from unires_torch.pipeline import registration as treg
from unires_torch.utils import graph as ugraph
from unires_torch.utils import trace
from unires_torch.utils.host import to_host
from unires_tpu.ops import lie as jlie
from unires_tpu.pipeline import registration as jreg

torch.set_num_threads(2)

DIM = (22, 24, 20)
MAT = affine_diag([4.0, 4.0, 4.0])
Q_TRUE = {"SE": np.array([3.0, -2.0, 1.5, 0.03, -0.02, 0.025]),
          "CSO": np.array([3.0, -2.0, 1.5, 0.03, -0.02, 0.025, 0.05])}


@pytest.fixture(scope="module")
def blobs():
    """A blob volume and a differently contrasted noisy copy."""
    gt = blob_phantom(dim=DIM, amplitude=1000.0, seed=7)
    rng = np.random.default_rng(7)
    mov = (1500.0 * np.sqrt(gt / 1000.0)).astype(np.float32)
    mov = mov + 15.0 * rng.standard_normal(mov.shape).astype(np.float32)
    return gt.astype(np.float32), mov


def _factors(group, scale=1.0):
    """(pre4, post4) of the pair whose mover's header is displaced by
    ``scale`` times the true transform (centred at the fixed image's
    centre, as the level's exponential)."""
    wc = treg._fix_centre(DIM, MAT)
    C = treg.q_to_world(scale * Q_TRUE[group], group, wc)
    pre4 = np.linalg.inv(C @ MAT) @ affine_translation(wc)
    post4 = affine_translation(-wc) @ MAT
    return pre4, post4


def _level(blobs, group, scales=(1.0,), iters=150):
    gt, mov = blobs
    fix = torch.from_numpy(gt)
    post4 = _factors(group)[1]
    return treg.make_nmi_level(
        fix, [(torch.from_numpy(mov), _factors(group, s)[0]) for s in scales],
        post4, group, iters)


@pytest.mark.parametrize("group", ["SE", "CSO"])
def test_level_matches_jax_nmi_opt(blobs, group):
    gt, mov = blobs
    K = len(Q_TRUE[group])
    opt = _level(blobs, group)
    q, loss, evals = opt(np.zeros((1, K)))
    pre4, post4 = _factors(group)
    jopt = jreg._nmi_opt_cached(DIM, DIM, 64, 1 << 16, group, None, 150)
    qj, lj = jopt(jnp.zeros(K, jnp.float32), jnp.asarray(gt),
                  jnp.asarray(mov), jnp.asarray(pre4, jnp.float32),
                  jnp.asarray(post4, jnp.float32))
    qj = np.asarray(qj, np.float64)
    np.testing.assert_allclose(q[0, :3], qj[:3], atol=0.05)
    np.testing.assert_allclose(q[0, 3:], qj[3:], atol=2e-3)
    assert loss[0] == pytest.approx(float(lj), rel=1e-4)
    # both recover the displacement the 4 mm grid resolves
    np.testing.assert_allclose(q[0, :3], Q_TRUE[group][:3], atol=0.5)
    assert evals[0] > 10 and opt.stats["turns"] == evals[0] - 1


def test_batched_movers_equal_each_mover_alone(blobs):
    scales = (1.0, -0.7, 0.4)
    opt = _level(blobs, "SE", scales)
    q0 = np.array([[0.2, 0.0, -0.1, 0.0, 0.01, 0.0], np.zeros(6),
                   [0.0, 0.3, 0.0, -0.01, 0.0, 0.0]])
    q, loss, evals = opt(q0)
    assert len(set(evals.tolist())) > 1  # the movers stop at different turns
    assert opt.stats["turns"] == evals.max() - 1
    for i, s in enumerate(scales):
        qi, li, ei = _level(blobs, "SE", (s,))(q0[i:i + 1])
        np.testing.assert_array_equal(qi[0], q[i])
        assert li[0] == loss[i] and ei[0] == evals[i]


@pytest.mark.parametrize("entry,group", [("affine_align", "SE"),
                                         ("register_pair", "CSO")])
def test_registration_reports_each_level(blobs, entry, group):
    """A registration leaves one ``registration.level`` span per level, in
    order, with the level's figures, after one ``registration.pyramid``;
    a second run gives the same result."""
    gt, mov = blobs
    fix, mv = torch.from_numpy(gt), torch.from_numpy(mov)
    C = treg.q_to_world(Q_TRUE[group], group, treg._fix_centre(DIM, MAT))

    def run():
        if entry == "affine_align":
            return treg.affine_align([(fix, MAT), (mv, C @ MAT)],
                                     levels=(16.0,), samp=8)
        return treg._register_pair(fix, MAT, mv, C @ MAT,
                                   np.zeros(len(Q_TRUE[group])), (16.0, 8.0),
                                   7.0, maxiter=20, group=group)[0]

    since = trace.serial()
    out = run()
    np.testing.assert_array_equal(out, run())
    spans = trace.spans(since=since)
    pyramids = [s for s in spans if s.name == "registration.pyramid"]
    assert len(pyramids) == 2 and pyramids[0].attrs["mm"] == (16.0, 8.0)
    levels = [s for s in spans if s.name == "registration.level"
              and s.serial < pyramids[1].serial]
    assert [lv.serial > pyramids[0].serial for lv in levels] == [True] * 2
    stats = [lv.attrs for lv in levels]
    assert [lv["mm"] for lv in stats] == [16.0, 8.0]
    for span, lv in zip(levels, stats):
        assert lv["group"] == group and lv["movers"] == 1
        assert not lv["captured"] and lv["nodes"] is None
        assert lv["turns"] == max(lv["evals"]) - 1 > 0
        # per turn the loop's and the mover's condition; then the loop's
        # last (false) condition and the level's read
        assert lv["syncs"] == 2 * lv["turns"] + 2
        runs = [s for s in spans if s.parent == span.serial]
        assert [s.name for s in runs] == ["registration.level.run"]
        assert span.s >= runs[0].s > 0


def _descend(vg, q0, iters: int = 150):
    """The host loop the device descent replaced, with its evaluation count
    (the oracle: its loss and gradient read back at every evaluation)."""
    q = np.asarray(q0, np.float64)
    scale = treg._qscale(q.shape[0])
    loss, g = vg(q)
    step, it, no_prog, n_eval = 100.0, 0, 0, 1
    while it < iters and step > 1e-7 and no_prog < 12:
        cand = q - step * scale * scale * g
        new_loss, new_g = vg(cand)
        n_eval += 1
        accept = new_loss < loss
        prog = accept and (loss - new_loss > 1e-5 * abs(loss))
        no_prog = 0 if prog else no_prog + 1
        if accept:
            q, loss, g = cand, new_loss, new_g
        step = step * 1.4 if accept else step * 0.5
        it += 1
    return q, loss, n_eval


@pytest.mark.parametrize("group,iters", [("SE", 150), ("CSO", 30)])
def test_device_descent_matches_the_host_loop(blobs, group, iters):
    opt = _level(blobs, group, iters=iters)
    lev = opt.levels[0]

    def vg(q):
        L, g = lev.vg(torch.from_numpy(np.asarray(q, np.float64)))
        return float(L), g.numpy()

    K = len(Q_TRUE[group])
    q_h, loss_h, n_h = _descend(vg, np.zeros(K), iters)
    q, loss, evals = opt(np.zeros((1, K)))
    assert evals[0] == n_h
    np.testing.assert_allclose(q[0], q_h, rtol=1e-6,
                               atol=1e-6 * np.abs(q_h).max())
    assert loss[0] == pytest.approx(loss_h, rel=1e-6)


@pytest.mark.parametrize("group", ["SE", "CSO"])
def test_group_dexpm_matches_scipy_and_jax(group):
    basis = affine_basis(group)
    rng = np.random.default_rng(3)
    for _ in range(5):
        q = rng.normal(0.0, 1.0, basis.shape[0]) * np.r_[
            [5.0] * 3, [0.2] * (basis.shape[0] - 3)]
        R, dR = tlie.group_dexpm(torch.from_numpy(q), torch.from_numpy(basis))
        R_s, dR_s = dexpm(q, basis)
        np.testing.assert_allclose(R.numpy(), R_s, atol=1e-12)
        np.testing.assert_allclose(dR.numpy(), dR_s, atol=1e-12)
        jb = jnp.asarray(basis, jnp.float32)
        dR_j = jax.jacfwd(lambda qq: jlie.group_expm(qq, jb))(
            jnp.asarray(q, jnp.float32))
        np.testing.assert_allclose(
            dR.numpy(), np.moveaxis(np.asarray(dR_j, np.float64), -1, 0),
            atol=2e-5)


def test_while_loop_reads_its_predicate_once_per_turn():
    n = torch.zeros((), dtype=torch.int32)
    turns = []
    s0 = to_host.syncs
    ugraph.while_loop(lambda: n < 5, lambda: (n.add_(1), turns.append(1)))
    assert int(n) == 5 and len(turns) == 5
    assert to_host.syncs == s0 + 6  # five turns and the read that stops
    s0 = to_host.syncs
    ugraph.while_loop(lambda: n < 5, lambda: turns.append(2))
    assert len(turns) == 5 and to_host.syncs == s0 + 1


def test_descent_reads_nothing_but_its_decisions(blobs, monkeypatch):
    """A turn of two movers, then a whole level, under a mode that fails on
    any host read: the only reads are ``utils.graph``'s decisions, which a
    captured graph takes on the device."""
    decisions = []

    def decision(t):
        with _disable_current_modes():
            decisions.append(1)
            return to_host(t)

    monkeypatch.setattr(ugraph, "to_host", decision)
    opt = _level(blobs, "SE", (1.0, -0.5), iters=6)
    st = opt.st
    st.q0.copy_(torch.zeros(2, 6, dtype=torch.float64))
    with _NoHostRead():
        opt.run(st)
    assert int(st.turns) == 6 and (st.it == 6).all()
    n_run = len(decisions)
    assert n_run == 7 + 2 * 6  # 6 turns + the stop, one IF per mover a turn
    it0 = st.it.clone()
    st.live.fill_(True)
    with _NoHostRead():
        opt.turn(st)
    assert (st.it == it0 + 1).all() and len(decisions) == n_run + 2
