"""The port's batched fit chunk (``unires_torch.solvers.fitloop.
make_batch_chunk``): a geometry-homogeneous batch stacked on a leading
subject axis, one chunk for all its subjects.

Subjects: 2 channels of a 16x16x17 blob phantom, each with two repeats
(thick along z and along x, 4 mm; with one observation per channel a pose
is barely identifiable early on, and every line search rejects), each
repeat at its own rigid misalignment with even/odd scaling 0.1, subject b
drawn from seed b, every subject on subject 0's recon grid.
Each is initialised by the JAX pipeline with the true image resliced onto
the grid as the start (so the rigid updates move the poses from their
first round) and carried into the port by ``convert_state``, so that the
port's and the JAX package's chunks start from the same volumes, poses and
geometry. Scaling and unified rigid are on.

Tolerances: a subject of the port's batch against its own single chunk,
those of tests/test_torch_batch.py (n_iter and ``valid`` exactly, traces
rtol 1e-6, volumes 1e-5 of their scale, q and scl atol 1e-6); a subject
alone (B = 1) and the frozen subject of a batch bitwise; against the JAX
``make_batch_chunk`` (its ``vmap`` on one device), those of
tests/test_fit_batch.py and tests/test_torch_fitchunk.py (traces rtol
1e-4, gains atol 1e-4, q and scl rtol 1e-4 with a floor of 1e-6). The
batched plain resampling against per-volume calls bitwise; push's
adjointness per subject to 1e-5 relative.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import _disable_current_modes

import unires_tpu
from phantoms import blob_phantom, degrade
from test_torch_fitchunk import _NoHostRead
from unires_torch.ops.resample import (affine_to_M, pull, pull_grad,
                                       pull_grad_plain, pull_plain, push,
                                       push_plain, push_plan)
from unires_torch.pipeline.convert import convert_state
from unires_torch.pipeline.fit import gather_subdats as t_gather_subdats
from unires_torch.pipeline.fit import get_sched as t_get_sched
from unires_torch.solvers.cg import cg_batched
from unires_torch.solvers.fitloop import init_state as t_init_state
from unires_torch.solvers.fitloop import (make_batch_chunk, make_fit_chunk,
                                          stack_states, subject_state)
from unires_torch.utils.host import to_host
from unires_tpu.parallel.fit_batch import _batch_operands, _stack
from unires_tpu.parallel.fit_batch import make_batch_chunk as j_batch_chunk
from unires_tpu.pipeline.fit import get_sched as j_get_sched
from unires_tpu.solvers.fitloop import init_state as j_init_state

torch.set_num_threads(2)

K = 3
KW = dict(vx=1.0, do_coreg=False, do_print=0, max_iter=10, tolerance=0,
          write_out=False, unified_rigid=True, scaling=True, sched_num=0,
          reg_scl=4.0, cgs_max_iter=6)
DIM = (16, 16, 17)
# the state of tests/test_torch_fitchunk.py's NEAR_DONE: on the last
# schedule step, past the convergence test's 20 iterations, at the last
# iteration before max_iter, one countdown step from done; it converges at
# its first iteration and is frozen for the rest of the chunk
NEAR_DONE = dict(cnt_scl=0, cnt_scl_iter=25, countdown0=1, has_prev=True,
                 n_iter=KW["max_iter"] - 1)


def _subject(seed, ref=None):
    """JAX init of subject ``seed`` (on ``ref``'s grid when given) and its
    port conversion: ((xj, yj, sj), (xt, yt, st))."""
    rng = np.random.default_rng(seed)
    gt = blob_phantom(dim=DIM, amplitude=1000.0, seed=seed)
    chans = []
    for c in range(2):
        repeats = []
        for ax in (2, 0):
            rp = (list(rng.uniform(-0.9, 0.9, 3))
                  + list(rng.uniform(-0.02, 0.02, 3)))
            x, mat, _ = degrade(gt, thick_axis=ax, thick=4.0, noise_sd=5.0,
                                seed=10 * seed + 3 * c + ax, scl=0.1,
                                rigid_params=rp)
            repeats.append([np.asarray(x), mat])
        chans.append(repeats)
    kw = dict(KW) if ref is None else dict(
        KW, force_y_space=(ref[0].mat, ref[0].dim))
    xj, yj, sj = unires_tpu.init(chans, unires_tpu.Settings(**kw))
    on_grid = pull(torch.from_numpy(gt), affine_to_M(yj[0].mat),
                   tuple(int(d) for d in yj[0].dim)).numpy()
    for yc in yj:
        yc.dat = jnp.asarray(on_grid)
    sj = j_get_sched(2, sj)
    xt, yt, st = convert_state(xj, yj, sj, "cpu")
    st = t_get_sched(2, st)
    return (xj, yj, sj), (xt, yt, st)


@pytest.fixture(scope="module")
def subjects():
    first = _subject(0)
    return [first] + [_subject(s, ref=first[0][1]) for s in (1, 2)]


def _xdats(x):
    return [[o.dat for o in xc] for xc in x]


def _single(subject, K_=K, **kw):
    """The port's single chunk of one subject: (state, objs, gains,
    valid) after one call of K_ iterations."""
    xt, yt, st = copy.deepcopy(subject[1])
    chunk = make_fit_chunk(xt, yt, st, K_)
    state = t_init_state(xt, yt, st, **kw)
    _, objs, gains, valid = chunk(state, _xdats(xt),
                                  t_gather_subdats(xt, chunk.subs))
    return state, objs.clone(), gains.clone(), valid.clone()


def _batch(subs, K_=K, kws=None, calls=1):
    """The port's batched chunk of ``subs``: (chunk, stacked state, xdats,
    subdats, [(objs, gains, valid)] per call)."""
    xs, ys, ss = (list(t) for t in zip(*copy.deepcopy([s[1] for s in subs])))
    chunk = make_batch_chunk(xs, ys, ss[0], K_)
    kws = kws or [{}] * len(subs)
    state = stack_states([t_init_state(xb, yb, ss[0], **kw)
                          for xb, yb, kw in zip(xs, ys, kws)])
    xdats = [[torch.stack([xb[c][n].dat for xb in xs])
              for n in range(len(xs[0][c]))] for c in range(len(xs[0]))]
    subdats = [None if d[0] is None else torch.stack(d) for d in zip(*[
        t_gather_subdats(xb, subs_b)
        for xb, subs_b in zip(xs, chunk.subs_of)])]
    outs = []
    for _ in range(calls):
        _, objs, gains, valid = chunk(state, xdats, subdats)
        outs.append((objs.clone(), gains.clone(), valid.clone()))
    return chunk, state, xdats, subdats, outs


def _tensors(state):
    return {k: v for k, v in vars(state).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("B", [2, 3])
def test_batch_matches_each_single_chunk(subjects, B):
    _, state, _, _, [(objs, gains, valid)] = _batch(subjects[:B])
    assert objs.shape == (B, K, 3) and valid.shape == (B, K)
    for b in range(B):
        st1, objs1, gains1, valid1 = _single(subjects[b])
        stb = subject_state(state, b)
        assert int(stb.n_iter) == int(st1.n_iter) == K
        np.testing.assert_array_equal(valid[b].numpy(), valid1.numpy())
        np.testing.assert_allclose(objs[b].numpy(), objs1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(gains[b].numpy(), gains1.numpy(),
                                   rtol=1e-6, atol=1e-9)
        for name in ("ys", "z", "w", "jtv"):
            got, want = getattr(stb, name), getattr(st1, name)
            assert float((got - want).abs().max()) <= \
                1e-5 * float(want.abs().max()), name
        np.testing.assert_allclose(stb.q.numpy(), st1.q.numpy(), atol=1e-6)
        np.testing.assert_allclose(stb.scl.numpy(), st1.scl.numpy(),
                                   atol=1e-6)
    assert float(np.abs(state.q.numpy()).max()) > 0.05  # the poses moved
    # the subjects differ, so a batch that mixed them up would show
    assert not torch.allclose(objs[0], objs[1], rtol=1e-3)


def test_batch_of_one_is_the_single_chunk_bitwise(subjects):
    """B = 1: the stacked chunk runs the single fit's iteration, operation
    for operation."""
    _, state, _, _, [(objs, gains, valid)] = _batch(subjects[:1])
    st1, objs1, gains1, valid1 = _single(subjects[0])
    assert torch.equal(objs[0], objs1) and torch.equal(gains[0], gains1)
    assert torch.equal(valid[0], valid1)
    t1, tb = _tensors(st1), _tensors(subject_state(state, 0))
    for k in t1:
        assert torch.equal(tb[k], t1[k]), k


def test_batch_matches_jax_batch_chunk(subjects):
    """Two subjects through the JAX ``make_batch_chunk`` on a one-device
    mesh (its ``vmap`` of the chunk) and through the port's."""
    subs = subjects[:2]
    xs, ys = [s[0][0] for s in subs], [s[0][1] for s in subs]
    sj = subs[0][0][2]
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("batch",))
    chunk = j_batch_chunk(xs, ys, sj, K, mesh)
    state = _stack([j_init_state(xb, yb, sj) for xb, yb in zip(xs, ys)])
    stj, objs_j, gains_j, valid_j = chunk(state, *_batch_operands(xs, sj))
    _, st, _, _, [(objs, gains, valid)] = _batch(subs)
    np.testing.assert_allclose(objs.numpy(), np.asarray(objs_j, np.float64),
                               rtol=1e-4)
    np.testing.assert_allclose(gains.numpy(), np.asarray(gains_j, np.float64),
                               atol=1e-4)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    np.testing.assert_array_equal(st.n_iter.numpy(), np.asarray(stj.n_iter))
    for got, want in ((st.q, stj.q), (st.scl, stj.scl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64),
                                   rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def converging(subjects):
    """Subject 0 converges at its first iteration, subject 1 runs on: a
    batched chunk of 3 and one of 1, and subject 1's single chunk."""
    kws = [NEAR_DONE, {}]
    three = _batch(subjects[:2], 3, kws)
    one = _batch(subjects[:2], 1, kws)
    return three, one, _single(subjects[1], 3)


def test_converged_subject_is_frozen_bitwise(converging):
    """Subject 0's two frozen iterations are not valid and leave its state
    bitwise as its one live iteration left it."""
    (_, st3, _, _, [(_, _, valid3)]), (_, st1, _, _, [(_, _, valid1)]), _ = \
        converging
    np.testing.assert_array_equal(valid3[0].numpy(), [True, False, False])
    assert bool(valid1[0].all())
    a, b = _tensors(subject_state(st3, 0)), _tensors(subject_state(st1, 0))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert bool(st3.done[0]) and int(st3.n_iter[0]) == KW["max_iter"]


def test_other_subject_runs_on_past_the_converged_one(converging):
    (_, st3, _, _, [(objs3, _, valid3)]), _, (st, objs, _, valid) = converging
    np.testing.assert_array_equal(valid3[1].numpy(), valid.numpy())
    assert bool(valid3[1].all()) and not bool(st3.done[1])
    np.testing.assert_allclose(objs3[1].numpy(), objs.numpy(), rtol=1e-6)
    np.testing.assert_allclose(subject_state(st3, 1).q.numpy(), st.q.numpy(),
                               atol=1e-6)


def test_batch_read_is_one_host_read(subjects):
    """``read`` returns every subject's rows, q, scl and scalars in one
    read, equal to the tensors it read; ``subject_state`` gives each
    subject's host values as a single fit's state holds them."""
    chunk, state, _, _, [(objs, gains, valid)] = _batch(subjects[:2])
    n0 = to_host.syncs
    out = chunk.read(state, K)
    assert to_host.syncs == n0 + 1
    np.testing.assert_array_equal(out["objs"], objs.numpy())
    np.testing.assert_array_equal(out["gains"], gains.numpy())
    np.testing.assert_array_equal(out["valid"], valid.numpy())
    np.testing.assert_array_equal(out["q"], state.q.numpy())
    assert out["q"].shape == (2, 4, 6) and out["scl"].shape == (2, 4)
    np.testing.assert_array_equal(out["n_iter"], [K, K])
    h = subject_state(state, 1).host
    assert h["n_iter"] == K and h["done"] is False
    np.testing.assert_array_equal(h["q"], state.q[1].numpy())


def test_batch_iteration_reads_nothing_but_its_decisions(subjects,
                                                         monkeypatch):
    """Three iterations of a batch of two (rigid and scaling on) under the
    dispatch mode of tests/test_torch_fitchunk.py that fails on any host
    read: the only reads are ``utils.graph.cond``'s, which a captured graph
    takes on the device."""
    from unires_torch.utils import graph as ugraph

    def decision(t):
        with _disable_current_modes():
            return to_host(t)

    monkeypatch.setattr(ugraph, "to_host", decision)
    chunk, state, xdats, subdats, _ = _batch(subjects[:2], calls=0)
    with _NoHostRead():
        for _ in range(3):
            chunk.iterate(state, xdats, subdats)
    assert state.n_iter.tolist() == [3, 3]
    assert float(state.q.abs().max()) > 0.05


# --- the batched resampling (the CPU runs the plain versions) ----------------

def _maps(rng, B):
    out = []
    for _ in range(B):
        lin = np.eye(3) + 0.08 * rng.standard_normal((3, 3))
        out.append(np.hstack([lin, rng.uniform(-1.5, 1.5, (3, 1))]))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("name", ["pull", "push", "pull_grad"])
def test_batched_plain_equals_per_volume(name):
    """A batch of 3 volumes (the second read through a strided view of a
    stack, as a channel of the fit's state) against per-volume calls,
    bitwise, through the public wrapper and the plain version."""
    rng = np.random.default_rng(4)
    in_dim, out_dim = (11, 12, 13), (10, 13, 12)
    Ms = _maps(rng, 3)
    src = in_dim if name != "push" else out_dim
    stack = torch.from_numpy(rng.random((3, 2) + src, dtype=np.float32))
    vols = stack[:, 1]  # strided: each volume contiguous
    if name == "push":
        plans = push_plan(torch.from_numpy(Ms), None, 1, out_dim, in_dim)
        got = push(vols, Ms, in_dim, Minv=plans)
        plain = push_plain(vols, Ms, in_dim, Minv=plans)
        want = torch.stack([push(vols[b], Ms[b], in_dim, Minv=plans[b])
                            for b in range(3)])
    else:
        fn, fn_plain = ((pull, pull_plain) if name == "pull"
                        else (pull_grad, pull_grad_plain))
        got, plain = fn(vols, Ms, out_dim), fn_plain(vols, Ms, out_dim)
        want = torch.stack([fn(vols[b], Ms[b], out_dim) for b in range(3)])
    assert got.shape[0] == 3 and float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(plain, want)


def test_batched_push_is_the_adjoint_per_subject():
    rng = np.random.default_rng(5)
    in_dim, out_dim = (11, 12, 13), (10, 13, 12)
    Ms = _maps(rng, 3)
    u = torch.from_numpy(rng.random((3,) + in_dim, dtype=np.float32))
    v = torch.from_numpy(rng.random((3,) + out_dim, dtype=np.float32))
    Pu = pull(u, Ms, out_dim).double()
    Ptv = push(v, Ms, in_dim).double()
    for b in range(3):
        lhs = float((Pu[b] * v[b].double()).sum())
        rhs = float((u[b].double() * Ptv[b]).sum())
        assert abs(lhs - rhs) <= 1e-5 * abs(lhs), b


def test_cg_groups_solve_each_run_as_alone():
    """``cg_batched`` over two runs of 2 entries (``groups=2``), the second
    run frozen from the start (``live``): the first run's iterates equal
    its solve alone bitwise, the frozen run stays at x0."""
    from unires_torch.ops.finite_diff import im_divergence, im_gradient

    rng = np.random.default_rng(6)
    dim = (7, 8, 9)
    d = torch.from_numpy(rng.uniform(0.5, 2.0, (4,) + dim).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4,) + dim).astype(np.float32))
    x0 = torch.from_numpy(
        (0.1 * rng.standard_normal((4,) + dim)).astype(np.float32))
    vx = (1.0, 1.0, 1.0)

    def A_of(dd):
        return lambda V: dd * V + 0.3 * im_divergence(im_gradient(V, vx), vx)

    live = torch.tensor([True, True, False, False])
    got = cg_batched(A_of(d), b, x0, max_iter=30, tol=1e-4,
                     precond=lambda v: v / d, groups=2, live=live)
    want = cg_batched(A_of(d[:2]), b[:2], x0[:2], max_iter=30, tol=1e-4,
                      precond=lambda v: v / d[:2])
    assert torch.equal(got[:2], want)
    assert torch.equal(got[2:], x0[2:])
