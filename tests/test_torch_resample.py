"""unires_torch.ops.resample against unires_tpu.ops.resample.

The port's pull/push/pull_grad on CPU tensors are the plain PyTorch versions;
here they are held against the JAX package's XLA oracles and, at one small
size each, against the Pallas kernels in interpret mode. Tolerances: rtol 1e-5 and
atol 1e-5 * max|input| (float32, the same operations in the same order up to
fused multiply-adds); adjointness relative 1e-5.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from unires_torch.ops import resample as tr
from unires_tpu.geometry import affine_diag, affine_matrix_classic
from unires_tpu.ops import resample as jr

torch.set_num_threads(2)

IN_DIM = (14, 15, 17)

# maps output voxel -> input voxel. Offsets keep sample points off the FOV
# knife-edge at exactly +-0.5, where one float32 rounding may flip a voxel
MAPS = [
    ("identity", np.eye(4), IN_DIM),
    ("sr", affine_diag([1.0, 1.0, 0.5]) @ affine_matrix_classic(
        [0.0, 0.0, -1.1]), (14, 15, 33)),
    ("rotated", affine_matrix_classic([0.6, -0.4, 0.3, 0.05, -0.03, 0.04]),
     (13, 16, 18)),
]


def _vol(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32) - 0.3


def _close(got, want, scale):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_pull_matches_jax(name, mat, out_dim, order):
    vol = _vol(IN_DIM, 0)
    M = tr.affine_to_M(mat)
    got = tr.pull(torch.from_numpy(vol), M, out_dim, order=order).numpy()
    want = np.asarray(jr.pull(jnp.asarray(vol), jnp.asarray(M), out_dim,
                              order=order))
    assert got.shape == tuple(out_dim)
    _close(got, want, np.abs(vol).max())


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_push_matches_jax_and_adjoint(name, mat, out_dim, order):
    vals = _vol(out_dim, 1)
    vol = _vol(IN_DIM, 2)
    M = tr.affine_to_M(mat)
    got = tr.push(torch.from_numpy(vals), M, IN_DIM, order=order).numpy()
    want = np.asarray(jr.push(jnp.asarray(vals), jnp.asarray(M), IN_DIM,
                              order=order))
    _close(got, want, np.abs(vals).max())
    # <pull u, v> = <u, push v>
    Ay = tr.pull(torch.from_numpy(vol), M, out_dim, order=order).numpy()
    lhs = float((Ay.astype(np.float64) * vals).sum())
    rhs = float((got.astype(np.float64) * vol).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_push_window_and_inverse_map_match_jax():
    for _, mat, _ in MAPS:
        M = tr.affine_to_M(mat)
        assert tr.push_window(M) == jr.push_window(M)
        M4 = np.eye(4)
        M4[:3, :4] = M
        np.testing.assert_array_equal(
            tr.inverse_map(M), np.linalg.inv(M4)[:3, :4].astype(np.float32))


@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_pull_grad_matches_jax(name, mat, out_dim):
    vol = _vol(IN_DIM, 3)
    M = tr.affine_to_M(mat)
    got = tr.pull_grad(torch.from_numpy(vol), M, out_dim).numpy()
    want = np.asarray(jr.pull_grad(jnp.asarray(vol), jnp.asarray(M), out_dim))
    assert got.shape == tuple(out_dim) + (3,)
    _close(got, want, np.abs(vol).max())


@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_matches_native_cpp_oracle(name, mat, out_dim):
    """The JAX package's independent C++ resampling trio (scatter-form push)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the C++ oracle")
    from unires_tpu.native import pull_grad_np, pull_np, push_np

    vol = _vol(IN_DIM, 9)
    vals = _vol(out_dim, 10)
    M = tr.affine_to_M(mat)
    _close(tr.pull(torch.from_numpy(vol), M, out_dim).numpy(),
           pull_np(vol, M, out_dim), np.abs(vol).max())
    want = push_np(vals, M, IN_DIM)  # sums in scatter order: scale by output
    _close(tr.push(torch.from_numpy(vals), M, IN_DIM).numpy(), want,
           np.abs(want).max())
    _close(tr.pull_grad(torch.from_numpy(vol), M, out_dim).numpy(),
           pull_grad_np(vol, M, out_dim), np.abs(vol).max())


# --- the fov override and the explicit push window ---------------------------
# Bounds in the input grid's voxels, in place of [-0.5, n - 0.5]: narrower
# than IN_DIM on every axis, and wider (sample points outside the volume then
# count, their outside corners weighing 0). Off the maps' sample points.
FOVS = [
    ("narrow", np.array([[1.2, 10.7], [2.3, 11.4], [0.8, 14.1]], np.float32)),
    ("wide", np.array([[-2.3, 15.6], [-1.7, 16.2], [-3.1, 18.4]], np.float32)),
]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("fov_name,fov", FOVS)
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_fov_pull_push_match_jax_and_adjoint(name, mat, out_dim, fov_name,
                                             fov, order):
    vol = _vol(IN_DIM, 40)
    vals = _vol(out_dim, 41)
    M = tr.affine_to_M(mat)
    got_pull = tr.pull(torch.from_numpy(vol), M, out_dim, order=order,
                       fov=fov).numpy()
    got_push = tr.push(torch.from_numpy(vals), M, IN_DIM, order=order,
                       fov=fov).numpy()
    _close(got_pull, np.asarray(jr.pull(jnp.asarray(vol), jnp.asarray(M),
                                        out_dim, order=order,
                                        fov=jnp.asarray(fov))),
           np.abs(vol).max())
    _close(got_push, np.asarray(jr.push(jnp.asarray(vals), jnp.asarray(M),
                                        IN_DIM, order=order,
                                        fov=jnp.asarray(fov))),
           np.abs(vals).max())
    # the override changes the result: some sample point is inside one set
    # of bounds and outside the other (the identity samples no point
    # outside the volume, so the wide bounds keep its mask)
    g = tr._sample_coords(M, out_dim, "cpu")
    same = torch.equal(tr._fov_mask(g, IN_DIM, fov), tr._fov_mask(g, IN_DIM))
    assert same == (name == "identity" and fov_name == "wide")
    lhs = float((got_pull.astype(np.float64) * vals).sum())
    rhs = float((got_push.astype(np.float64) * vol).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_default_fov_and_window_are_bitwise_the_defaults(name, mat, out_dim,
                                                         order):
    """fov=None and the explicit bounds [-0.5, n - 0.5] give the same bits,
    and so do push's default window and ``window=push_window(M)``."""
    vol = torch.from_numpy(_vol(IN_DIM, 42))
    vals = torch.from_numpy(_vol(out_dim, 43))
    M = tr.affine_to_M(mat)
    bounds = np.array([[-0.5, n - 0.5] for n in IN_DIM], np.float32)
    pull_none = tr.pull(vol, M, out_dim, order=order, fov=None)
    assert torch.equal(pull_none, tr.pull(vol, M, out_dim, order=order))
    assert torch.equal(pull_none, tr.pull(vol, M, out_dim, order=order,
                                          fov=bounds))
    push_none = tr.push(vals, M, IN_DIM, order=order)
    assert torch.equal(push_none, tr.push(vals, M, IN_DIM, order=order,
                                          fov=bounds))
    assert torch.equal(push_none, tr.push(vals, M, IN_DIM, order=order,
                                          window=tr.push_window(M)))


@pytest.mark.parametrize("name,mat,out_dim", MAPS[1:])
def test_small_window_drops_mass_as_jax(name, mat, out_dim):
    """A window smaller than the footprint drops the same mass as the JAX
    package's gather."""
    vals = _vol(out_dim, 44)
    M = tr.affine_to_M(mat)
    small = (0, 0, 0)  # the anchor alone
    got = tr.push(torch.from_numpy(vals), M, IN_DIM, window=small).numpy()
    want = np.asarray(jr.push(jnp.asarray(vals), jnp.asarray(M), IN_DIM,
                              window=small))
    _close(got, want, np.abs(vals).max())
    full = tr.push(torch.from_numpy(vals), M, IN_DIM).numpy()
    assert np.abs(full - got).max() > 1e-3 * np.abs(vals).max()


# --- the Pallas kernels the CUDA kernels replace, in interpret mode --------

PALLAS_IN = (16, 16, 24)
PALLAS_OUT = (14, 16, 26)
PALLAS_MAT = affine_matrix_classic([0.6, -0.4, 0.3, 0.03, -0.02, 0.025])


def test_pull_matches_pallas_shear_interpret():
    from unires_tpu.ops.pallas_resample import pallas_pull_shear, plan_pull_shear

    vol = _vol(PALLAS_IN, 4)
    M = tr.affine_to_M(PALLAS_MAT)
    plan = plan_pull_shear(PALLAS_IN, PALLAS_OUT, PALLAS_MAT[:3, :4])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_pull_shear(jnp.asarray(vol), jnp.asarray(M),
                                            PALLAS_OUT, plan))
    got = tr.pull(torch.from_numpy(vol), M, PALLAS_OUT).numpy()
    _close(got, want, np.abs(vol).max())


def test_push_matches_pallas_shear_interpret():
    from unires_tpu.ops.pallas_resample import pallas_push_shear, plan_push_shear

    vals = _vol(PALLAS_OUT, 5)
    M = tr.affine_to_M(PALLAS_MAT)
    Minv = tr.inverse_map(M)
    plan = plan_push_shear(PALLAS_OUT, PALLAS_IN, PALLAS_MAT[:3, :4])
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_push_shear(
            jnp.asarray(vals), jnp.asarray(M), jnp.asarray(Minv), PALLAS_IN,
            plan))
    got = tr.push(torch.from_numpy(vals), M, PALLAS_IN, Minv=Minv).numpy()
    _close(got, want, np.abs(vals).max())


# pull_grad against both Pallas pull_grad kernels, on the maps of
# tests/test_pallas_kernels.py. Where a sample coordinate sits within 1e-4 of
# an integer the trilinear gradient jumps between neighbouring cells, and one
# float32 rounding of the Pallas kernels' index arithmetic may pick the other
# cell: those elements (a measure-zero set, checked to stay under 2 %) are
# exempt, as in that file.
GRAD_AFFINES = [
    ("identity", np.eye(4)),
    ("shift", affine_matrix_classic([2.3, -1.7, 0.4])),
    ("smallrot", affine_matrix_classic([1.1, -0.6, 0.3, 0.02, -0.01, 0.015])),
    ("bigrot", affine_matrix_classic([0.5, 0.2, -0.3, 0.045, -0.04, 0.03])),
]


def _crossing(M, out_dim, eps=1e-4):
    ii, jj, kk = np.meshgrid(*(np.arange(d) for d in out_dim), indexing="ij")
    Mn = np.asarray(M, np.float64)
    near = np.zeros(out_dim, bool)
    for d in range(3):
        g = Mn[d, 0] * ii + Mn[d, 1] * jj + Mn[d, 2] * kk + Mn[d, 3]
        near |= np.abs(g - np.round(g)) < eps
    return near


@pytest.mark.parametrize("kind", ["shear", "plain"])
@pytest.mark.parametrize("name,mat", GRAD_AFFINES)
def test_pull_grad_matches_pallas_interpret(name, mat, kind):
    from unires_tpu.ops import pallas_resample as pr

    vol = _vol(PALLAS_IN, 11)
    M = tr.affine_to_M(mat)
    with pltpu.force_tpu_interpret_mode():
        if kind == "shear":
            plan = pr.plan_pull_shear(PALLAS_IN, PALLAS_OUT, mat[:3, :4])
            want = pr.pallas_pull_grad_shear(jnp.asarray(vol), jnp.asarray(M),
                                             PALLAS_OUT, plan)
        else:
            plan = pr.plan_pull(PALLAS_IN, PALLAS_OUT, mat[:3, :4])
            want = pr.pallas_pull_grad(jnp.asarray(vol), jnp.asarray(M),
                                       PALLAS_OUT, plan)
    assert plan is not None
    got = tr.pull_grad(torch.from_numpy(vol), M, PALLAS_OUT).numpy()
    assert got.shape == PALLAS_OUT + (3,)
    bad = (np.abs(got - np.asarray(want)) > 1e-5 * np.abs(vol).max()
           + 1e-5 * np.abs(np.asarray(want))).any(axis=-1)
    cross = _crossing(M, PALLAS_OUT)
    assert not (bad & ~cross).any()
    assert cross.mean() < 0.02 or not bad.any()


# --- the push kernel's candidate reach --------------------------------------
# The push kernel visits, per target v, only the sources within push_reach of
# c = Minv . v. These tests check the bound brute force on the sample points
# the plain version computes (bitwise the kernel's), and emulate the kernel's
# narrowed candidate loop on the CPU against push_plain, bit for bit.

_ROT45 = affine_matrix_classic([0, 0, 0, np.pi / 4, np.pi / 4, np.pi / 4])
REACH_MAPS = [  # (name, linear part of the map out voxel -> in voxel)
    ("near_identity", affine_matrix_classic(
        [0, 0, 0, 0.017, -0.012, 0.01])[:3, :3] @ np.diag([1, 1, 0.98])),
    ("rot45", _ROT45[:3, :3]),
    ("rot45_scale3", 3.0 * _ROT45[:3, :3]),
    ("scale4", 4.0 * np.eye(3)),
    ("scale_quarter", 0.25 * np.eye(3)),
    ("rot45_scale_quarter", 0.25 * _ROT45[:3, :3]),
]


def _reach_map(lin, in_dim):
    """A map with linear part ``lin`` taking the centre of its output grid
    (sized to cover the input) to the input's centre, off the knots."""
    from chip_smoke import centred_map

    out_dim = tuple(int(np.ceil(n / np.abs(lin).sum(1).min()))
                    for n in in_dim)
    return (tr.affine_to_M(centred_map(lin, in_dim, out_dim, offset=0.137)),
            out_dim)


def _candidate_box(M, Minv, order, src_dim, tgt_dim, window=None):
    """Per axis, the kernel's candidate range [lo, hi] of every target:
    the reach around c = Minv . v, cut to the window (push_window's unless
    given) and the source grid."""
    reach = tr.push_reach(M, Minv, order, src_dim, tgt_dim)
    window = tr.push_window(M) if window is None else window
    c = tr._sample_coords(Minv, tgt_dim, "cpu")
    lo, hi = [], []
    for d in range(3):
        anc = torch.floor(c[d] + 0.5).clamp(-2.0 ** 20, 2.0 ** 20)
        lo.append(torch.maximum(torch.maximum(
            torch.ceil(c[d] - float(reach[d])), anc - window[d]),
            torch.zeros(())).to(torch.int64))
        hi.append(torch.minimum(torch.minimum(
            torch.floor(c[d] + float(reach[d])), anc + window[d]),
            torch.full((), src_dim[d] - 1.0)).to(torch.int64))
    return lo, hi


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,lin", REACH_MAPS)
def test_push_reach_holds_every_weighted_source(name, lin, order):
    """Every (source, target) pair with a weight lies inside the target's
    candidate range, brute force over every source of the grid."""
    M, src_dim = _reach_map(lin, IN_DIM)
    Minv = tr.inverse_map(M)
    lo, hi = _candidate_box(M, Minv, order, src_dim, IN_DIM)
    o = torch.meshgrid(*[torch.arange(n, dtype=torch.float32)
                         for n in src_dim], indexing="ij")
    g = tr._map_points(M, list(o))
    fov = tr._fov_mask(g, IN_DIM)
    pairs = 0
    for e in np.ndindex(2, 2, 2):
        if order == 0 and any(e):
            continue
        v = [(torch.floor(g[d] + 0.5) if order == 0 else torch.floor(g[d])
              + e[d]).to(torch.int64) for d in range(3)]
        ok = fov.clone()
        for d in range(3):
            ok &= (v[d] >= 0) & (v[d] < IN_DIM[d])
        vi = [t[ok] for t in v]
        for d in range(3):
            od = o[d][ok].to(torch.int64)
            assert (od >= lo[d][vi[0], vi[1], vi[2]]).all()
            assert (od <= hi[d][vi[0], vi[1], vi[2]]).all()
        pairs += int(ok.sum())
    assert pairs > 0


def _push_narrowed(vals, M, vol_dim, order):
    """push as the kernel computes it: per target, the candidates of its
    range in (oa, ob, oc) order, each weight and product rounded as the plain
    version rounds them."""
    M = tr._as_map(M)
    Minv = tr.inverse_map(M)
    src_dim = tuple(vals.shape)
    lo, hi = _candidate_box(M, Minv, order, src_dim, vol_dim)
    count = [int((hi[d] - lo[d] + 1).max()) for d in range(3)]
    v = [torch.arange(n)[s] for n, s in zip(vol_dim, (
        (slice(None), None, None), (None, slice(None), None),
        (None, None, slice(None))))]
    flat = vals.reshape(-1)
    out = torch.zeros(vol_dim)
    for da, db, dc in np.ndindex(*count):
        o = [lo[0] + da, lo[1] + db, lo[2] + dc]
        ok = (o[0] <= hi[0]) & (o[1] <= hi[1]) & (o[2] <= hi[2])
        oc = [torch.minimum(o[d], hi[d]).clamp(min=0) for d in range(3)]
        g = tr._map_points(M, [t.to(torch.float32) for t in oc])
        w = None
        for d in range(3):
            if order == 0:
                wd = (torch.floor(g[d] + 0.5).to(torch.int64) == v[d])
                wd = wd.to(torch.float32)
            else:
                a = torch.floor(g[d])
                f = g[d] - a
                ai = a.to(torch.int64)
                wd = torch.where(v[d] == ai, 1.0 - f,
                                 torch.where(v[d] == ai + 1, f, 0.0))
            w = wd if w is None else w * wd
        w = w * (ok & tr._fov_mask(g, vol_dim)).to(torch.float32)
        idx = (oc[0] * src_dim[1] + oc[1]) * src_dim[2] + oc[2]
        out = out + w * torch.take(flat, idx)
    return out


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_push_narrowed_candidates_equal_plain_bitwise(name, mat, out_dim,
                                                      order):
    """Visiting only the candidates within reach, in the window's order,
    gives push_plain's result to the bit: the skipped candidates weigh 0."""
    M = tr.affine_to_M(mat)
    vals = torch.from_numpy(_vol(out_dim, 21))
    want = tr.push_plain(vals, M, IN_DIM, order=order)
    got = _push_narrowed(vals, M, IN_DIM, order)
    assert torch.equal(got, want)


# --- the push kernel's tiles -------------------------------------------------
# The push kernel gives a thread a tile of TX (x) x TY (y) x TZ (z) targets
# and visits the union of their candidate boxes once, in (oa, ob, oc) order:
# each source's sample point, FOV test (tiles with an edge target only),
# floors, fractions and value once, then its weighted product added to each
# target v of the tile with v_d in {floor(g_d), floor(g_d) + 1} (round(g) at
# order 0). Where the reach lies inside the window by a margin, the union is
# that of the corner targets' boxes; a tile where the window cuts a target's
# box visits each target alone over its own box. These tests emulate that
# visit order on the CPU against push_plain, bit for bit.

# the kernel's two tiles (ragged on IN_DIM), and one that is not
PUSH_TILES = [(1, 2, 4), (1, 3, 4), (1, 3, 1)]


def _tiled_visit(vals, M, lo, hi, v0, edge, tile, order, vol_dim, fov):
    """Sums of every group of targets (tiles, or single targets) over its
    box [lo, hi], each a (3, ...) int64 tensor over the groups, sources in
    (oa, ob, oc) order: (..., TX, TY, TZ) float32. ``v0``: the group's
    first target (3 float32 tensors), ``edge``: groups whose sources are
    tested against the FOV. A source adds + 0 to a target it does not weigh
    on, as the kernel's registers do. Each (oa, ob) row's sources are
    computed together, then added in oc order."""
    TX, TY, TZ = tile
    src_dim = tuple(vals.shape)
    flat = vals.reshape(-1)
    acc = torch.zeros(lo.shape[1:] + tile)
    a = torch.arange(TX, dtype=torch.float32)[:, None, None]
    b = torch.arange(TY, dtype=torch.float32)[:, None]
    q = torch.arange(TZ, dtype=torch.float32)
    count = [max(int((hi[d] - lo[d] + 1).max()), 0) for d in range(3)]
    dc = torch.arange(count[2])[:, None, None, None]

    def rows(t):  # (...) over the groups -> (..., oc, TX, TY, TZ)
        return t[..., None, None, None, None]

    for da, db in np.ndindex(*count[:2]):
        o = [rows(lo[0] + da), rows(lo[1] + db), rows(lo[2]) + dc]
        live = (o[0] <= rows(hi[0])) & (o[1] <= rows(hi[1])) & (
            o[2] <= rows(hi[2]))
        oc = [o[d].clamp(0, src_dim[d] - 1) for d in range(3)]
        g = tr._map_points(M, [t.to(torch.float32) for t in oc])
        live &= ~rows(edge) | tr._fov_mask(g, vol_dim, fov)
        val = torch.take(flat, (oc[0] * src_dim[1] + oc[1]) * src_dim[2]
                         + oc[2])
        v = [rows(t) for t in v0]
        if order == 0:
            n = [torch.floor(g[d] + 0.5) for d in range(3)]
            hit = ((n[0] == v[0] + a) & (n[1] == v[1] + b)
                   & (n[2] == v[2] + q))
            add = torch.where(live & hit, 1.0 * val, 0.0)
        else:
            fl = [torch.floor(g[d]) for d in range(3)]
            f = [g[d] - fl[d] for d in range(3)]
            ex, ey, ez = (v[d] - fl[d] for d in range(3))
            wx = torch.where(ex == -a, 1.0 - f[0],
                             torch.where(ex == 1 - a, f[0], 0.0))
            wy = torch.where(ey == -b, 1.0 - f[1],
                             torch.where(ey == 1 - b, f[1], 0.0))
            wxy = wx * wy
            m0, m1 = wxy * (1.0 - f[2]) * val, wxy * f[2] * val
            add = torch.where(live, torch.where(
                ez == -q, m0, torch.where(ez == 1 - q, m1, 0.0)), 0.0)
        for k in range(count[2]):
            acc = acc + add[..., k, :, :, :]
    return acc


def _push_tiled(vals, M, vol_dim, order, tile, window=None, fov=None):
    """push as the tiled kernel computes it, on the CPU; also whether a
    window cut a tile."""
    M = tr._as_map(M)
    Minv = tr.inverse_map(M)
    window = tr.push_window(M) if window is None else window
    fov = tr._as_fov(fov)
    src_dim = tuple(vals.shape)
    TX, TY, TZ = tile
    X, Y, Z = vol_dim
    Xt, Yt, Zt = -(-X // TX), -(-Y // TY), -(-Z // TZ)
    reach = tr.push_reach(M, Minv, order, src_dim, vol_dim)
    c = tr._sample_coords(Minv, vol_dim, "cpu")
    # per target: its box (window included) and whether the window cuts
    # it; padded to whole tiles with targets that widen nothing
    pad = (0, Zt * TZ - Z, 0, Yt * TY - Y, 0, Xt * TX - X)
    lo_t, hi_t, cut = [], [], torch.zeros(vol_dim, dtype=torch.bool)
    for d in range(3):
        anc = torch.floor(c[d] + 0.5)
        lo0, hi0 = torch.ceil(c[d] - float(reach[d])), torch.floor(
            c[d] + float(reach[d]))
        wl, wh = anc - float(window[d]), anc + float(window[d])
        cut |= (wl > lo0) | (wh < hi0)
        lo_t.append(torch.nn.functional.pad(torch.maximum(lo0, wl), pad,
                                            value=float("inf")))
        hi_t.append(torch.nn.functional.pad(torch.minimum(hi0, wh), pad,
                                            value=-float("inf")))

    def per_tile(t, op):  # (Xt * TX, Yt * TY, Zt * TZ) -> (Xt, Yt, Zt)
        t = t.reshape(Xt, TX, Yt, TY, Zt, TZ)
        return op(op(op(t, dim=5).values, dim=3).values, dim=1).values

    ulo = [per_tile(t, torch.min) for t in lo_t]
    uhi = [per_tile(t, torch.max) for t in hi_t]
    cut = per_tile(torch.nn.functional.pad(cut, pad), torch.max)
    v0 = [(n * torch.arange(m, dtype=torch.float32))[s] for n, m, s in zip(
        tile, (Xt, Yt, Zt), ((slice(None), None, None),
                             (None, slice(None), None),
                             (None, None, slice(None))))]
    v0 = [t.expand(Xt, Yt, Zt) for t in v0]
    # where the reach lies inside the window by a margin, a tile whose
    # corner targets have |c| < 2^13 takes the union of its corners' boxes
    # (reach only), and no window cuts it
    r32 = [np.float32(reach[d]) for d in range(3)]
    if all(r32[d] + np.float32(2.0 ** -8) < np.float32(window[d] + 0.5)
           for d in range(3)):
        corners = [tr._map_points(Minv, [v0[0] + i, v0[1] + j, v0[2] + k])
                   for i in {0, TX - 1} for j in {0, TY - 1}
                   for k in {0, TZ - 1}]
        fast = torch.ones_like(cut)
        for d in range(3):
            for cc in corners:
                fast &= cc[d].abs() < 8192.0
            lo_f = torch.stack([torch.ceil(cc[d] - float(r32[d]))
                                for cc in corners]).amin(0)
            hi_f = torch.stack([torch.floor(cc[d] + float(r32[d]))
                                for cc in corners]).amax(0)
            ulo[d] = torch.where(fast, lo_f, ulo[d])
            uhi[d] = torch.where(fast, hi_f, uhi[d])
        cut &= ~fast
    lo = torch.stack([t.clamp(0, 2.0 ** 20) for t in ulo]).to(torch.int64)
    hi = torch.stack([torch.minimum(t, torch.tensor(src_dim[d] - 1.0))
                      .clamp(min=-1.0) for d, t in enumerate(uhi)]
                     ).to(torch.int64)
    edge = ((fov is not None) | (v0[0] < 1) | (v0[0] + TX > X - 1)
            | (v0[1] < 1) | (v0[1] + TY > Y - 1) | (v0[2] < 1)
            | (v0[2] + TZ > Z - 1))
    acc = _tiled_visit(vals, M, lo, hi, v0, edge, tile, order, vol_dim, fov)

    def per_target(t):  # (Xt, Yt, Zt, TX, TY, TZ) -> (X, Y, Z)
        t = t.permute(0, 3, 1, 4, 2, 5).reshape(Xt * TX, Yt * TY, Zt * TZ)
        return t[:X, :Y, :Z]

    out = per_target(acc)
    if not cut.any():
        return out, False
    # the tiles that the window cuts: each target alone over its own box,
    # the kernel's integer box, the tile's edge flag
    lo1, hi1 = _candidate_box(M, Minv, order, src_dim, vol_dim, window)
    v = [t.to(torch.float32) for t in torch.meshgrid(
        *[torch.arange(n) for n in vol_dim], indexing="ij")]
    every = torch.ones((1, 1, 1) + tuple(tile), dtype=torch.bool)
    edge1 = per_target(edge[..., None, None, None] & every)
    one = _tiled_visit(vals, M, torch.stack(lo1), torch.stack(hi1), v,
                       edge1, (1, 1, 1), order, vol_dim, fov)[..., 0, 0, 0]
    return torch.where(per_target(cut[..., None, None, None] & every), one,
                       out), True


def _tile_maps():
    """The maps of MAPS and of REACH_MAPS, as (name, M, source grid)."""
    for name, mat, out_dim in MAPS:
        yield name, tr.affine_to_M(mat), out_dim
    for name, lin in REACH_MAPS:
        yield (name,) + _reach_map(lin, IN_DIM)


@pytest.mark.parametrize("tile", PUSH_TILES, ids=str)
@pytest.mark.parametrize("fov_name,fov", [("default", None)] + FOVS)
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,M,src_dim", list(_tile_maps()),
                         ids=[m[0] for m in _tile_maps()])
def test_push_tiled_visit_equals_plain_bitwise(name, M, src_dim, order,
                                               fov_name, fov, tile):
    """Each tile's union visited once, each source added to the tile's
    targets it weighs on, gives push_plain's result to the bit."""
    vals = torch.from_numpy(_vol(src_dim, 22))
    want = tr.push_plain(vals, M, IN_DIM, order=order, fov=fov)
    got, cut = _push_tiled(vals, M, IN_DIM, order, tile, fov=fov)
    assert not cut  # the plan's window never cuts a box
    assert want.abs().max() > 0
    assert torch.equal(got, want)


# (map, order, window) where the window cuts no target's box: a cut needs
# reach >= window + 1/2 on some axis (not so for scale4, reach 1/8 or 1/4,
# nor for rot45_scale3 at order 0, reach 1/4), and then a target whose c
# lies far enough from its anchor on that axis for ceil(c - reach) or
# floor(c + reach) to pass the window (no target of IN_DIM does for the
# others, whose reach exceeds window + 1/2 by 0.014 or less)
UNCUT = {("identity", 0, (0, 0, 0)), ("identity", 0, (1, 0, 1)),
         ("sr", 0, (1, 0, 1)), ("near_identity", 0, (1, 0, 1)),
         ("rot45_scale3", 0, (0, 0, 0)), ("rot45_scale3", 0, (1, 0, 1)),
         ("rot45_scale3", 1, (1, 0, 1))} | {
             ("scale4", o, w) for o in (0, 1) for w in ((0, 0, 0), (1, 0, 1))}


@pytest.mark.parametrize("window", [(0, 0, 0), (1, 0, 1)], ids=str)
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,M,src_dim", list(_tile_maps()),
                         ids=[m[0] for m in _tile_maps()])
def test_push_tiled_cut_windows_equal_plain_bitwise(name, M, src_dim, order,
                                                    window):
    """A window narrower than the reach sends the tiles whose boxes it cuts
    down the path of one target at a time (every case but those of UNCUT
    has such a tile): bitwise push_plain with that window."""
    vals = torch.from_numpy(_vol(src_dim, 23))
    want = tr.push_plain(vals, M, IN_DIM, order=order, window=window)
    got, cut = _push_tiled(vals, M, IN_DIM, order, PUSH_TILES[0],
                           window=window)
    assert cut == ((name, order, window) not in UNCUT)
    assert torch.equal(got, want)


# --- the pull_grad kernel's arithmetic ---------------------------------------
# The kernel rounds the 12 pair products wb wc, wa wc, wa wb once each and
# reuses them with the corner's sign, reads 0 for a corner outside the volume
# (adding w * 0) and sums the corners in (a, b, c) order. A product with +-1
# is exact, so this must give pull_grad_plain's bits.

def _pull_grad_shared_products(vol, M, out_dim):
    """pull_grad as the kernel computes it, in torch on the CPU."""
    M = tr._as_map(M)
    in_dim = tuple(vol.shape)
    g = tr._sample_coords(M, out_dim, "cpu")
    fl = [torch.floor(g[d]) for d in range(3)]
    f = [g[d] - fl[d] for d in range(3)]
    w = [(1.0 - f[d], f[d]) for d in range(3)]
    pbc = [[w[1][s] * w[2][t] for t in (0, 1)] for s in (0, 1)]
    pac = [[w[0][s] * w[2][t] for t in (0, 1)] for s in (0, 1)]
    pab = [[w[0][s] * w[1][t] for t in (0, 1)] for s in (0, 1)]
    i0 = [t.clamp(-2.0 ** 20, 2.0 ** 20).to(torch.int64) for t in fl]
    flat = vol.reshape(-1)
    grads = [torch.zeros(out_dim) for _ in range(3)]
    for a, b, c in np.ndindex(2, 2, 2):
        idx = [i0[0] + a, i0[1] + b, i0[2] + c]
        ok = None
        for d in range(3):
            okd = (idx[d] >= 0) & (idx[d] < in_dim[d])
            ok = okd if ok is None else ok & okd
        ic = [idx[d].clamp(0, in_dim[d] - 1) for d in range(3)]
        val = torch.where(ok, torch.take(
            flat, (ic[0] * in_dim[1] + ic[1]) * in_dim[2] + ic[2]), 0.0)
        grads[0] = grads[0] + (pbc[b][c] if a else -pbc[b][c]) * val
        grads[1] = grads[1] + (pac[a][c] if b else -pac[a][c]) * val
        grads[2] = grads[2] + (pab[a][b] if c else -pab[a][b]) * val
    keep = tr._fov_mask(g, in_dim)
    return torch.stack([torch.where(keep, gd, 0.0) for gd in grads], dim=-1)


def _grad_maps():
    """The reach tests' six maps, and one whose FOV edge crosses the output
    grid on every axis (a shift of several voxels)."""
    for name, lin in REACH_MAPS:
        yield (name,) + _reach_map(lin, IN_DIM)
    yield ("fov_edge", tr.affine_to_M(affine_matrix_classic(
        [4.3, -3.6, 5.2, 0.05, -0.03, 0.04])), IN_DIM)


@pytest.mark.parametrize("name,M,out_dim", list(_grad_maps()),
                         ids=[m[0] for m in _grad_maps()])
def test_pull_grad_shared_products_equal_plain_bitwise(name, M, out_dim):
    vol = torch.from_numpy(_vol(IN_DIM, 31))
    want = tr.pull_grad_plain(vol, M, out_dim)
    got = _pull_grad_shared_products(vol, M, out_dim)
    assert want.abs().max() > 0
    outside = ~tr._fov_mask(tr._sample_coords(M, out_dim, "cpu"), IN_DIM)
    if name in ("fov_edge", "rot45"):
        assert outside.any() and not outside.all()
    assert torch.equal(got, want)


# --- the pull kernel's tile ---------------------------------------------------
# A thread computes TZ outputs along z (k0 + LZ t, lanes LZ apart) in each
# of RX rows along x, a lane or row beyond the grid taking the grid's last
# (the kernel's: LZ 32, TZ 2, RX 2). The partial sums
# M[d,0] i + M[d,1] j are rounded
# once per row and M[d,2] k once per lane, then each output finishes
# (s + M[d,2] k) + M[d,3]. The floors come from a rounding-down add of
# 1.5 * 2^23 (the bits of the sum less those of 1.5 * 2^23 are the integer
# floor); a thread whose points all have every corner inside the volume
# reads them without a test, any other reads each point's corners at
# indices clamped into the grid and zeroes those outside (edge_corners).
# Order 0 reads the voxel at floor(g + 1/2) by the same add. This must
# give pull_plain's bits.

_RD = np.float32(12582912.0)  # 1.5 * 2^23
_TILE = dict(LZ=32, TZ=2, RX=2)


def _add_rd(a, b):
    """a + b rounded down in float32: the rounded sum, one float below it
    where TwoSum's exact error is negative."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return np.where(err < 0, np.nextafter(s, np.float32(-np.inf)), s)


def _floor_rd(x):
    """(floor(x) as a float, as unsigned bits less those of 1.5 * 2^23)."""
    t = _add_rd(x, _RD)
    fi = t.view(np.uint32) - _RD.view(np.uint32)  # wraps as the kernel's
    return t - _RD, fi


def _pull_tile(vol, M, out_dim, order=1, fov=None, LZ=8, TZ=1, RX=2):
    """pull as the kernel's tile computes it, on the CPU: numpy float32,
    every point indexed (x row block, q, j, z block, t, lane)."""
    M = tr._as_map(M)
    vol = vol.numpy()
    n = X, Y, Z = vol.shape
    ox, oy, oz = out_dim
    nxb, nzb = -(-ox // RX), -(-oz // (LZ * TZ))
    iq = np.arange(nxb)[:, None] * RX + np.arange(RX)
    kt = (np.arange(nzb)[:, None, None] * LZ * TZ
          + LZ * np.arange(TZ)[:, None] + np.arange(LZ))
    i = np.minimum(iq, ox - 1).astype(np.float32)[:, :, None, None, None,
                                                   None]
    j = np.arange(oy, dtype=np.float32)[:, None, None, None]
    k = np.minimum(kt, oz - 1).astype(np.float32)
    g = []
    for d in range(3):
        s = M[d, 0] * i + M[d, 1] * j  # once per row
        g.append(np.broadcast_to((s + M[d, 2] * k) + M[d, 3],
                                 (nxb, RX, oy, nzb, TZ, LZ)))
    keep = tr._fov_mask([torch.from_numpy(np.array(gd)) for gd in g], n,
                        tr._as_fov(fov)).numpy()
    flat = vol.reshape(-1)
    if order == 0:
        a = [_floor_rd(gd + np.float32(0.5))[1] for gd in g]
        ok = keep & (a[0] < X) & (a[1] < Y) & (a[2] < Z)
        a = [np.where(ok, a[d], 0).astype(np.int64) for d in range(3)]
        res = np.where(ok, flat[(a[0] * Y + a[1]) * Z + a[2]], np.float32(0))
    else:
        fl, fi = zip(*[_floor_rd(gd) for gd in g])
        # a thread's points: axes q (1) and t (4) of (xb, q, j, zb, t, lane)
        inner = np.ones(g[0].shape, bool)
        for d in range(3):
            inner &= fi[d] < n[d] - 1
        inner = np.broadcast_to(inner.all(axis=(1, 4), keepdims=True),
                                inner.shape)
        # floor_rd's floor on the fast path, floorf's on the edge path
        fl = [np.where(inner, fl[d], np.floor(g[d])) for d in range(3)]
        w = [(np.float32(1) - (g[d] - fl[d]), g[d] - fl[d]) for d in range(3)]
        res = np.zeros(g[0].shape, np.float32)
        for da, db in np.ndindex(2, 2):
            wab = w[0][da] * w[1][db]
            for dc in (0, 1):
                e = (da, db, dc)
                c = [fi[d] + np.uint32(e[d]) for d in range(3)]
                ok = inner | ((c[0] < X) & (c[1] < Y) & (c[2] < Z))
                c = [np.minimum(c[d], n[d] - 1).astype(np.int64)
                     for d in range(3)]
                v = np.where(ok, flat[(c[0] * Y + c[1]) * Z + c[2]],
                             np.float32(0))
                res = res + (wab * w[2][dc]) * v
        res = np.where(keep, res, np.float32(0))
    # the stores: the points inside the grid
    r = res.reshape(nxb * RX, oy, -1)
    kt = kt.reshape(-1)
    r = r[iq.reshape(-1) < ox][:, :, kt < oz]
    return torch.from_numpy(np.ascontiguousarray(
        r[:, :, np.argsort(kt[kt < oz])]))


def _tile_test_maps():
    """(name, M, input grid, output grid): the identity, the fit's map of
    chip_smoke.py on a small volume, 45 degrees x 3 and x 1/4, and a map
    whose floors step by 0 or 2 between neighbouring z lanes and whose a
    and b change along a warp's row."""
    import chip_smoke

    _, M_fit, _ = chip_smoke.fit_case()
    rot = affine_matrix_classic([0, 0, 0, np.pi / 4, np.pi / 4,
                                 np.pi / 4])[:3, :3]
    steps = np.array([[1.0, 0.0, 0.04, 0.3], [0.0, 1.0, -0.05, 0.2],
                      [0.0, 0.0, 1.07, 0.6]], np.float32)
    yield "identity", tr.affine_to_M(np.eye(4)), IN_DIM
    yield "fit", M_fit, (12, 14, 60)
    yield "rot45_x3", tr.affine_to_M(chip_smoke.centred_map(
        3.0 * rot, IN_DIM, (6, 6, 40), offset=0.137)), IN_DIM
    yield "rot45_quarter", tr.affine_to_M(chip_smoke.centred_map(
        0.25 * rot, IN_DIM, (8, 9, 40), offset=0.137)), IN_DIM
    yield "steps", steps, (12, 13, 60)


# fov bounds that cut the small output grids of the tile's tests on x, y
# and z (off the sample points)
TILE_FOV = np.array([[0.6, 2.4], [0.55, 2.7], [2.2, 30.6]], np.float32)


@pytest.mark.parametrize("fov_name,fov", [("default", None),
                                          ("box", TILE_FOV)])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("out_dim", [(3, 4, 1), (5, 3, 31), (1, 4, 33),
                                     (3, 2, 185), (1, 1, 64), (2, 5, 65),
                                     (7, 4, 96)], ids=str)
@pytest.mark.parametrize("name,M,in_dim", list(_tile_test_maps()),
                         ids=[m[0] for m in _tile_test_maps()])
def test_pull_tile_equals_plain_bitwise(name, M, in_dim, out_dim, order,
                                        fov_name, fov):
    vol = torch.from_numpy(_vol(in_dim, 41))
    want = tr.pull_plain(vol, M, out_dim, order=order, fov=fov)
    got = _pull_tile(vol, M, out_dim, order=order, fov=fov, **_TILE)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out_dim", [(5, 7, 37), (2, 3, 64)], ids=str)
@pytest.mark.parametrize("order", [0, 1])
def test_pull_tile_batch_of_stride_zero(order, out_dim):
    """A batch read with stride 0: one volume at three maps, volume by
    volume as the batched launch computes it."""
    maps = list(_tile_test_maps())
    vol = torch.from_numpy(_vol(IN_DIM, 42))
    batch = vol.expand((3,) + IN_DIM)
    assert batch.stride(0) == 0
    Ms = np.stack([maps[k][1] for k in (1, 3, 4)])
    want = tr.pull_plain(batch, Ms, out_dim, order=order)
    got = torch.stack([_pull_tile(batch[b], Ms[b], out_dim, order=order,
                                  **_TILE) for b in range(3)])
    assert want.abs().max() > 0
    assert torch.equal(got, want)


def test_rounding_down_add_is_the_floor():
    """The floor by a rounding-down add, at the edges where it must hold
    (ties, tiny negatives, +-2^22) and fail the unsigned test (beyond)."""
    x = np.array([0.0, -0.0, 1e-30, -1e-30, 0.5, -0.5, 2.9999998, -2.9999998,
                  4194303.5, -4194303.5, 4194304.0, -4194304.0, 1e9, -1e9],
                 np.float32)
    fl, fi = _floor_rd(x)
    small = np.abs(x) < 2 ** 22
    assert np.array_equal(fl[small], np.floor(x[small]))
    assert np.array_equal(fi[small & (x >= 0)],
                          np.floor(x[small & (x >= 0)]).astype(np.uint32))
    assert (fi[~small] >= 2 ** 22 - 2).all()
    assert (fi[x < 0] >= 2 ** 22 - 2).all()  # negative: beyond any grid


@pytest.mark.parametrize("given_minv", [False, True])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,lin", REACH_MAPS)
def test_push_plan_is_the_uncached_plan(name, lin, order, given_minv):
    """The push wrapper's cached host plan (map, inverse map, reach, window,
    packed as the kernel reads them) equals the one computed afresh, and a
    second call returns the cache's."""
    M, src_dim = _reach_map(lin, IN_DIM)
    Minv = tr.inverse_map(M)
    key = (M.tobytes(), Minv.tobytes() if given_minv else None, order,
           src_dim, IN_DIM)
    plan = tr._push_plan(*key)
    assert plan.shape == (tr.PLAN_SIZE,) and plan.dtype == np.float32
    np.testing.assert_array_equal(plan[:12], M.ravel())
    np.testing.assert_array_equal(plan[12:24], Minv.ravel())
    np.testing.assert_array_equal(
        plan[24:27], tr.push_reach(M, Minv, order, src_dim, IN_DIM))
    assert tuple(plan[27:30]) == tr.push_window(M)
    assert tr._push_plan(*key) is plan


# --- the box planner of the staged variants (scripts/cuda_staged_variants.py)

def _staged_variants():
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parents[1] / "scripts"
            / "cuda_staged_variants.py")
    spec = importlib.util.spec_from_file_location("cuda_staged_variants", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiles(dim, tile):
    """(origin, size) of every tile of a grid, as the staged kernels cut it."""
    for o in np.ndindex(*[(n + t - 1) // t for n, t in zip(dim, tile)]):
        lo = [a * t for a, t in zip(o, tile)]
        yield lo, [min(t, n - a) for t, n, a in zip(tile, dim, lo)]


@pytest.mark.parametrize("kind", ["pull", "push0", "push1"])
@pytest.mark.parametrize("name,lin", REACH_MAPS)
def test_staged_box_holds_every_read(name, lin, kind):
    """The staged kernels' box, from the tile's 8 corners with the kernels'
    float32 margins, holds every corner a pull output reads and every
    candidate a push target visits, and fits the plan's box size."""
    sv = _staged_variants()
    M, src_dim = _reach_map(lin, IN_DIM)
    eps = sv.BOX_EPS
    if kind == "pull":  # output grid src_dim, input IN_DIM
        g = torch.stack(tr._sample_coords(M, src_dim, "cpu"))
        for tile in sv.PULL_TILES:
            plan = sv.pull_plan(M, src_dim, tile)
            for o, n in _tiles(src_dim, plan[:3].tolist()):
                gt = g[:, o[0]:o[0] + n[0], o[1]:o[1] + n[1], o[2]:o[2] + n[2]]
                gc = gt[:, ::max(n[0] - 1, 1), ::max(n[1] - 1, 1),
                        ::max(n[2] - 1, 1)].reshape(3, -1)
                lo = torch.floor(gc - eps).amin(1)
                hi = torch.floor(gc + eps).amax(1) + 1
                fl = torch.floor(gt).reshape(3, -1)
                assert (hi - lo + 1 <= torch.from_numpy(plan[3:6])).all()
                assert (fl.amin(1) >= lo).all() and (fl.amax(1) + 1 <= hi).all()
        return
    order = int(kind[-1])
    Minv = tr.inverse_map(M)
    reach = tr.push_reach(M, Minv, order, src_dim, IN_DIM)
    c = torch.stack(tr._sample_coords(Minv, IN_DIM, "cpu"))
    r = torch.from_numpy(reach)[:, None]
    lo_t, hi_t = (torch.stack(b) for b in _candidate_box(M, Minv, order,
                                                         src_dim, IN_DIM))
    top = torch.tensor(src_dim)[:, None] - 1
    for tile in sv.PUSH_TILES:
        plan = sv.push_plan(Minv, reach, src_dim, IN_DIM, tile)
        for o, n in _tiles(IN_DIM, plan[:3].tolist()):
            sl = (slice(None), slice(o[0], o[0] + n[0]),
                  slice(o[1], o[1] + n[1]), slice(o[2], o[2] + n[2]))
            cc = c[sl][:, ::max(n[0] - 1, 1), ::max(n[1] - 1, 1),
                       ::max(n[2] - 1, 1)].reshape(3, -1)
            lo = torch.ceil(cc - r - eps).amin(1).clamp(min=0)
            hi = torch.minimum(torch.floor(cc + r + eps).amax(1)[:, None],
                               top)[:, 0]
            assert (hi - lo + 1 <= torch.from_numpy(plan[3:6])).all()
            a, b = lo_t[sl].reshape(3, -1), hi_t[sl].reshape(3, -1)
            some = (a <= b).all(0)  # targets with a candidate
            assert (a[:, some] >= lo[:, None]).all()
            assert (b[:, some] <= hi[:, None]).all()


# --- the library yardsticks of chip_smoke.py ---------------------------------

@pytest.mark.parametrize("kernel", ["pull", "push", "pull_grad"])
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_yardstick_matches_plain(name, mat, out_dim, kernel):
    """Each kernel's one-call PyTorch yardstick computes the plain version's
    function (pull_grad away from the knots, where it is continuous)."""
    import chip_smoke

    M = tr.affine_to_M(mat)
    if kernel == "push":
        inp, dst = torch.from_numpy(_vol(out_dim, 12)), IN_DIM
        want = tr.push_plain(inp, M, dst)
    else:
        inp, dst = torch.from_numpy(_vol(IN_DIM, 13)), out_dim
        want = (tr.pull_plain if kernel == "pull"
                else tr.pull_grad_plain)(inp, M, dst)
    call, to_plain, _ = chip_smoke.yardstick(kernel, inp, M, dst)
    got = to_plain(call())
    if kernel == "pull_grad":
        keep = chip_smoke.off_knots(M, dst, "cpu")[..., None]
        got, want = got * keep, want * keep
    _close(got.numpy(), want.numpy(), np.abs(want.numpy()).max())


@pytest.mark.parametrize("kernel", ["pull", "push"])
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_nearest_yardstick_matches_plain(name, mat, out_dim, kernel):
    """The order-0 yardsticks (nearest ``grid_sample`` and its input
    gradient) compute the plain version's function away from half-voxel
    ties, where PyTorch rounds to even and the port up: pull compared at
    the points off the ties, push with the sources near a tie left out of
    both."""
    import chip_smoke

    M = tr.affine_to_M(mat)
    if kernel == "push":
        inp = torch.from_numpy(_vol(out_dim, 14))
        inp = inp * chip_smoke.off_ties(M, out_dim, "cpu")
        want, dst = tr.push_plain(inp, M, IN_DIM, order=0), IN_DIM
        keep = torch.ones(IN_DIM, dtype=torch.bool)
    else:
        inp, dst = torch.from_numpy(_vol(IN_DIM, 15)), out_dim
        want = tr.pull_plain(inp, M, dst, order=0)
        keep = chip_smoke.off_ties(M, dst, "cpu")
    assert keep.float().mean() > 0.9
    call, to_plain, label = chip_smoke.yardstick(kernel, inp, M, dst, order=0)
    assert "nearest" in label
    got = to_plain(call())
    _close((got * keep).numpy(), (want * keep).numpy(),
           np.abs(want.numpy()).max())


@pytest.mark.parametrize("kernel", ["pull", "push", "pull_grad"])
def test_batched_yardstick_matches_plain(kernel):
    """The yardstick of a batch, one library call with N = 2 over two
    volumes each at its own map, against the plain version per volume."""
    import chip_smoke

    Ms = [tr.affine_to_M(MAPS[2][1]),
          tr.affine_to_M(affine_matrix_classic([-0.5, 0.3, 0.2, -0.04, 0.02,
                                                0.03]))]
    out = MAPS[2][2]
    shape, dst = (out, IN_DIM) if kernel == "push" else (IN_DIM, out)
    inp = torch.from_numpy(np.stack([_vol(shape, 20 + b) for b in (0, 1)]))
    fn = {"pull": tr.pull_plain, "push": tr.push_plain,
          "pull_grad": tr.pull_grad_plain}[kernel]
    want = torch.stack([fn(inp[b], Ms[b], dst) for b in (0, 1)])
    call, to_plain, _ = chip_smoke.yardstick(kernel, inp, Ms, dst)
    got = to_plain(call())
    assert got.shape == want.shape
    if kernel == "pull_grad":
        keep = torch.stack([chip_smoke.off_knots(M, dst, "cpu")
                            for M in Ms])[..., None]
        got, want = got * keep, want * keep
    _close(got.numpy(), want.numpy(), np.abs(want.numpy()).max())


# --- dispatch ---------------------------------------------------------------

def test_wrappers_refuse_devices_without_kernel():
    vol = torch.zeros(IN_DIM, device="meta")
    M = np.eye(4)[:3]
    with pytest.raises(ValueError):
        tr.pull(vol, M, IN_DIM)
    with pytest.raises(ValueError):
        tr.push(vol, M, IN_DIM)
    with pytest.raises(ValueError):
        tr.pull_grad(vol, M, IN_DIM)
    with pytest.raises(ValueError):
        tr.pull(torch.zeros(IN_DIM), M, IN_DIM, order=3)


def test_cpu_tensors_never_launch_kernels():
    before = (tr.pull.launches, tr.push.launches, tr.pull_grad.launches)
    vol = torch.from_numpy(_vol(IN_DIM, 6))
    tr.push(tr.pull(vol, np.eye(4)[:3], IN_DIM), np.eye(4)[:3], IN_DIM)
    tr.pull_grad(vol, np.eye(4)[:3], IN_DIM)
    assert (tr.pull.launches, tr.push.launches,
            tr.pull_grad.launches) == before
