"""unires_torch's CUDA kernels on the card (marked ``gpu``; skip without one).

The kernels have no CPU mode, so these tests hold each kernel against its
plain PyTorch version on the same CUDA tensors, and a fit on the card
against the same fit on the CPU. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: every kernel vs its plain version exact (the same roundings in
the same order), with and without the ``fov`` override and an explicit push
window; adjointness relative 1e-5; objective
traces relative 1e-4 (float32 sums in another order), 1e-3 with the rigid
and scaling updates on (they feed the sums' differences back into the fit);
co-registration card vs CPU 0.1 mm / 2e-3; the sharded step on a world of
one (NCCL) against ``make_admm_step`` as tests/test_torch_sharding.py holds
it (ys 2e-3 of scale, z and w 1e-3, objective rtol 2e-3); maps read from
device memory against staged host maps, a captured graph and its IF and
WHILE nodes against eager launches, the captured fit chunk against the
uncaptured one, and co-registration with its levels captured against the
same levels uncaptured, all exact; each kernel's batched launch against
its unbatched launches and its plain version, and a captured batch of
subjects against the same batch uncaptured, exact too.
"""
import copy

import numpy as np
import pytest
import torch

import unires_torch
from chip_smoke import centred_map
from unires_torch.geometry import affine_diag, affine_matrix_classic
from unires_torch.models.forward import make_obs_ops, obs_dyn_args
from unires_torch.models.proj_op import proj_info
from unires_torch.ops import resample as tr
from unires_torch.pipeline.convert import convert_state
from unires_torch.pipeline.fit import fit
from unires_torch.utils.phantoms import brain_phantom

pytestmark = pytest.mark.gpu

IN_DIM = (14, 15, 17)


def _centred(scale, out_dim):
    """45 degrees about each axis times ``scale``, taking the centre of the
    ``out_dim`` grid to the centre of IN_DIM (plus an offset off the knots)."""
    rot = affine_matrix_classic([0, 0, 0, np.pi / 4, np.pi / 4, np.pi / 4])
    return centred_map(scale * rot[:3, :3], IN_DIM, out_dim, offset=0.137)


MAPS = [
    ("identity", np.eye(4), IN_DIM),
    ("sr", affine_diag([1.0, 1.0, 0.5]) @ affine_matrix_classic(
        [0.0, 0.0, -1.1]), (14, 15, 33)),
    ("rotated", affine_matrix_classic([0.6, -0.4, 0.3, 0.05, -0.03, 0.04]),
     (13, 16, 18)),
    # every output voxel 3 input voxels wide, rotated: push's reach < 1
    ("rot45_scale3", _centred(3.0, (6, 6, 7)), (6, 6, 7)),
    # every output voxel a quarter voxel wide, rotated: push visits up to
    # 11 x 11 x 13 candidates per target (a window of (7, 7, 9))
    ("wide", _centred(0.25, (56, 60, 68)), (56, 60, 68)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _vol(shape, seed, device):
    v = np.random.default_rng(seed).random(shape, dtype=np.float32) - 0.3
    return torch.from_numpy(v).to(device)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_kernels_match_plain(cuda, name, mat, out_dim, order):
    vol = _vol(IN_DIM, 7, cuda)
    vals = _vol(out_dim, 8, cuda)
    M = tr.affine_to_M(mat)
    n0 = (tr.pull.launches, tr.push.launches)
    got_pull = tr.pull(vol, M, out_dim, order=order)
    got_push = tr.push(vals, M, IN_DIM, order=order)
    torch.cuda.synchronize()
    assert (tr.pull.launches, tr.push.launches) == (n0[0] + 1, n0[1] + 1)
    # the kernels repeat their plain versions' roundings in the same order
    want_pull = tr.pull_plain(vol, M, out_dim, order=order)
    want_push = tr.push_plain(vals, M, IN_DIM, order=order)
    assert float((got_pull - want_pull).abs().max()) == 0.0
    assert float((got_push - want_push).abs().max()) == 0.0
    lhs = float((got_pull.double() * vals.double()).sum())
    rhs = float((got_push.double() * vol.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_pull_grad_kernel_matches_plain(cuda, name, mat, out_dim):
    vol = _vol(IN_DIM, 9, cuda)
    M = tr.affine_to_M(mat)
    n0 = tr.pull_grad.launches
    got = tr.pull_grad(vol, M, out_dim)
    torch.cuda.synchronize()
    assert tr.pull_grad.launches == n0 + 1
    assert got.shape == tuple(out_dim) + (3,) and got.is_contiguous()
    # the signed pair products are the plain version's roundings: exact,
    # on the 45 degree x 3 and x 1/4 maps too
    want = tr.pull_grad_plain(vol, M, out_dim)
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) == 0.0


@pytest.mark.parametrize("out_dim", [(5, 9, 37), (4, 8, 16), (7, 3, 1),
                                     (1, 17, 50)])
def test_pull_grad_kernel_ragged_tiles(cuda, out_dim):
    """Output extents that are not multiples of the block's 16 (z) x 8 (y)
    x 2 (x) tile, and one that is: exact."""
    vol = _vol(IN_DIM, 10, cuda)
    M = tr.affine_to_M(affine_matrix_classic(
        [0.6, -0.4, 0.3, 0.05, -0.03, 0.04]))
    got = tr.pull_grad(vol, M, out_dim)
    torch.cuda.synchronize()
    assert float((got - tr.pull_grad_plain(vol, M, out_dim)).abs().max()) == 0.0


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("vol_dim", [(5, 9, 37), (4, 8, 16), (7, 3, 1),
                                     (1, 17, 50), (3, 33, 9), (2, 64, 64)])
def test_push_kernel_ragged_tiles(cuda, vol_dim, order):
    """Target grids that are not multiples of the push kernel's tiles and
    blocks, and ones that are: exact, the batched launch too."""
    M = tr.affine_to_M(affine_matrix_classic(
        [0.6, -0.4, 0.3, 0.05, -0.03, 0.04]))
    vals = _vol((2, 6, 18, 40), 14, cuda)
    got = tr.push(vals, np.stack([M, M]), vol_dim, order=order)
    one = tr.push(vals[1], M, vol_dim, order=order)
    torch.cuda.synchronize()
    want = tr.push_plain(vals[1], M, vol_dim, order=order)
    assert float(want.abs().max()) > 0
    assert torch.equal(one, want) and torch.equal(got[1], want)
    assert torch.equal(got[0], tr.push_plain(vals[0], M, vol_dim,
                                             order=order))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("vol_dim", [(13, 17, 19), (24, 24, 24), (7, 5, 9)])
def test_push_kernel_sparse_sources(cuda, vol_dim, order):
    """Sources three times the targets' spacing per axis (the 45 degree x 3
    map of chip_smoke.py: most tiles' sources weigh on few of its targets),
    on target grids that leave ragged tiles and one that does not: exact,
    the batched launch too."""
    src = tuple(-(-n // 3) for n in vol_dim)
    M = tr.affine_to_M(centred_map(3.0 * affine_matrix_classic(
        [0, 0, 0, 0.7, 0.5, 0.6])[:3, :3], vol_dim, src, offset=0.137))
    vals = _vol((2,) + src, 16, cuda)
    got = tr.push(vals, np.stack([M, M]), vol_dim, order=order)
    torch.cuda.synchronize()
    for b in (0, 1):
        want = tr.push_plain(vals[b], M, vol_dim, order=order)
        assert float(want.abs().max()) > 0
        assert torch.equal(tr.push(vals[b], M, vol_dim, order=order), want)
        assert torch.equal(got[b], want)


@pytest.mark.parametrize("window", [None, (0, 0, 0), (2, 1, 3)], ids=str)
@pytest.mark.parametrize("order", [0, 1])
def test_push_kernel_wide_reach_and_cut_windows(cuda, order, window):
    """The 45 degree x 1/4 map (a reach of ~7 voxels per axis, so a tile's
    union of boxes spans ~15 x 16 x 19 sources), and windows narrower than
    the reach (each of their tiles takes the path of one target at a
    time): exact, and the batched launch equal to the unbatched ones."""
    _, mat, out_dim = MAPS[-1]
    M = tr.affine_to_M(mat)
    vals = _vol((2,) + out_dim, 15, cuda)
    got = tr.push(vals, np.stack([M, M]), IN_DIM, order=order, window=window)
    one = [tr.push(vals[b], M, IN_DIM, order=order, window=window)
           for b in (0, 1)]
    torch.cuda.synchronize()
    for b in (0, 1):
        want = tr.push_plain(vals[b], M, IN_DIM, order=order, window=window)
        assert float(want.abs().max()) > 0
        assert torch.equal(one[b], want) and torch.equal(got[b], want)


def test_wrappers_check_their_inputs(cuda):
    M = np.eye(4)[:3]
    with pytest.raises(TypeError):
        tr.pull(torch.zeros(IN_DIM, dtype=torch.float64, device=cuda), M, IN_DIM)
    with pytest.raises(ValueError):
        tr.push(torch.zeros(IN_DIM, device=cuda).transpose(0, 2), M, IN_DIM)
    with pytest.raises(TypeError):
        tr.pull_grad(torch.zeros(IN_DIM, dtype=torch.float64, device=cuda),
                     M, IN_DIM)


def test_card_fit_matches_cpu_fit(cuda):
    gt = brain_phantom(dim=(24, 28, 25), seed=1)
    rng = np.random.default_rng(2)
    chans = []
    for ax in (2, 0):
        vx = [1.0, 1.0, 1.0]
        vx[ax] = 4.0
        dim_x = list(gt.shape)
        dim_x[ax] = int(np.ceil(gt.shape[ax] / 4.0))
        po = proj_info(gt.shape, np.eye(4), tuple(dim_x), affine_diag(vx),
                       prof_ip=2, prof_tp=0)
        x = unires_torch.proj_apply("A", torch.from_numpy(gt), po,
                                    "super-resolution").numpy()
        x = x + rng.normal(0.0, 75.0, x.shape).astype(np.float32)
        chans.append([x, affine_diag(vx)])
    traces = {}
    for dev in ("cpu", "cuda"):
        n0 = (tr.pull.launches, tr.push.launches)
        x, y, s = unires_torch.init(chans, unires_torch.Settings(
            device=dev, vx=1.0, do_coreg=False, do_print=0, max_iter=4,
            tolerance=0, write_out=False))
        _, _, _, traces[dev], _ = fit(x, y, s)
        grew = (tr.pull.launches > n0[0], tr.push.launches > n0[1])
        assert grew == ((True, True) if dev == "cuda" else (False, False))
    np.testing.assert_allclose(traces["cuda"], traces["cpu"], rtol=1e-4)


def test_card_misaligned_fit_matches_cpu_fit(cuda):
    """Coreg + unified rigid + scaling: coreg on both devices, then both fits
    from the CPU's co-registered init."""
    vol = brain_phantom(seed=0)[66:114, 80:136, 66:114]
    rng = np.random.default_rng(3)
    chans = []
    for ax, rp in ((2, [1.2, -0.8, 0.5, 0.015, -0.01, 0.012]),
                   (0, [-1.0, 0.7, -0.6, -0.012, 0.01, -0.015])):
        vx = [1.0, 1.0, 1.0]
        vx[ax] = 4.0
        dim_x = list(vol.shape)
        dim_x[ax] = int(np.ceil(vol.shape[ax] / 4.0))
        po = proj_info(vol.shape, np.eye(4), tuple(dim_x), affine_diag(vx),
                       rigid=affine_matrix_classic(rp), prof_ip=2, prof_tp=0,
                       scl=0.1)
        x = unires_torch.proj_apply("A", torch.from_numpy(vol), po,
                                    "super-resolution").numpy()
        x = x + rng.normal(0.0, 75.0, x.shape).astype(np.float32)
        chans.append([x, affine_diag(vx)])
    kw = dict(vx=1.0, do_coreg=True, unified_rigid=True, scaling=True,
              do_print=0, max_iter=4, tolerance=0, write_out=False)
    inits = {dev: unires_torch.init(chans, unires_torch.Settings(device=dev,
                                                                 **kw))
             for dev in ("cpu", "cuda")}
    mc, mg = (np.asarray(inits[d][2].mat_coreg) for d in ("cpu", "cuda"))
    np.testing.assert_allclose(mg[:, :3, 3], mc[:, :3, 3], atol=0.1)
    np.testing.assert_allclose(mg[:, :3, :3], mc[:, :3, :3], atol=2e-3)
    x, y, s = inits["cpu"]
    xg, yg, sg = convert_state(x, y, s, cuda)
    n0 = tr.pull_grad.launches
    _, _, _, obj_g, _ = fit(xg, yg, sg)
    assert tr.pull_grad.launches > n0
    _, _, _, obj_c, _ = fit(x, y, s)
    np.testing.assert_allclose(obj_g, obj_c, rtol=1e-3)


# the fov override: bounds narrower and wider than IN_DIM (in its voxels)
FOVS = [
    ("narrow", np.array([[1.2, 10.7], [2.3, 11.4], [0.8, 14.1]], np.float32)),
    ("wide", np.array([[-2.3, 15.6], [-1.7, 16.2], [-3.1, 18.4]], np.float32)),
]


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("fov_name,fov", FOVS)
@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_fov_kernels_match_plain(cuda, name, mat, out_dim, fov_name, fov,
                                 order):
    vol = _vol(IN_DIM, 11, cuda)
    vals = _vol(out_dim, 12, cuda)
    M = tr.affine_to_M(mat)
    got_pull = tr.pull(vol, M, out_dim, order=order, fov=fov)
    got_push = tr.push(vals, M, IN_DIM, order=order, fov=fov)
    torch.cuda.synchronize()
    want_pull = tr.pull_plain(vol, M, out_dim, order=order, fov=fov)
    want_push = tr.push_plain(vals, M, IN_DIM, order=order, fov=fov)
    assert float((got_pull - want_pull).abs().max()) == 0.0
    assert float((got_push - want_push).abs().max()) == 0.0
    lhs = float((got_pull.double() * vals.double()).sum())
    rhs = float((got_push.double() * vol.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


# pull's maps for ragged tiles: a rotation, and a map whose floors step by
# 0 or 2 between neighbouring z lanes (M[2, 2] = 1.07) and whose a and b
# change along a warp's row
PULL_MAPS = [
    tr.affine_to_M(affine_matrix_classic([0.6, -0.4, 0.3, 0.05, -0.03,
                                          0.04])),
    np.array([[1.0, 0.0, 0.04, 0.3], [0.0, 1.0, -0.05, 0.2],
              [0.0, 0.0, 1.07, -0.6]], np.float32),
]


@pytest.mark.parametrize("fov_name,fov", [("default", None)] + FOVS)
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("out_dim", [(3, 4, 1), (5, 3, 31), (4, 5, 33),
                                     (3, 2, 185), (1, 5, 40), (7, 9, 64)],
                         ids=str)
def test_pull_kernel_ragged_tiles(cuda, out_dim, order, fov_name, fov):
    """Output extents that are not multiples of pull's tile (a warp of 32
    z lanes, 2 outputs along z per thread, 4 warps along y), one x row or
    an odd number of them, with the default bounds and the fov boxes:
    exact."""
    vol = _vol(IN_DIM, 14, cuda)
    for M in PULL_MAPS:
        got = tr.pull(vol, M, out_dim, order=order, fov=fov)
        torch.cuda.synchronize()
        want = tr.pull_plain(vol, M, out_dim, order=order, fov=fov)
        assert torch.equal(got, want)


@pytest.mark.parametrize("fov_name,fov", [("default", None), ("box", np.array(
    [[0.2, 5.6], [0.7, 7.1], [2.3, 180.2]], np.float32))])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("shift_z,out_dim", [(4.2, (5, 7, 150)),
                                             (-1.3, (5, 7, 203))])
def test_pull_kernel_long_z_interior_and_overhang(cuda, shift_z, out_dim,
                                                  order, fov_name, fov):
    """A volume long along z, so that most of pull's warps (32 lanes along
    z) have every corner inside and take the fast path: all inside (a
    shift of 4.2), and an output grid that overhangs the volume along z
    (-1.3), whose first and last warps of a row take the edge path. Exact
    either way."""
    vol = _vol((7, 9, 200), 16, cuda)
    M = tr.affine_to_M(affine_matrix_classic([0.7, 0.9, shift_z, 0.01, -0.02,
                                              0.015]))
    got = tr.pull(vol, M, out_dim, order=order, fov=fov)
    torch.cuda.synchronize()
    want = tr.pull_plain(vol, M, out_dim, order=order, fov=fov)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_push_window_kernel_matches_plain(cuda, name, mat, out_dim):
    """The default window, the same given explicitly, and the anchor alone
    (which drops mass): each exact."""
    vals = _vol(out_dim, 13, cuda)
    M = tr.affine_to_M(mat)
    default = tr.push(vals, M, IN_DIM)
    assert torch.equal(default, tr.push(vals, M, IN_DIM,
                                        window=tr.push_window(M)))
    small = tr.push(vals, M, IN_DIM, window=(0, 0, 0))
    torch.cuda.synchronize()
    want = tr.push_plain(vals, M, IN_DIM, window=(0, 0, 0))
    assert float((small - want).abs().max()) == 0.0


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_slab_maps_kernels_match_plain(cuda, rank):
    """The maps and bounds of one of 4 slabs of the denoising spatial step,
    on an extended slab whose halo rows hold values (an end slab's lie
    outside the global FOV): exact."""
    from unires_torch.parallel.spatial import slab_maps, spatial_halo_bound

    dim = (64, 12, 13)
    po = proj_info(dim, np.eye(4), dim, np.eye(4),
                   rigid=affine_matrix_classic([0.8, -0.5, 0.3, 0.02, -0.01,
                                                0.015]))
    M, Minv = obs_dyn_args(po, "denoising")
    H = spatial_halo_bound(po, "denoising")
    Xl = dim[0] // 4
    x0 = rank * Xl
    mp = slab_maps(M, Minv, dim, x0, x0 - H, x0 - H, x0)
    ext = _vol((Xl + 2 * H,) + dim[1:], 14 + rank, cuda)
    loc = (Xl,) + dim[1:]
    window = tr.push_window(M)
    got = (tr.pull(ext, mp["Ml"], loc, fov=mp["fov_pull"]),
           tr.push(ext, mp["Mp"], loc, Minv=mp["Mpi"], window=window,
                   fov=mp["fov_push"]))
    torch.cuda.synchronize()
    want = (tr.pull_plain(ext, mp["Ml"], loc, fov=mp["fov_pull"]),
            tr.push_plain(ext, mp["Mp"], loc, Minv=mp["Mpi"], window=window,
                          fov=mp["fov_push"]))
    for g, w in zip(got, want):
        assert float(w.abs().max()) > 0
        assert float((g - w).abs().max()) == 0.0


def test_sharded_step_world_of_one(cuda, tmp_path):
    """make_sharded_admm_step through NCCL on one rank (B = 1, C = 2)
    against make_admm_step, on the card."""
    import types

    import torch.distributed as dist

    from unires_torch.parallel.sharding import (build_mesh, init_multihost,
                                                make_sharded_admm_step,
                                                shard_state)
    from unires_torch.solvers.admm import make_admm_step

    dim_y, dim_x = (16, 16, 17), (16, 16, 5)
    po = proj_info(dim_y, np.eye(4), dim_x, affine_diag([1, 1, 4]),
                   rigid=affine_matrix_classic([0.4, -0.2, 0.1]),
                   prof_ip=2, prof_tp=0)
    sett = unires_torch.Settings(do_print=0, cgs_max_iter=8, cgs_tol=1e-9,
                                 vx=1.0, device="cuda")
    sett.method, sett.do_proj = "super-resolution", True
    M, Minv = obs_dyn_args(po, sett.method)
    A = make_obs_ops(po, sett.method)[0]
    gt = torch.from_numpy(np.random.default_rng(0).random(
        (2,) + dim_y, dtype=np.float32) * 100).to(cuda)
    xd = torch.stack([A(g, M, Minv, 0.0) for g in gt])
    ys, z, w = gt * 0.5, torch.zeros((2, 3) + dim_y, device=cuda), \
        0.05 * torch.ones((2, 3) + dim_y, device=cuda)
    x = [[types.SimpleNamespace(po=po, tau=0.5, ct=False)] for _ in range(2)]
    y = [types.SimpleNamespace(dat=None, dim=dim_y, mat=np.eye(4), lam=0.1,
                               lam0=0.1) for _ in range(2)]
    want = make_admm_step(x, y, sett)(
        ys, z, w, [[xd[0]], [xd[1]]], [[M]] * 2, [[Minv]] * 2,
        [[0.0]] * 2, [[0.5]] * 2, [0.1, 0.1], 1.3)
    init_multihost(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cuda")
    try:
        mesh = build_mesh(1)
        step = make_sharded_admm_step(po, sett.method, sett, mesh)
        st = shard_state(mesh, ys[None], z[None], w[None], xd[None])
        n0 = (tr.pull.launches, tr.push.launches)
        got = step(*st, M, Minv, np.zeros((1, 2)), np.full((1, 2), 0.5),
                   np.full((1, 2), 0.1), 1.3)
        torch.cuda.synchronize()
        assert tr.pull.launches > n0[0] and tr.push.launches > n0[1]
    finally:
        dist.destroy_process_group()
    scale = float(want[0].abs().max())
    assert float((got[0][0] - want[0]).abs().max()) <= 2e-3 * scale
    assert float((got[1][0] - want[1]).abs().max()) <= 1e-3
    assert float((got[2][0] - want[2]).abs().max()) <= 1e-3
    np.testing.assert_allclose(got[3].cpu().numpy(), want[4].cpu().numpy(),
                               rtol=2e-3)


# --- maps in device memory, conditional nodes, the captured fit chunk ------------

@pytest.mark.parametrize("name,mat,out_dim", MAPS)
def test_device_maps_match_host_maps(cuda, name, mat, out_dim):
    """A map given as a tensor on the card is read from device memory;
    push's plan computed there (float64 torch ops) or given: bitwise the
    staged host map's results, one launch each."""
    vol, vals = _vol(IN_DIM, 11, cuda), _vol(out_dim, 12, cuda)
    M = tr.affine_to_M(mat)
    Md = torch.from_numpy(M).to(cuda)
    plan = tr.push_plan(Md, None, 1, out_dim, IN_DIM)
    n0 = (tr.pull.launches, tr.push.launches, tr.pull_grad.launches)
    got = (tr.pull(vol, Md, out_dim), tr.push(vals, Md, IN_DIM),
           tr.push(vals, Md, IN_DIM, Minv=plan), tr.pull_grad(vol, Md, out_dim))
    want = (tr.pull(vol, M, out_dim), tr.push(vals, M, IN_DIM),
            tr.push(vals, M, IN_DIM), tr.pull_grad(vol, M, out_dim))
    torch.cuda.synchronize()
    assert (tr.pull.launches, tr.push.launches, tr.pull_grad.launches) == (
        n0[0] + 2, n0[1] + 4, n0[2] + 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_captured_pull_follows_its_device_map(cuda):
    """A graph captured at one map replays at the map its buffer holds."""
    from unires_torch.utils.graph import capture

    vol = _vol(IN_DIM, 13, cuda)
    maps = [tr.affine_to_M(m) for _, m, _ in MAPS[:3]]
    Md = torch.from_numpy(maps[0]).to(cuda)
    out = torch.empty(IN_DIM, device=cuda)
    out.copy_(tr.pull(vol, Md, IN_DIM))  # launched once before the capture
    graph = capture(lambda: out.copy_(tr.pull(vol, Md, IN_DIM)))
    for M in maps[1:]:
        Md.copy_(torch.from_numpy(M))
        n0 = tr.pull.launches
        graph.replay()
        torch.cuda.synchronize()
        assert tr.pull.launches == n0 + 1  # counted by the kernel
        assert torch.equal(out, tr.pull_plain(vol, M, IN_DIM))


def test_if_nodes_run_only_where_their_predicate_holds(cuda):
    """Nested IF nodes around the kernels, a matrix product and copies: a
    false predicate launches nothing of its body."""
    from unires_torch.utils.graph import capture, cond, forced

    vol = _vol(IN_DIM, 14, cuda)
    Md = torch.from_numpy(tr.affine_to_M(MAPS[2][1])).to(cuda)
    A = torch.rand(17, 17, device=cuda)
    out = torch.zeros(IN_DIM, device=cuda)
    outer = torch.zeros((), dtype=torch.bool, device=cuda)
    inner = torch.zeros((), dtype=torch.bool, device=cuda)

    def step():
        def body():
            out.copy_(tr.pull(vol, Md, IN_DIM) @ A)
            cond(inner, lambda: out.copy_(tr.push(out, Md, IN_DIM)))
        cond(outer, body)

    with forced():
        step()
    graph = capture(step)
    want_pull = tr.pull_plain(vol, Md.cpu().numpy(), IN_DIM).to(cuda) @ A
    for o, i in ((False, True), (True, False), (True, True)):
        outer.fill_(o)
        inner.fill_(i)
        out.zero_()
        n0 = (tr.pull.launches, tr.push.launches)
        graph.replay()
        torch.cuda.synchronize()
        assert (tr.pull.launches - n0[0], tr.push.launches - n0[1]) == (
            int(o), int(o and i))
        if not o:
            assert float(out.abs().max()) == 0.0
        elif not i:
            assert torch.equal(out, want_pull)


def test_captured_chunk_matches_uncaptured(cuda):
    """The fit chunk captured as a graph against the same chunk run
    uncaptured, from one init (rigid and scaling on): the same launches in
    the same order, so equal traces, poses, scales and volumes; and the
    captured fit waits for the host once before its capture and reads it
    once per chunk."""
    from unires_torch.pipeline.fit import FitRun
    from unires_torch.utils.host import to_host

    vol = brain_phantom(seed=0)[66:114, 80:136, 66:114]
    rng = np.random.default_rng(4)
    chans = []
    for ax, rp in ((2, [1.2, -0.8, 0.5, 0.015, -0.01, 0.012]),
                   (0, [-1.0, 0.7, -0.6, -0.012, 0.01, -0.015])):
        vx = [1.0, 1.0, 1.0]
        vx[ax] = 4.0
        dim_x = list(vol.shape)
        dim_x[ax] = int(np.ceil(vol.shape[ax] / 4.0))
        po = proj_info(vol.shape, np.eye(4), tuple(dim_x), affine_diag(vx),
                       rigid=affine_matrix_classic(rp), prof_ip=2, prof_tp=0,
                       scl=0.1)
        x = unires_torch.proj_apply("A", torch.from_numpy(vol), po,
                                    "super-resolution").numpy()
        chans.append([x + rng.normal(0.0, 75.0, x.shape).astype(np.float32),
                      affine_diag(vx)])
    init = unires_torch.init([chans], unires_torch.Settings(
        device="cuda", vx=1.0, do_coreg=False, unified_rigid=True,
        scaling=True, do_print=0, max_iter=6, chunk_iters=4, tolerance=0,
        write_out=False))
    runs = {}
    for captured in (True, False):
        x, y, s = (copy.deepcopy(v) for v in init)
        run = FitRun(x, y, s, capture=captured)
        n0 = to_host.syncs
        while run.live:
            run.step()
        runs[captured] = (run, to_host.syncs - n0)
    (a, reads_a), (b, reads_b) = runs[True], runs[False]
    assert reads_a == 1 + 2 and reads_b > 2 * 6  # two chunks: 4 + 2
    np.testing.assert_array_equal(np.asarray(a.obj_trace),
                                  np.asarray(b.obj_trace))
    np.testing.assert_array_equal(a.state.host["q"], b.state.host["q"])
    np.testing.assert_array_equal(a.state.host["scl"], b.state.host["scl"])
    assert np.abs(a.state.host["q"]).max() > 0.05  # the poses moved
    assert torch.equal(a.state.ys, b.state.ys)


def test_captured_denoising_fit_matches_uncaptured(cuda):
    """UniRes' denoising method (``vx = 0`` on inputs at the recon's voxel
    size) through ``fit``, captured and uncaptured, from one init with
    unified rigid on: scaling is off (every scale stays 0), the rigid round
    moves the poses on the observations' own grids, equal traces, poses and
    volumes, and the captured fit's ``fit`` span counts pull, push and
    pull_grad launches in its replays."""
    from unires_torch.utils import trace

    vol = brain_phantom(seed=0)[66:114, 80:136, 66:114]
    rng = np.random.default_rng(6)
    chans = []
    for rp in ([1.2, -0.8, 0.5, 0.015, -0.01, 0.012],
               [-1.0, 0.7, -0.6, -0.012, 0.01, -0.015]):
        po = proj_info(vol.shape, np.eye(4), vol.shape, np.eye(4),
                       rigid=affine_matrix_classic(rp))
        x = unires_torch.proj_apply("A", torch.from_numpy(vol), po,
                                    "denoising").numpy()
        chans.append([x + rng.normal(0.0, 75.0, x.shape).astype(np.float32),
                      np.eye(4)])
    init = unires_torch.init(chans, unires_torch.Settings(
        device="cuda", vx=0, do_coreg=False, unified_rigid=True,
        scaling=True, do_print=0, max_iter=6, chunk_iters=4, tolerance=0,
        write_out=False))
    assert init[2].method == "denoising" and not init[2].scaling
    runs = {}
    for captured in (True, False):
        x, y, s = copy.deepcopy(init)
        n0 = (tr.pull.launches, tr.push.launches)
        out = fit(x, y, s, capture=captured)
        span = trace.spans("fit")[-1]
        runs[captured] = (x, out, span.attrs, (tr.pull.launches - n0[0],
                                               tr.push.launches - n0[1]))
    (xa, a, attrs, launched), (xb, b, _, _) = runs[True], runs[False]
    assert attrs["method"] == "denoising" and attrs["n_iter"] == [6]
    assert attrs["resamples"] >= sum(launched) and min(launched) >= 6
    np.testing.assert_array_equal(a[3], b[3])
    qa = np.stack([o.rigid_q for xc in xa for o in xc])
    np.testing.assert_array_equal(
        qa, np.stack([o.rigid_q for xc in xb for o in xc]))
    assert np.abs(qa).max() > 0.05  # the poses moved
    assert [o.po.scl for xc in xa for o in xc] == [0.0, 0.0]
    assert all(torch.equal(ca.dat, cb.dat) for ca, cb in zip(a[0], b[0]))


def _batch_maps(B, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        lin = np.eye(3) + 0.08 * rng.standard_normal((3, 3))
        out.append(np.hstack([lin, rng.uniform(-1.5, 1.5, (3, 1))]))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("name", ["pull", "push", "pull_grad"])
@pytest.mark.parametrize("stride", ["strided", "zero"])
def test_batched_launch_matches_unbatched(cuda, name, order, stride):
    """One launch over 3 volumes, each at its own map (push: its own plan),
    against 3 unbatched launches and the plain version, bitwise; the
    volumes a strided channel of a stack, or one volume read 3 times
    (batch stride 0). One count per launch."""
    if name == "pull_grad" and order == 0:
        pytest.skip("pull_grad is trilinear only")
    B, out_dim = 3, (13, 16, 18)
    Ms = _batch_maps(B, 11)
    Md = torch.from_numpy(Ms).to(cuda)
    src = out_dim if name == "push" else IN_DIM
    if stride == "strided":
        vols = _vol((B, 2) + src, 12, cuda)[:, 1]
    else:
        vols = _vol(src, 12, cuda).expand((B,) + src)
    kw = {} if name == "pull_grad" else dict(order=order)
    fn = getattr(tr, name)
    if name == "push":
        plans = tr.push_plan(Md, None, order, out_dim, IN_DIM)
        n0 = fn.launches
        got = fn(vols, Md, IN_DIM, Minv=plans, **kw)
        assert fn.launches == n0 + 1
        want = torch.stack([fn(vols[b], Md[b], IN_DIM, Minv=plans[b], **kw)
                            for b in range(B)])
        plain = tr.push_plain(vols, Ms, IN_DIM, Minv=plans, **kw)
    else:
        n0 = fn.launches
        got = fn(vols, Md, out_dim, **kw)
        assert fn.launches == n0 + 1
        want = torch.stack([fn(vols[b], Md[b], out_dim, **kw)
                            for b in range(B)])
        plain = getattr(tr, f"{name}_plain")(vols, Ms, out_dim, **kw)
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want) and torch.equal(got, plain)


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("B", [2, 3])
def test_pull_batch_ragged_matches_unbatched(cuda, B, order):
    """pull's batched launch of B volumes at an output grid that is not a
    multiple of its tile, against B unbatched launches and the plain
    version: exact, one count."""
    out_dim = (5, 7, 33)
    Ms = _batch_maps(B, 13)
    Md = torch.from_numpy(Ms).to(cuda)
    vols = _vol((B,) + IN_DIM, 15, cuda)
    n0 = tr.pull.launches
    got = tr.pull(vols, Md, out_dim, order=order)
    assert tr.pull.launches == n0 + 1
    want = torch.stack([tr.pull(vols[b], Md[b], out_dim, order=order)
                        for b in range(B)])
    assert float(want.abs().max()) > 0
    assert torch.equal(got, want)
    assert torch.equal(got, tr.pull_plain(vols, Ms, out_dim, order=order))


def test_captured_batch_matches_uncaptured(cuda):
    """Two subjects (a centre crop of the brain phantom at two noise and
    pose seeds, on one grid) through ``fit_batch`` captured and uncaptured:
    equal traces, poses, scales and volumes; the captured batch waits for
    the host once before its capture and reads it once per chunk."""
    from unires_torch.parallel.fit_batch import fit_batch
    from unires_torch.utils.host import to_host

    vol = brain_phantom(seed=0)[66:114, 80:136, 66:114]
    inits = []
    for seed in (4, 5):
        rng = np.random.default_rng(seed)
        chans = []
        for ax in (2, 0):
            vx = [1.0, 1.0, 1.0]
            vx[ax] = 4.0
            dim_x = list(vol.shape)
            dim_x[ax] = int(np.ceil(vol.shape[ax] / 4.0))
            rp = (list(rng.uniform(-1.2, 1.2, 3))
                  + list(rng.uniform(-0.015, 0.015, 3)))
            po = proj_info(vol.shape, np.eye(4), tuple(dim_x),
                           affine_diag(vx), rigid=affine_matrix_classic(rp),
                           prof_ip=2, prof_tp=0, scl=0.1)
            x = unires_torch.proj_apply("A", torch.from_numpy(vol), po,
                                        "super-resolution").numpy()
            chans.append([x + rng.normal(0.0, 75.0, x.shape).astype(
                np.float32), affine_diag(vx)])
        force = None if not inits else (inits[0][1][0].mat,
                                        inits[0][1][0].dim)
        inits.append(unires_torch.init([chans], unires_torch.Settings(
            device="cuda", vx=1.0, do_coreg=False, unified_rigid=True,
            scaling=True, do_print=0, max_iter=6, chunk_iters=4,
            tolerance=0, write_out=False, force_y_space=force)))
    runs = {}
    for captured in (True, False):
        xs, ys, ss = (list(t) for t in zip(*copy.deepcopy(inits)))
        n0 = to_host.syncs
        res = fit_batch(xs, ys, ss[0], capture=captured)
        runs[captured] = (xs, res, to_host.syncs - n0)
    (xa, a, reads_a), (xb, b, reads_b) = runs[True], runs[False]
    assert reads_a == 1 + 2 and reads_b > 2 * 6  # two chunks: 4 + 2
    for sa, sb, pa, pb in zip(a, b, xa, xb):
        np.testing.assert_array_equal(sa[3], sb[3])
        qa = np.stack([o.rigid_q for xc in pa for o in xc])
        qb = np.stack([o.rigid_q for xc in pb for o in xc])
        np.testing.assert_array_equal(qa, qb)
        assert all(torch.equal(ca.dat, cb.dat) for ca, cb in zip(sa[0],
                                                                 sb[0]))
    assert not np.array_equal(a[0][3], a[1][3])


def test_while_node_runs_until_its_predicate_fails(cuda):
    """A WHILE node with an IF node in its body: the body runs as long as
    the device predicate holds (none when it fails at entry), the IF body
    only where its own predicate holds, and the kernels count their
    launches in every turn."""
    from unires_torch.utils.graph import capture, cond, forced, while_loop

    vol = _vol(IN_DIM, 15, cuda)
    Md = torch.from_numpy(tr.affine_to_M(MAPS[2][1])).to(cuda)
    n = torch.zeros((), dtype=torch.int32, device=cuda)
    stop = torch.zeros((), dtype=torch.int32, device=cuda)
    acc = torch.zeros(IN_DIM, device=cuda)

    def loop():
        def body():
            cond(n % 2 == 0, lambda: acc.add_(tr.pull(vol, Md, IN_DIM)))
            n.add_(1)
        while_loop(lambda: n < stop, body)

    with forced():
        loop()
    graph = capture(loop)
    assert graph.nodes > 4
    one = tr.pull_plain(vol, Md.cpu().numpy(), IN_DIM).to(cuda)
    for start, end in ((0, 5), (3, 3), (6, 2), (1, 8)):
        n.fill_(start)
        stop.fill_(end)
        acc.zero_()
        p0 = tr.pull.launches
        graph.replay()
        torch.cuda.synchronize()
        evens = sum(1 for k in range(start, end) if k % 2 == 0)
        assert int(n) == max(start, end)
        assert tr.pull.launches - p0 == evens
        want = torch.zeros_like(one)
        for _ in range(evens):
            want = want + one
        assert torch.equal(acc, want)


def _coreg_inputs():
    """Three 4 mm thick-slice channels of a phantom crop, each displaced."""
    vol = brain_phantom(seed=0)[50:130, 60:156, 50:130]
    rng = np.random.default_rng(6)
    imgs = []
    for ax, rp in ((2, [0.0] * 6), (0, [1.5, -1.0, 0.8, 0.02, -0.015, 0.01]),
                   (1, [-1.2, 0.9, -0.6, -0.015, 0.02, -0.012])):
        vx = [1.0, 1.0, 1.0]
        vx[ax] = 4.0
        dim_x = list(vol.shape)
        dim_x[ax] = int(np.ceil(vol.shape[ax] / 4.0))
        po = proj_info(vol.shape, np.eye(4), tuple(dim_x), affine_diag(vx),
                       rigid=affine_matrix_classic(rp), prof_ip=2, prof_tp=0)
        x = unires_torch.proj_apply("A", torch.from_numpy(vol), po,
                                    "super-resolution").numpy()
        x = x + rng.normal(0.0, 75.0, x.shape).astype(np.float32)
        imgs.append((torch.from_numpy(x).to("cuda"), affine_diag(vx)))
    return imgs


def test_captured_coreg_matches_uncaptured(cuda):
    """Co-registration with every level one captured graph (a WHILE node,
    an IF node per mover) against the same levels uncaptured: equal mat_a
    digit for digit; the captured run waits for the device once per level
    (its capture) and reads it once per level, the uncaptured at every
    turn."""
    from unires_torch.pipeline import registration as treg
    from unires_torch.utils import trace
    from unires_torch.utils.host import to_host

    imgs = _coreg_inputs()
    out = {}
    for captured in (True, False):
        s0, since = to_host.syncs, trace.serial()
        mat_a = treg.affine_align(imgs, levels=(8.0, 4.0), samp=2,
                                  capture=captured)
        levels = [s.attrs for s in trace.spans("registration.level", since)]
        out[captured] = (mat_a, to_host.syncs - s0, levels)
    (ma, sa, la), (mb, sb, lb) = out[True], out[False]
    np.testing.assert_array_equal(ma, mb)
    assert len(la) == 3 and sa <= 2 * len(la)
    assert all(lv["syncs"] == 2 and lv["captured"] for lv in la)
    assert sb > 2 * len(lb)
    for a, b in zip(la, lb):
        assert a["evals"] == b["evals"] and a["turns"] == b["turns"]
        assert a["movers"] == 2 and a["turns"] == max(a["evals"]) - 1
    assert np.abs(ma[1:, :3, 3]).max() > 0.5  # the movers moved


def test_captures_outlast_the_stream_pool(cuda):
    """Graphs with conditional nodes keep capturing after PyTorch's stream
    pool (32 streams per priority) has gone round: the capture and body
    streams are the graph module's own."""
    from unires_torch.utils.graph import capture, cond, while_loop

    n = torch.zeros((), dtype=torch.int32, device=cuda)
    out = torch.zeros(4, device=cuda)

    def loop():
        def body():
            cond(n % 3 == 0, lambda: out.add_(1.0))
            n.add_(1)
        while_loop(lambda: n < 7, body)

    loop()  # uncaptured: builds and launches everything once
    for k in range(40):
        torch.cuda.Stream()  # another caller's pool stream
        graph = capture(loop)
        n.zero_()
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert int(n) == 7 and float(out[0]) == 3.0, k


# the finite-difference stencils (ops/finite_diff.py): the fit's recon grids
# (brainweb_sr3, brainweb_common), and small ones with sizes 1 and 2 and
# extents off the kernel's 32 (z) x 8 (y) x 16 (x) tile
STENCIL_DIMS = [(190, 232, 189), (192, 256, 192), (1, 1, 1), (2, 1, 5),
                (1, 2, 33), (3, 9, 2), (17, 7, 65), (33, 17, 31)]
# voxel sizes as the fit passes them (float32 values): unit, and off unit
STENCIL_VX = [(1.0, 1.0, 1.0), tuple(float(np.float32(v))
                                     for v in (0.8, 1.3, 0.9))]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _stencil_vol(shape, seed, cuda):
    """Normal values with -0.0, +0.0 and float32 denormals in a tenth of
    the voxels."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape).astype(np.float32)
    flat = v.reshape(-1)
    idx = rng.choice(flat.size, size=flat.size // 10, replace=False)
    flat[idx[0::3]] = -0.0
    flat[idx[1::3]] = 0.0
    flat[idx[2::3]] = np.float32(3e-39) * rng.choice([-1.0, 1.0],
                                                     len(idx[2::3]))
    return torch.from_numpy(v).to(cuda)


@pytest.mark.parametrize("vx", STENCIL_VX, ids=["unit", "aniso"])
@pytest.mark.parametrize("dim", STENCIL_DIMS, ids=str)
def test_stencils_match_plain_chain(cuda, dim, vx):
    """Each stencil launch against the plain zero-fill chain on the card,
    bit for bit (-0.0 and denormals included), unscaled and with a 0-d
    float64 factor as the single fit's rho lam^2; one count a launch."""
    from unires_torch.ops import finite_diff as fd

    v = _stencil_vol(dim, 21, cuda)
    p = _stencil_vol((3,) + dim, 22, cuda)
    s = torch.tensor(0.7316, dtype=torch.float64, device=cuda)
    n0 = [f.launches for f in fd.STENCILS]
    got = [fd.im_gradient(v, vx), fd.im_divergence(p, vx), fd.DtD(v, vx),
           fd.im_gradient(v, vx, scale=s), fd.im_divergence(p, vx, scale=s),
           fd.DtD(v, vx, scale=s)]
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fd.STENCILS, n0)] == [2, 2, 2]
    g = fd.gradient_plain(v, vx)
    d = fd.divergence_plain(p, vx)
    m = fd.divergence_plain(g, vx)
    want = [g, d, m, s * g, s * d, s * m]
    assert float(m.abs().max()) > 0
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dim", [(190, 232, 189), (17, 7, 65), (2, 3, 1)],
                         ids=str)
def test_stencils_batch_of_channel_views(cuda, dim):
    """B = 2 strided channel views of a stacked (B, C, X, Y, Z) state, as
    the batched fit chunk passes them, with one float32 factor per volume:
    one launch each, bitwise the plain chain and the unbatched launches."""
    from unires_torch.ops import finite_diff as fd

    B, vx = 2, STENCIL_VX[1]
    V = _stencil_vol((B, 3) + dim, 23, cuda)
    v = V[:, 1]
    p = _stencil_vol((B, 3, 3) + dim, 24, cuda)[:, 2]  # (B, 3, ...) fields
    s = torch.tensor([0.6, 1.7], dtype=torch.float64, device=cuda)
    s4 = s.to(torch.float32).reshape(B, 1, 1, 1)
    s5 = s4[..., None]
    n0 = [f.launches for f in fd.STENCILS]
    got = [fd.im_gradient(v, vx, scale=s5), fd.im_divergence(p, vx, scale=s4),
           fd.DtD(v, vx, scale=s4)]
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fd.STENCILS, n0)] == [1, 1, 1]
    g = fd.gradient_plain(v, vx)
    want = [s5 * g, s4 * fd.divergence_plain(p, vx),
            s4 * fd.divergence_plain(g, vx)]
    one = [torch.stack([fd.im_gradient(v[b], vx, scale=s[b])
                        for b in range(B)]),
           torch.stack([fd.im_divergence(p[b], vx, scale=s[b])
                        for b in range(B)]),
           torch.stack([fd.DtD(v[b], vx, scale=s[b]) for b in range(B)])]
    for a, b, c in zip(got, want, one):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a),
                                                               _bits(c))


def test_captured_membrane_follows_its_device_scale(cuda):
    """The membrane launch captured in a CUDA graph at one scale replays at
    the scale its device buffer holds, bitwise the plain chain, and its
    counter counts the replays."""
    from unires_torch.ops import finite_diff as fd
    from unires_torch.utils.graph import capture

    dim, vx = (37, 20, 70), STENCIL_VX[1]
    V = _stencil_vol((2, 3) + dim, 25, cuda)
    s = torch.tensor([0.5, 2.0], dtype=torch.float32, device=cuda)
    out = torch.empty((2,) + dim, device=cuda)
    out.copy_(fd.DtD(V[:, 0], vx, scale=s.reshape(2, 1, 1, 1)))
    graph = capture(lambda: out.copy_(
        fd.DtD(V[:, 0], vx, scale=s.reshape(2, 1, 1, 1))))
    m = fd.divergence_plain(fd.gradient_plain(V[:, 0], vx), vx)
    for scale in ([0.25, -3.0], [1.3, 0.0]):
        s.copy_(torch.tensor(scale))
        n0 = fd.DtD.launches
        graph.replay()
        torch.cuda.synchronize()
        assert fd.DtD.launches == n0 + 1
        assert torch.equal(_bits(out), _bits(s.reshape(2, 1, 1, 1) * m))


def test_stencils_dispatch_by_type_layout_and_difference(cuda):
    """A CUDA tensor launches the kernel or raises: float64 raises
    TypeError; a volume or a field that is not C-contiguous, and leading
    axes that no single batch stride describes, raise ValueError, as does a
    scale that is neither one factor nor one per volume. The 'backward' and
    'central' differences, which have no kernel, take the plain chain (no
    launch)."""
    from unires_torch.ops import finite_diff as fd

    vx = STENCIL_VX[1]
    v = _stencil_vol((5, 6, 7), 26, cuda)
    p = _stencil_vol((3, 5, 6, 7), 27, cuda)
    n0 = [f.launches for f in fd.STENCILS]
    for which in ("backward", "central"):
        assert torch.equal(fd.DtD(v, vx, which),
                           fd.divergence_plain(fd.gradient_plain(v, vx, which),
                                               vx, which))
        assert torch.equal(fd.im_gradient(v, vx, which),
                           fd.gradient_plain(v, vx, which))
        assert torch.equal(fd.im_divergence(p, vx, which),
                           fd.divergence_plain(p, vx, which))
    torch.cuda.synchronize()
    assert [f.launches for f in fd.STENCILS] == n0
    for fn in (fd.im_gradient, fd.DtD):
        with pytest.raises(TypeError):
            fn(v.double(), vx)
        with pytest.raises(ValueError):
            fn(v.transpose(0, 2), vx)
    with pytest.raises(TypeError):
        fd.im_divergence(p.double(), vx)
    with pytest.raises(ValueError):
        fd.im_divergence(p.transpose(0, 1), vx)
    # (2, 2) volumes whose leading axes are swapped: no one batch stride
    w = _stencil_vol((2, 2, 5, 6, 7), 28, cuda).transpose(0, 1)
    with pytest.raises(ValueError, match="batch stride"):
        fd.DtD(w, vx)
    torch.cuda.synchronize()
    assert [f.launches for f in fd.STENCILS] == n0
    with pytest.raises(ValueError):
        fd.DtD(v, vx, scale=torch.ones(5, 1, 1, device=cuda))


# the slice-profile blur's passes (ops/conv.py): (profiles, ratio, dim_yx)
# of brainweb_sr3's observations (the thick axis on each axis) and of
# brainweb_common's after the atlas alignment (tests/test_torch_blur.py pins
# both), and small ones with sizes off the kernel's 256-thread blocks
BLUR_CASES = {
    "sr3_thick2": ((-1, -1, 0), (1, 1, 4), (181, 217, 185)),
    "sr3_thick1": ((-1, 0, -1), (1, 4, 1), (181, 221, 181)),
    "sr3_thick0": ((0, -1, -1), (4, 1, 1), (185, 217, 181)),
    "common_thick2": ((2, 2, 0), (2, 2, 5), (369, 441, 230)),
    "common_thick1": ((2, 0, 2), (2, 5, 2), (369, 275, 369)),
    "common_thick0": ((0, 2, 2), (5, 2, 2), (230, 441, 369)),
    "small": ((2, 1, 0), (2, 3, 5), (13, 9, 21)),
    "tiny": ((0, 2, 1), (4, 2, 3), (5, 9, 7)),
}


def _blur_case(name):
    from unires_torch.kernels import kernel_1d

    prof, ratio, dim = BLUR_CASES[name]
    kers = tuple(kernel_1d(p, float(r)).astype(np.float32)
                 for p, r in zip(prof, ratio))
    n_out = tuple((n - k.shape[0]) // r + 1
                  for n, k, r in zip(dim, kers, ratio))
    # the up pass's grid: dim less the rows the down pass's stride skips
    n_up = tuple((n - 1) * r + k.shape[0]
                 for n, k, r in zip(n_out, kers, ratio))
    return kers, ratio, dim, n_out, n_up


def _blur_chain(dat, kers, ratio, up):
    from unires_torch.ops import conv

    return (conv.blur_up_plain if up else conv.blur_down_plain)(dat, kers,
                                                                ratio)


def _passes(kers, ratio):
    return sum(not (k.shape[0] == 1 and r == 1 and k[0] == 1.0)
               for k, r in zip(kers, ratio))


@pytest.mark.parametrize("name", list(BLUR_CASES))
def test_blur_passes_match_plain_chain(cuda, name):
    """Both directions against the plain per-axis chain on the card, bit
    for bit (-0.0 and denormals included); one count per pass that is not
    a dirac axis; the adjoint identity to float32 rounding."""
    from unires_torch.ops import conv

    kers, ratio, dim, n_out, n_up = _blur_case(name)
    u = _stencil_vol(dim, 31, cuda)
    v = _stencil_vol(n_out, 32, cuda)
    n0 = [f.launches for f in conv.BLURS]
    down = conv.blur_down_sep(u, kers, ratio)
    up = conv.blur_up_sep(v, kers, ratio)
    torch.cuda.synchronize()
    n = _passes(kers, ratio)
    assert [f.launches - m for f, m in zip(conv.BLURS, n0)] == [n, n]
    want_down = _blur_chain(u, kers, ratio, False)
    want_up = _blur_chain(v, kers, ratio, True)
    assert down.shape == n_out and up.shape == n_up
    assert float(want_up.abs().max()) > 0
    assert torch.equal(_bits(down), _bits(want_down))
    assert torch.equal(_bits(up), _bits(want_up))
    # <A u, v> = <u, A^T v> over the rows that the down pass reads
    u = u[tuple(slice(0, n) for n in n_up)]
    lhs = float((conv.blur_down_sep(u.contiguous(), kers, ratio).double()
                 * v.double()).sum())
    rhs = float((u.double() * up.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))


@pytest.mark.parametrize("name", ["sr3_thick2", "common_thick1", "small"])
def test_blur_batch_of_strided_volumes(cuda, name):
    """B = 2 volumes a stride apart (a channel of a stacked (B, C, ...)
    tensor), as the batched fit passes them: one launch per pass, bitwise
    the plain chain and each volume's own launches."""
    from unires_torch.ops import conv

    kers, ratio, dim, n_out, _ = _blur_case(name)
    u = _stencil_vol((2, 3) + dim, 33, cuda)[:, 1]
    v = _stencil_vol((2, 2) + n_out, 34, cuda)[:, 0]
    n0 = [f.launches for f in conv.BLURS]
    got = [conv.blur_down_sep(u, kers, ratio),
           conv.blur_up_sep(v, kers, ratio)]
    torch.cuda.synchronize()
    n = _passes(kers, ratio)
    assert [f.launches - m for f, m in zip(conv.BLURS, n0)] == [n, n]
    want = [_blur_chain(u, kers, ratio, False), _blur_chain(v, kers, ratio,
                                                            True)]
    one = [torch.stack([conv.blur_down_sep(u[b], kers, ratio)
                        for b in range(2)]),
           torch.stack([conv.blur_up_sep(v[b], kers, ratio)
                        for b in range(2)])]
    for a, b, c in zip(got, want, one):
        assert torch.equal(_bits(a), _bits(b)) and torch.equal(_bits(a),
                                                               _bits(c))


def test_blur_dirac_axes_and_dispatch(cuda):
    """A single tap of 1 at ratio 1 on every axis launches nothing and
    returns the input; a single tap of another value is one multiply a
    pass. A CUDA tensor launches the kernel or raises: float64 TypeError, a
    volume that is not C-contiguous, leading axes that no one batch stride
    describes or a down pass along an axis shorter than its taps
    ValueError."""
    from unires_torch.ops import conv

    one = (np.ones(1, np.float32),) * 3
    v = _stencil_vol((5, 6, 7), 35, cuda)
    n0 = [f.launches for f in conv.BLURS]
    assert conv.blur_down_sep(v, one, (1, 1, 1)) is v
    assert conv.blur_up_sep(v, one, (1, 1, 1)) is v
    torch.cuda.synchronize()
    assert [f.launches for f in conv.BLURS] == n0
    half = (np.ones(1, np.float32), np.full(1, 0.37, np.float32),
            np.ones(1, np.float32))
    got = [conv.blur_down_sep(v, half, (1, 1, 1)),
           conv.blur_up_sep(v, half, (1, 1, 1))]
    torch.cuda.synchronize()
    assert [f.launches - m for f, m in zip(conv.BLURS, n0)] == [1, 1]
    for g in got:
        assert torch.equal(_bits(g), _bits(v * float(half[1][0])))
    kers, ratio, dim, _, _ = _blur_case("small")
    u = _stencil_vol(dim, 36, cuda)
    n0 = [f.launches for f in conv.BLURS]
    for fn in (conv.blur_down_sep, conv.blur_up_sep):
        with pytest.raises(TypeError):
            fn(u.double(), kers, ratio)
        with pytest.raises(ValueError):
            fn(u.transpose(0, 2), kers, ratio)
        with pytest.raises(ValueError, match="batch stride"):
            fn(_stencil_vol((2, 2) + dim, 37, cuda).transpose(0, 1), kers,
               ratio)
    # the first axis's 9 taps over 3 rows: no VALID output
    with pytest.raises(ValueError, match="fewer than"):
        conv.blur_down_sep(_stencil_vol((3,) + dim[1:], 38, cuda), kers,
                           ratio)
    torch.cuda.synchronize()
    assert [f.launches for f in conv.BLURS] == n0


def test_captured_blur_counts_its_replays(cuda):
    """AᵀA's blur (down, then up) captured in a CUDA graph replays bitwise
    the plain chain, and each replay counts each pass."""
    from unires_torch.ops import conv
    from unires_torch.utils.graph import capture

    kers, ratio, dim, _, n_up = _blur_case("common_thick2")
    u = _stencil_vol(dim, 38, cuda)
    out = torch.empty(n_up, device=cuda)

    def body():
        out.copy_(conv.blur_up_sep(conv.blur_down_sep(u, kers, ratio), kers,
                                   ratio))

    body()
    graph = capture(body)
    for seed in (39, 40):
        u.copy_(_stencil_vol(dim, seed, cuda))
        want = _blur_chain(_blur_chain(u, kers, ratio, False), kers, ratio,
                           True)
        n0 = [f.launches for f in conv.BLURS]
        graph.replay()
        torch.cuda.synchronize()
        assert [f.launches - m for f, m in zip(conv.BLURS, n0)] == [3, 3]
        assert torch.equal(_bits(out), _bits(want))


# the rigid GN statistics (ops/gn_stats.py): the grids they run on, the
# observations' dim_yx of brainweb_sr3 and of brainweb_common after the
# atlas alignment (each thick axis), denoising's dim_x (no C^T C), and small
# ones off the kernel's blocks (z not a multiple of 32, y over 128 rows)
GN_CASES = {
    "sr3": ((181, 217, 185), True),
    "common_thick2": ((369, 441, 230), True),
    "common_thick1": ((369, 275, 369), True),
    "common_thick0": ((230, 441, 369), True),
    "denoise": ((181, 217, 181), False),
    "small": ((13, 9, 21), True),
    "tall": ((3, 300, 70), False),
}


def _gn_case(name, B, seed, cuda):
    """(gr, diff, ctc, coords) of a case: normal gradients, a residual with
    a tenth of zeros, a positive C^T C (or 1.0), centred coordinates."""
    from unires_torch.solvers.rigid import _centred_coords

    dim, with_ctc = GN_CASES[name]
    g = torch.Generator(device=cuda).manual_seed(seed)
    lead = (B,) if B else ()
    gr = torch.randn(lead + dim + (3,), generator=g, device=cuda)
    diff = torch.randn(lead + dim, generator=g, device=cuda)
    diff[diff.abs() < 0.125] = 0.0
    ctc = (torch.rand(dim, generator=g, device=cuda) + 0.25 if with_ctc
           else 1.0)
    coords = _centred_coords(dim, tuple((n - 1) / 2 for n in dim), cuda)
    return gr, diff, ctc, coords


def _gn_abs(gr, diff, ctc, coords):
    """Each moment's sum of |terms|: the plain chain on absolute values."""
    from unires_torch.ops import gn_stats

    return gn_stats.gn_moments_plain(
        gr.abs(), diff.abs(), ctc.abs() if torch.is_tensor(ctc) else ctc,
        tuple(c.abs() for c in coords))


def _gn_delta(v, dRq, center, cuda):
    from unires_torch.solvers.rigid import _LKP, _assemble, gn_delta

    G, W = v[:12].reshape(3, 4), v[12:].reshape(6, 10)
    g, H = _assemble(G[:, 0], G[:, 1:4], W[:, 0], W[:, 1:4], W[:, 4:], dRq,
                     center, torch.as_tensor(_LKP, device=cuda))
    return gn_delta(g, H)


@pytest.mark.parametrize("name", list(GN_CASES))
def test_gn_moments_match_plain_chain(cuda, name):
    """B = 2 subjects in one call: every moment within 1e-12 of the plain
    chain's, relative to its sum of |terms| (the float64 sums' order alone
    differs); the GN step from them within 1e-10 of its largest entry; two
    runs equal to the bit and each subject its own call's moments to the
    bit; two launches counted."""
    from unires_torch.ops import gn_stats

    args = _gn_case(name, 2, 41, cuda)
    n0 = gn_stats.gn_moments.launches
    got = gn_stats.gn_moments(*args)
    torch.cuda.synchronize()
    assert gn_stats.gn_moments.launches - n0 == 2
    want = gn_stats.gn_moments_plain(*args)
    scale = _gn_abs(*args)
    assert got.shape == want.shape == (2, gn_stats.N_MOMENTS)
    assert got.dtype == torch.float64 and float(scale.min()) > 0
    rel = float(((got - want).abs() / scale).max())
    assert rel <= 1e-12, rel
    again = gn_stats.gn_moments(*args)
    assert torch.equal(again.view(torch.int64), got.view(torch.int64))
    gr, diff, ctc, coords = args
    for b in range(2):
        one = gn_stats.gn_moments(gr[b], diff[b], ctc, coords)
        assert one.shape == (gn_stats.N_MOMENTS,)
        assert torch.equal(one.view(torch.int64), got[b].view(torch.int64))
    dim = GN_CASES[name][0]
    center = torch.tensor([(n - 1) / 2 for n in dim], dtype=torch.float64,
                          device=cuda)
    dRq = torch.from_numpy(np.random.default_rng(42).normal(
        size=(6, 4, 4))).to(cuda)
    for b in range(2):
        d_got = _gn_delta(got[b], dRq, center, cuda)
        d_want = _gn_delta(want[b], dRq, center, cuda)
        err = float((d_got - d_want).abs().max() / d_want.abs().max())
        assert err <= 1e-10, err


def test_gn_moments_dispatch_by_type_layout_and_shape(cuda):
    """A CUDA tensor launches the kernel or raises: a float64 volume or
    float32 coordinates TypeError; a gradient that is not C-contiguous, a
    residual of another shape, a C^T C of another grid, a C^T C that is a
    number other than 1 or coordinates off the device ValueError; nothing
    launches."""
    from unires_torch.ops import gn_stats

    gr, diff, ctc, coords = _gn_case("small", 2, 43, cuda)
    fn = gn_stats.gn_moments
    n0 = fn.launches
    with pytest.raises(TypeError):
        fn(gr.double(), diff, ctc, coords)
    with pytest.raises(TypeError):
        fn(gr, diff.double(), ctc, coords)
    with pytest.raises(TypeError):
        fn(gr, diff, ctc, tuple(c.float() for c in coords))
    with pytest.raises(ValueError):
        fn(gr.transpose(1, 2), diff.transpose(1, 2), ctc.transpose(0, 1),
           coords)
    with pytest.raises(ValueError):
        fn(gr.permute(0, 1, 2, 4, 3).contiguous().permute(0, 1, 2, 4, 3),
           diff, ctc, coords)
    with pytest.raises(ValueError):
        fn(gr, diff[:, :-1], ctc, coords)
    with pytest.raises(ValueError):
        fn(gr, diff, ctc[:-1], coords)
    with pytest.raises(ValueError):
        fn(gr, diff, 2.0, coords)
    with pytest.raises(ValueError):
        fn(gr, diff, ctc, tuple(c.cpu() for c in coords))
    torch.cuda.synchronize()
    assert fn.launches == n0


def test_captured_gn_moments_run_in_an_if_node(cuda):
    """The statistics inside a captured graph's IF node, as the fit
    chunk's rigid round runs them: a true predicate replays the eager
    call's moments to the bit and counts its two launches, a false one
    launches nothing."""
    from unires_torch.ops import gn_stats
    from unires_torch.utils.graph import capture, cond, forced

    gr, diff, ctc, coords = _gn_case("sr3", 2, 44, cuda)
    out = torch.zeros((2, gn_stats.N_MOMENTS), dtype=torch.float64,
                      device=cuda)
    pred = torch.ones((), dtype=torch.bool, device=cuda)

    def step():
        cond(pred, lambda: out.copy_(gn_stats.gn_moments(gr, diff, ctc,
                                                         coords)))

    with forced():
        step()
    graph = capture(step)
    for seed, p in ((45, True), (46, False), (47, True)):
        new = _gn_case("sr3", 2, seed, cuda)
        gr.copy_(new[0])
        diff.copy_(new[1])
        ctc.copy_(new[2])
        before = out.clone()
        pred.fill_(p)
        n0 = gn_stats.gn_moments.launches
        graph.replay()
        torch.cuda.synchronize()
        assert gn_stats.gn_moments.launches - n0 == 2 * p
        want = gn_stats.gn_moments(gr, diff, ctc, coords) if p else before
        assert torch.equal(out.view(torch.int64), want.view(torch.int64))
