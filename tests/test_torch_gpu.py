"""unires_torch's CUDA kernels on the card (marked ``gpu``; skip without one).

The kernels have no CPU mode, so these tests hold each kernel against its
plain PyTorch version on the same CUDA tensors, and a fit on the card
against the same fit on the CPU. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: every kernel vs its plain version exact (the same roundings in
the same order); adjointness relative 1e-5; objective
traces relative 1e-4 (float32 sums in another order), 1e-3 with the rigid
and scaling updates on (they feed the sums' differences back into the fit);
co-registration card vs CPU 0.1 mm / 2e-3.
"""
import numpy as np
import pytest
import torch

import unires_torch
from chip_smoke import centred_map
from unires_torch.geometry import affine_diag, affine_matrix_classic
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
