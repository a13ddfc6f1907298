"""unires_torch's CUDA kernels on the card (marked ``gpu``; skip without one).

The kernels have no CPU mode, so these tests hold each kernel against its
plain PyTorch version on the same CUDA tensors, and a fit on the card
against the same fit on the CPU. This file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: kernel vs plain rtol 1e-5, atol 1e-5 * max|input| (float32, the
same operations in the same order); adjointness relative 1e-5; objective
traces relative 1e-4 (float32 sums in another order).
"""
import numpy as np
import pytest
import torch

import unires_torch
from unires_torch.geometry import affine_diag, affine_matrix_classic
from unires_torch.models.proj_op import proj_info
from unires_torch.ops import resample as tr
from unires_torch.pipeline.fit import fit
from unires_torch.utils.phantoms import brain_phantom

pytestmark = pytest.mark.gpu

IN_DIM = (14, 15, 17)
MAPS = [
    ("identity", np.eye(4), IN_DIM),
    ("sr", affine_diag([1.0, 1.0, 0.5]) @ affine_matrix_classic(
        [0.0, 0.0, -1.1]), (14, 15, 33)),
    ("rotated", affine_matrix_classic([0.6, -0.4, 0.3, 0.05, -0.03, 0.04]),
     (13, 16, 18)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _vol(shape, seed, device):
    v = np.random.default_rng(seed).random(shape, dtype=np.float32) - 0.3
    return torch.from_numpy(v).to(device)


def _close(got, want, scale):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * scale)


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
    _close(got_pull, tr.pull_plain(vol, M, out_dim, order=order),
           float(vol.abs().max()))
    _close(got_push, tr.push_plain(vals, M, IN_DIM, order=order),
           float(vals.abs().max()))
    lhs = float((got_pull.double() * vals.double()).sum())
    rhs = float((got_push.double() * vol.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


def test_wrappers_check_their_inputs(cuda):
    M = np.eye(4)[:3]
    with pytest.raises(TypeError):
        tr.pull(torch.zeros(IN_DIM, dtype=torch.float64, device=cuda), M, IN_DIM)
    with pytest.raises(ValueError):
        tr.push(torch.zeros(IN_DIM, device=cuda).transpose(0, 2), M, IN_DIM)
    with pytest.raises(NotImplementedError, match="queue 2"):
        tr.pull_grad(torch.zeros(IN_DIM, device=cuda), M, IN_DIM)


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
