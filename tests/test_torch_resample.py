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
