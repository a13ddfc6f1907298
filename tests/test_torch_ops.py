"""unires_torch's small operators against unires_tpu's.

im_gradient / im_divergence (three difference types), the polyphase strided
blur and its adjoint, and the even/odd scaling, on the same numpy-made
inputs. Tolerance rtol 1e-6 (float32, the same operations in the same order);
adjoint pairs to relative 1e-5 of the inner product.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unires_torch.ops import conv as tconv
from unires_torch.ops import finite_diff as tfd
from unires_torch.ops.scaling import apply_scaling as t_apply_scaling
from unires_tpu.kernels import kernel_1d
from unires_tpu.ops import conv as jconv
from unires_tpu.ops import finite_diff as jfd
from unires_tpu.ops.scaling import apply_scaling as j_apply_scaling

torch.set_num_threads(2)

DIM = (9, 10, 11)
VX = (np.float32(1.0), np.float32(0.8), np.float32(1.3))


def _vol(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


def _adjoint(a, Ab, b, Atc):
    lhs = float((a.astype(np.float64) * Atc).sum())
    rhs = float((Ab.astype(np.float64) * b).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1e-12)


@pytest.mark.parametrize("which", ["forward", "backward", "central"])
def test_gradient_divergence_match_jax_and_are_adjoint(which):
    u = _vol(DIM, 0)
    p = _vol((3,) + DIM, 1)
    g = tfd.im_gradient(torch.from_numpy(u), VX, which).numpy()
    d = tfd.im_divergence(torch.from_numpy(p), VX, which).numpy()
    vx = jnp.asarray(VX)
    _close(g, np.asarray(jfd.im_gradient(jnp.asarray(u), vx, which)))
    _close(d, np.asarray(jfd.im_divergence(jnp.asarray(p), vx, which)))
    _adjoint(u, g, p, d)


BLURS = [  # (1D kernels per axis, ratio): 4 mm thick slices on each axis,
    # and an in-plane Gaussian with ratio 2 on two axes
    ((kernel_1d(-1, 1.0), kernel_1d(-1, 1.0), kernel_1d(0, 4.0)), (1, 1, 4)),
    ((kernel_1d(0, 4.0), kernel_1d(-1, 1.0), kernel_1d(-1, 1.0)), (4, 1, 1)),
    ((kernel_1d(2, 2.0), kernel_1d(2, 2.0), kernel_1d(1, 1.0)), (2, 2, 1)),
]


@pytest.mark.parametrize("kers,ratio", BLURS)
def test_blur_matches_jax_and_is_adjoint(kers, ratio):
    kers = tuple(k.astype(np.float32) for k in kers)
    n_out = (5, 6, 4)
    dim_in = tuple((n - 1) * r + k.shape[0]
                   for n, r, k in zip(n_out, ratio, kers))
    u = _vol(dim_in, 2)
    v = _vol(n_out, 3)
    down = tconv.blur_down_sep(torch.from_numpy(u), kers, ratio).numpy()
    up = tconv.blur_up_sep(torch.from_numpy(v), kers, ratio).numpy()
    assert down.shape == n_out and up.shape == dim_in
    _close(down, np.asarray(jconv.blur_down_sep(jnp.asarray(u), kers, ratio)))
    _close(up, np.asarray(jconv.blur_up_sep(jnp.asarray(v), kers, ratio)))
    _adjoint(u, down, v, up)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_scaling_matches_jax(axis):
    u = _vol(DIM, 4)
    scl = np.float32(0.137)
    got = t_apply_scaling(torch.from_numpy(u), float(scl), axis).numpy()
    _close(got, np.asarray(j_apply_scaling(jnp.asarray(u), jnp.float32(scl),
                                           axis)))
    # diagonal, hence self-adjoint
    v = _vol(DIM, 5)
    _adjoint(u, got, v, t_apply_scaling(torch.from_numpy(v), float(scl),
                                        axis).numpy())
