"""The port's host float64 SE(3) exponential (``unires_torch.geometry.expm``
and ``dexpm``) and ``unires_torch.ops.lie`` against unires_tpu.ops.lie
(float32), which the JAX fit loop uses.

Seeded poses of the size the fit and co-registration meet (a few mm, a few
hundredths of a radian) and one near zero, where the JAX closed form switches
to its series. Tolerance: rtol 1e-6 with atol 1e-6 times the largest entry
(the JAX functions round in float32, about 6e-8 relative per operation);
for dR, whose JAX version differentiates the float32 closed form and loses
digits to the cancellation in (th - sin th) / th^3, atol 5e-5 times the
largest entry, and the port's dR is also held to central differences of its
own float64 exponential at 1e-7.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from unires_torch.geometry import (affine_basis, affine_matrix_classic, dexpm,
                                   expm)
from unires_torch.ops import lie as tl
from unires_tpu.ops import lie as jl

BASIS = affine_basis("SE")
rng = np.random.default_rng(0)
QS = [np.concatenate([rng.uniform(-3, 3, 3), rng.uniform(-0.05, 0.05, 3)])
      for _ in range(3)] + [np.array([0.5, -0.2, 0.1, 1e-6, -2e-6, 1e-6])]


def _close(got, want):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("q", QS, ids=range(len(QS)))
def test_se3_expm_and_dexpm_match_jax(q):
    Bj = jnp.asarray(BASIS, jnp.float32)
    qj = jnp.asarray(q, jnp.float32)
    q32 = np.asarray(np.float32(q), np.float64)  # the same pose as JAX's
    _close(expm(q32, BASIS), jl.se3_expm(qj, Bj))
    _close(expm(q32, BASIS), jl.group_expm(qj, Bj))
    R, dR = dexpm(q32, BASIS)
    Rj, dRj = jl.se3_dexpm(qj, Bj)
    _close(R, Rj)
    assert dR.shape == (6, 4, 4)
    np.testing.assert_allclose(dR, np.asarray(dRj, np.float64), rtol=1e-6,
                               atol=5e-5 * np.abs(dR).max())
    h = 1e-6
    fd = np.stack([(expm(q32 + h * e, BASIS)
                    - expm(q32 - h * e, BASIS)) / (2 * h)
                   for e in np.eye(6)])
    np.testing.assert_allclose(dR, fd, atol=1e-7)


def test_inv44_and_compose_maps_match_jax():
    M4 = affine_matrix_classic([12.0, -30.0, 7.5, 0.05, -0.03, 0.04])
    M4[:3, :3] *= np.array([1.0, 1.0, 0.25])
    _close(tl.inv44(M4), jl.inv44(jnp.asarray(M4, jnp.float32)))
    pre = np.eye(4)
    pre[:3, 3] = [-90.0, -108.0, -90.0]
    post = np.eye(4)
    post[:3, 3] = [90.0, 108.0, 88.0]
    post[2, 2] = 0.25
    R = expm(QS[0], BASIS)
    M, Minv = tl.compose_maps(pre, R, post)
    Mj, Minvj = jl.compose_maps(*(jnp.asarray(a, jnp.float32)
                                  for a in (pre, R, post)))
    assert M.dtype == Minv.dtype == np.float32 and M.shape == (3, 4)
    np.testing.assert_allclose(M, Mj, rtol=1e-6, atol=1e-6 * 108.0)
    np.testing.assert_allclose(Minv, Minvj, rtol=1e-6, atol=1e-5 * 108.0)
    M4c = np.eye(4)
    M4c[:3, :4] = M
    np.testing.assert_allclose(np.linalg.inv(M4c)[:3], Minv, rtol=1e-5,
                               atol=1e-4)
