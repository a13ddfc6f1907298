"""unires_torch's small operators against unires_tpu's.

im_gradient / im_divergence and DtD (three difference types; their
``scale`` form against the scaled chain, bitwise), the
polyphase strided blur and its adjoint, the dense-kernel blur pair, the
even/odd scaling and slice groups, and the ADMM tables (DCT and Fourier
membrane eigenvalues, the zero z / w), on the same numpy-made inputs.
Tolerance rtol 1e-6 (float32, the same operations in the same order); the
dense blur, whose taps the port sums in another order than XLA's
convolution, rtol 1e-5; the tables exact; adjoint pairs to relative 1e-5 of
the inner product.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unires_torch.ops import conv as tconv
from unires_torch.ops import finite_diff as tfd
from unires_torch.ops import scaling as tscaling
from unires_torch.ops.scaling import apply_scaling as t_apply_scaling
from unires_torch.solvers import admm as tadmm
from unires_tpu.kernels import kernel_1d
from unires_tpu.ops import conv as jconv
from unires_tpu.ops import finite_diff as jfd
from unires_tpu.ops import scaling as jscaling
from unires_tpu.ops.scaling import apply_scaling as j_apply_scaling
from unires_tpu.solvers import admm as jadmm

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


@pytest.mark.parametrize("which", ["forward", "backward", "central"])
def test_dtd_matches_jax(which):
    u = _vol(DIM, 6)
    got = tfd.DtD(torch.from_numpy(u), VX, which).numpy()
    _close(got, np.asarray(jfd.DtD(jnp.asarray(u), jnp.asarray(VX), which)))


SCALES = {  # the scale forms the ADMM body passes: one float64 factor (a
    # single fit's rho lam^2), and one float32 factor per subject of a batch
    "one": lambda B: torch.tensor(0.731, dtype=torch.float64),
    "per_volume": lambda B: torch.tensor([0.731, 1.9], dtype=torch.float32)[:B],
}


def _channel_view(B, seed):
    """Channel 1 of a stacked (B, 3, X, Y, Z) state: (B, X, Y, Z) volumes,
    each contiguous, 3 volumes apart (a single fit's (X, Y, Z) for B = 0)."""
    st = torch.from_numpy(_vol((max(B, 1), 3) + DIM, seed))
    return st[0, 1] if B == 0 else st[:, 1]


@pytest.mark.parametrize("B,scale", [(0, "one"), (2, "one"),
                                     (2, "per_volume")])
def test_scaled_stencils_equal_scale_times_the_chain(B, scale):
    """DtD / im_gradient / im_divergence with ``scale`` equal ``scale *``
    the unscaled chain bit for bit, for a 0-d factor and one per volume."""
    v = _channel_view(B, 10)
    p = torch.from_numpy(_vol(tuple(v.shape[:-3]) + (3,) + DIM, 11))
    s = SCALES[scale](B)
    sv = s if s.dim() == 0 else s.to(torch.float32).reshape(B, 1, 1, 1)
    sg = sv if s.dim() == 0 else sv[..., None]
    assert torch.equal(tfd.DtD(v, VX, scale=sv),
                       sv * tfd.im_divergence(tfd.im_gradient(v, VX), VX))
    assert torch.equal(tfd.im_gradient(v, VX, scale=sg),
                       sg * tfd.im_gradient(v, VX))
    assert torch.equal(tfd.im_divergence(p, VX, scale=sv),
                       sv * tfd.im_divergence(p, VX))


@pytest.mark.parametrize("B", [0, 2])
def test_dispatching_stencils_are_adjoint(B):
    """<D v, p> = <v, D^T p> and <D v, D v> = <v, D^T D v> through the
    public functions, on a batch of strided channel views too."""
    v = _channel_view(B, 12)
    p = torch.from_numpy(_vol(tuple(v.shape[:-3]) + (3,) + DIM, 13))
    _adjoint(v.numpy(), tfd.im_gradient(v, VX).numpy(), p.numpy(),
             tfd.im_divergence(p, VX).numpy())
    g = tfd.im_gradient(v, VX).double()
    lhs = float((g * g).sum())
    rhs = float((v.double() * tfd.DtD(v, VX).double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs)


DENSE = [  # (kernel shape, ratio, output grid): 3D, and 2D
    ((3, 2, 5), (2, 1, 3), (5, 8, 4)),
    ((3, 4), (2, 3), (6, 5)),
]


@pytest.mark.parametrize("kshape,ratio,n_out", DENSE)
def test_dense_blur_matches_jax_and_is_adjoint(kshape, ratio, n_out):
    ker = np.random.default_rng(7).random(kshape).astype(np.float32)
    dim_in = tuple((n - 1) * r + k for n, r, k in zip(n_out, ratio, kshape))
    u = _vol(dim_in, 8)
    v = _vol(n_out, 9)
    down = tconv.blur_down(torch.from_numpy(u), ker, ratio).numpy()
    up = tconv.blur_up(torch.from_numpy(v), ker, ratio).numpy()
    assert down.shape == n_out and up.shape == dim_in
    for got, want in (
            (down, jconv.blur_down(jnp.asarray(u), jnp.asarray(ker), ratio)),
            (up, jconv.blur_up(jnp.asarray(v), jnp.asarray(ker), ratio))):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want).max()))
    _adjoint(u, down, v, up)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_even_odd_slices_match_jax(axis):
    u = _vol(DIM, 10)
    for tf, jf in ((tscaling.even_slices, jscaling.even_slices),
                   (tscaling.odd_slices, jscaling.odd_slices)):
        np.testing.assert_array_equal(tf(torch.from_numpy(u), axis).numpy(),
                                      np.asarray(jf(jnp.asarray(u), axis)))


@pytest.mark.parametrize("name", ["dct_membrane_eigs",
                                  "fourier_membrane_eigs"])
@pytest.mark.parametrize("dim,vx", [(DIM, VX), ((16, 16, 17), (1, 1, 4))])
def test_membrane_eigs_match_jax(name, dim, vx):
    got = getattr(tadmm, name)(dim, vx).numpy()
    want = np.asarray(getattr(jadmm, name)(dim, vx))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_admm_aux_matches_jax():
    got = tadmm.admm_aux(2, DIM)
    want = jadmm.admm_aux(2, DIM)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
