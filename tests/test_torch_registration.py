"""The port's NMI co-registration (``affine_align``) against the JAX
package's, on the problems of tests/test_registration.py.

Tolerances: recovery of the true misalignment as in that file (< 1 mm
translation, < 0.02 in the rotation block); agreement with the JAX package's
mat_a to 0.1 mm and 2e-3 (the two optimisers take the same accept/reject
decisions on float32 losses only up to near-ties, and the port reslices
through pull where the JAX package uses separable matrices); the mean gauge
to 1e-9 (relative transforms) and 1e-6 (Lie mean).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phantoms import blob_phantom
from unires_torch.geometry import affine_basis, affine_matrix_classic, rigid_log
from unires_torch.pipeline import registration as treg
from unires_tpu.pipeline import registration as jreg

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def two_contrast():
    """Fixed image and a differently contrasted, misaligned moving image."""
    gt = blob_phantom(dim=(48, 48, 48), amplitude=1000.0, seed=3)
    rng = np.random.default_rng(0)
    fix_dat = gt + 20.0 * rng.standard_normal(gt.shape).astype(np.float32)
    mov_dat = (1500.0 * np.sqrt(gt / 1000.0)).astype(np.float32) \
        + 20.0 * rng.standard_normal(gt.shape).astype(np.float32)
    R_true = affine_matrix_classic([3.0, -2.0, 1.5, 0.05, -0.03, 0.04])
    imgs = [(fix_dat, np.eye(4)), (mov_dat, R_true)]
    kw = dict(fix=0, cost_fun="nmi", group="SE", samp=2, fwhm=4.0,
              levels=(6.0, 3.0, 2.0))
    mat_t = treg.affine_align([(torch.from_numpy(d), m) for d, m in imgs],
                              **kw)
    mat_j = jreg.affine_align([(jnp.asarray(d), m) for d, m in imgs], **kw)
    return R_true, mat_t, mat_j


def test_affine_align_recovers_translation_and_rotation(two_contrast):
    R_true, mat_a, _ = two_contrast
    aligned = np.linalg.solve(mat_a[1], R_true)
    assert (np.abs(aligned[:3, 3]) < 1.0).all(), aligned
    assert (np.abs(aligned[:3, :3] - np.eye(3)) < 0.02).all(), aligned


def test_affine_align_matches_jax(two_contrast):
    _, mat_t, mat_j = two_contrast
    np.testing.assert_allclose(mat_t[0], np.eye(4), atol=1e-12)
    np.testing.assert_allclose(mat_t[1][:3, 3], mat_j[1][:3, 3], atol=0.1)
    np.testing.assert_allclose(mat_t[1][:3, :3], mat_j[1][:3, :3], atol=2e-3)


def test_affine_align_identity_for_fixed():
    gt = blob_phantom(dim=(24, 24, 24), seed=1)
    mat_a = treg.affine_align([(torch.from_numpy(gt), np.eye(4))] * 2, fix=0,
                              levels=(4.0,))
    assert np.allclose(mat_a[0], np.eye(4))
    # the same image twice: the mover stays where it is
    np.testing.assert_allclose(mat_a[1], np.eye(4), atol=0.05)


def test_affine_align_mean_gauge():
    gt = blob_phantom(dim=(24, 26, 24), seed=3)
    R_true = affine_matrix_classic([2.0, -1.5, 1.0, 0.04, -0.02, 0.03])
    imgs = [(torch.from_numpy(gt), np.eye(4)), (torch.from_numpy(gt), R_true)]
    a_fix = treg.affine_align(imgs, fix=0, levels=(4.0,), gauge="fix")
    a_mean = treg.affine_align(imgs, fix=0, levels=(4.0,), gauge="mean")
    np.testing.assert_allclose(np.linalg.solve(a_mean[0], a_mean[1]),
                               np.linalg.solve(a_fix[0], a_fix[1]), atol=1e-9)
    B = affine_basis("SE")
    qbar = np.mean([rigid_log(a_mean[i], B) for i in range(2)], axis=0)
    assert np.abs(qbar).max() < 1e-6, qbar


def test_smoothing_matches_jax():
    """The separable smoothing: slices and adds against JAX's convolution
    (float32, rtol 1e-5)."""
    vol = np.random.default_rng(1).random((9, 10, 11), dtype=np.float32)
    ks = [treg._gauss_kernel1d(sd) for sd in (0.0, 1.3, 2.2)]
    got = treg._smooth_sep(torch.from_numpy(vol), *ks).numpy()
    want = np.asarray(jreg._smooth_sep(jnp.asarray(vol),
                                       *[jnp.asarray(k) for k in ks]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
