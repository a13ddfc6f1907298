"""unires_torch's host-side numpy modules against unires_tpu's.

The port carries copies of geometry, kernels, proj_op, nifti, hyperpar and
the brain phantom (the JAX package imports JAX at import time, which the
card's machine lacks). Same numpy code, so: exact, or 1e-12 in float64.
"""
import dataclasses

import numpy as np
import pytest

import unires_torch
import unires_tpu
from phantoms import brain_phantom as j_brain_phantom
from unires_torch import geometry as tg
from unires_torch import kernels as tk
from unires_torch.pipeline import hyperpar as th
from unires_torch.pipeline import nifti as tn
from unires_torch.utils.phantoms import brain_phantom as t_brain_phantom
from unires_tpu import geometry as jg
from unires_tpu import kernels as jk
from unires_tpu.pipeline import hyperpar as jh
from unires_tpu.pipeline import nifti as jn

RIGID = jg.affine_matrix_classic([1.5, -0.8, 0.4, 0.03, -0.02, 0.015])

PROJ = {
    "sr": dict(dim_y=(30, 31, 32), mat_y=np.eye(4), dim_x=(30, 31, 8),
               mat_x=jg.affine_diag([1.0, 1.0, 4.0]), rigid=RIGID,
               prof_ip=2, prof_tp=0, gap=0.1, scl=0.12),
    "sr_rotated_x": dict(dim_y=(32, 30, 31), mat_y=jg.affine_diag([1, 1, 1]),
                         dim_x=(9, 30, 31),
                         mat_x=RIGID @ jg.affine_diag([3.5, 1.0, 1.0]),
                         prof_ip=1, prof_tp=2),
    "denoise": dict(dim_y=(20, 21, 22), mat_y=np.eye(4), dim_x=(20, 21, 22),
                    mat_x=np.eye(4), rigid=RIGID, scl=-0.05),
    "subsampled": dict(dim_y=(30, 31, 32), mat_y=np.eye(4), dim_x=(30, 31, 8),
                       mat_x=jg.affine_diag([1.0, 1.0, 4.0]), samp=2),
}


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    elif isinstance(a, tuple) and a and isinstance(a[0], np.ndarray):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    elif isinstance(a, (np.ndarray, float)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(PROJ))
def test_proj_info_field_by_field(name):
    pj = unires_tpu.proj_info(**PROJ[name])
    pt = unires_torch.proj_info(**PROJ[name])
    for f in dataclasses.fields(pj):
        _same(getattr(pt, f.name), getattr(pj, f.name))
    for meth in ("M_sr", "M_den"):
        np.testing.assert_array_equal(getattr(pt, meth)(), getattr(pj, meth)())


def test_settings_defaults_match_except_device():
    jf = {f.name: f for f in dataclasses.fields(unires_tpu.Settings)}
    tf = {f.name: f for f in dataclasses.fields(unires_torch.Settings)}
    assert set(jf) == set(tf)
    js, ts = unires_tpu.Settings(), unires_torch.Settings()
    for name in jf:
        if name == "device":
            continue
        assert getattr(ts, name) == getattr(js, name), name
    assert ts.device == "cuda"


def test_geometry_functions_match():
    rng = np.random.default_rng(0)
    q = rng.uniform(-0.1, 0.1, 6)
    B = jg.affine_basis("SE")
    np.testing.assert_array_equal(tg.affine_basis("SE"), B)
    np.testing.assert_array_equal(tg.expm(q, B), jg.expm(q, B))
    R, dR = tg.dexpm(q, B)
    R2, dR2 = jg.dexpm(q, B)
    np.testing.assert_array_equal(R, R2)
    np.testing.assert_array_equal(dR, dR2)
    np.testing.assert_allclose(tg.rigid_log(RIGID), jg.rigid_log(RIGID),
                               rtol=1e-12, atol=1e-12)
    c = jg.fov_centre(np.eye(4), (30, 31, 32))
    np.testing.assert_array_equal(tg.fov_centre(np.eye(4), (30, 31, 32)), c)
    np.testing.assert_array_equal(tg.rigid_from_q(q, B, c),
                                  jg.rigid_from_q(q, B, c))
    mats = np.stack([RIGID @ jg.affine_diag([1, 1, 4]), jg.affine_diag([4, 1, 1]),
                     jg.affine_diag([1, 4, 1])])
    dims = np.array([[30, 31, 8], [8, 31, 32], [30, 8, 32]])
    for vx in (None, 1.0):
        for a, b in zip(tg.mean_space(mats, dims, vx), jg.mean_space(mats, dims, vx)):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tg.ceil_pow([181, 217, 181], mx=256),
                                  jg.ceil_pow([181, 217, 181], mx=256))
    for fov in ("brain", "head"):
        for a, b in zip(tg.bb_atlas(fov), jg.bb_atlas(fov)):
            np.testing.assert_array_equal(a, b)


def test_slice_profile_kernels_match():
    for prof in (-1, 0, 1, 2):
        for fwhm in (1.0, 2.5, 4.0):
            np.testing.assert_array_equal(tk.kernel_1d(prof, fwhm),
                                          jk.kernel_1d(prof, fwhm))
    np.testing.assert_array_equal(tk.smooth_kernel([2, 2, 0], [1.0, 1.0, 4.0]),
                                  jk.smooth_kernel([2, 2, 0], [1.0, 1.0, 4.0]))


def test_brain_phantom_copy_matches():
    for contrast in ("t1", "pd"):
        np.testing.assert_array_equal(
            t_brain_phantom(dim=(20, 24, 21), contrast=contrast, seed=2),
            j_brain_phantom(dim=(20, 24, 21), contrast=contrast, seed=2))


def test_nifti_written_by_one_package_reads_in_the_other(tmp_path):
    dat = np.random.default_rng(1).random((6, 7, 8), dtype=np.float32)
    aff = RIGID @ jg.affine_diag([1.0, 1.2, 3.0])
    p = str(tmp_path / "a.nii.gz")
    tn.save(dat, p, affine=aff)
    got, hdr = jn.load(p)
    np.testing.assert_array_equal(got, dat)
    np.testing.assert_allclose(hdr.affine, aff, atol=1e-6)
    got2, hdr2 = tn.load(p)
    np.testing.assert_array_equal(got2, dat)
    np.testing.assert_array_equal(hdr2.affine, hdr.affine)


@pytest.mark.parametrize("model", ["gaussian", "rician"])
def test_noise_estimate_matches(model):
    import torch

    rng = np.random.default_rng(3)
    vol = np.abs(rng.normal(0.0, 30.0, (20, 20, 20))).astype(np.float32)
    vol[5:15, 5:15, 5:15] += 800.0
    want = jh.estimate_noise(vol, model=model)
    got = th.estimate_noise(torch.from_numpy(vol), model=model)
    np.testing.assert_allclose(got, want, rtol=1e-12)
