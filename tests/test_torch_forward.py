"""unires_torch.models.forward against unires_tpu.models.forward.

proj_apply 'A' / 'At' / 'AtA' for super-resolution and denoising operators
(with a rigid pose and even/odd scaling), and check_adjoint. Tolerance rtol
1e-5 with atol 1e-5 of the output's range (float32 chains of pull, blur,
scaling and push).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unires_torch
import unires_tpu
from unires_tpu.geometry import affine_diag, affine_matrix_classic

torch.set_num_threads(2)

RIGID = affine_matrix_classic([0.7, -0.4, 0.3, 0.02, -0.015, 0.01])
OPS = {
    "sr": ("super-resolution", dict(dim_y=(12, 13, 14), mat_y=np.eye(4),
                                    dim_x=(12, 13, 4),
                                    mat_x=affine_diag([1.0, 1.0, 4.0]),
                                    rigid=RIGID, prof_ip=2, prof_tp=0,
                                    scl=0.08)),
    "sr_x": ("super-resolution", dict(dim_y=(13, 12, 14), mat_y=np.eye(4),
                                      dim_x=(4, 12, 14),
                                      mat_x=affine_diag([4.0, 1.0, 1.0]),
                                      prof_ip=2, prof_tp=0)),
    "denoise": ("denoising", dict(dim_y=(11, 12, 13), mat_y=np.eye(4),
                                  dim_x=(11, 12, 13), mat_x=np.eye(4),
                                  rigid=RIGID)),
}


def _pair(name):
    method, kw = OPS[name]
    return method, unires_tpu.proj_info(**kw), unires_torch.proj_info(**kw)


@pytest.mark.parametrize("operator", ["A", "At", "AtA"])
@pytest.mark.parametrize("name", sorted(OPS))
def test_proj_apply_matches_jax(name, operator):
    method, pj, pt = _pair(name)
    shape = pj.dim_x if operator == "At" else pj.dim_y
    dat = np.random.default_rng(0).random(shape, dtype=np.float32)
    want = np.asarray(unires_tpu.proj_apply(operator, jnp.asarray(dat), pj,
                                            method))
    got = unires_torch.proj_apply(operator, torch.from_numpy(dat), pt,
                                  method).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(OPS))
def test_check_adjoint(name):
    method, pj, pt = _pair(name)
    diff, lhs = unires_torch.check_adjoint(pt, method, seed=3)
    assert abs(diff) <= 1e-5 * abs(lhs)
    want = unires_tpu.check_adjoint(pj, method, seed=3)[1]
    assert abs(lhs - want) <= 1e-5 * abs(want)
