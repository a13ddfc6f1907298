"""The plain forward model: A against its adjoint, and against the port's
own operator on the CPU (its plain PyTorch path)."""
import numpy as np
import pytest
import torch

from reference.forward import (affine_matrix_classic, backproject,
                               obs_geometry, project)


def _case(axis=1, rot=(0.03, -0.02, 0.05)):
    dim_y = (20, 23, 21)
    mat_y = np.diag([1.5, 1.5, 1.5, 1.0])
    vx = [1.5, 1.5, 1.5]
    vx[axis] = 6.0
    dim_x = [int(np.ceil(n * 1.5 / v)) for n, v in zip(dim_y, vx)]
    mat_x = affine_matrix_classic([0.7, -1.1, 0.4, *rot]) @ np.diag(vx + [1])
    rigid = affine_matrix_classic([0.3, 0.2, -0.5, 0.01, 0.02, -0.015])
    geom = obs_geometry(dim_y, mat_y, dim_x, mat_x, 2, 0)
    return dim_y, mat_y, mat_x, rigid, geom


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_project_is_the_adjoint_of_backproject(axis):
    dim_y, mat_y, _, rigid, geom = _case(axis)
    g = torch.Generator().manual_seed(axis)
    y = torch.rand(dim_y, generator=g, dtype=torch.float64)
    x = torch.rand(geom["dim_x"], generator=g, dtype=torch.float64)
    lhs = float((project(y, mat_y, rigid, geom, 0.1) * x).sum())
    rhs = float((backproject(x, mat_y, rigid, geom, 0.1) * y).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.parametrize("axis", [0, 2])
def test_project_matches_the_port(axis):
    from unires_torch.models.forward import proj_apply
    from unires_torch.models.proj_op import proj_info

    dim_y, mat_y, mat_x, rigid, geom = _case(axis)
    po = proj_info(dim_y, mat_y, geom["dim_x"], mat_x, rigid=rigid,
                   prof_ip=2, prof_tp=0, scl=0.1)
    assert po.dim_yx == geom["dim_yx"]
    assert np.abs(po.mat_yx - geom["mat_yx"]).max() < 1e-12
    y = torch.rand(dim_y, generator=torch.Generator().manual_seed(5)) * 1000
    port = proj_apply("A", y, po, "super-resolution").double()
    ref = project(y.double(), mat_y, rigid, geom, np.float32(0.1))
    assert float((port - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_the_weights_are_the_ports(tiny_cell):
    from harness import inputs, judge, program

    cell = tiny_cell("sr3.subjects")
    cf = cell["config"]
    cf["settings"].update(do_coreg=False, max_iter=1)
    gts = inputs.ground_truths(cf, "cpu")
    subject = inputs.make_subject(cf, cell["traffic"], gts, 99, 0, 0, "cpu")
    x, y, sett = program.run_mod.init(subject["inputs"],
                                      program.settings(cf, "cpu"))
    taus, lams = judge.subject_weights(subject, cf)
    assert taus == pytest.approx([o.tau for xc in x for o in xc], rel=1e-14)
    reg = cf["settings"]["reg_scl"]
    assert lams == pytest.approx([reg * yc.lam0 for yc in y], rel=1e-15)
