"""UniRes' denoising method in the port against the benchmark's plain
reference (``benchmark/reference/``, PyTorch and NumPy, nothing of the
program), on the CPU.

With the inputs at the recon's voxel size (``vx = 0``, upstream's
``--denoising``) every axis has ratio 1 and a dirac profile, so the
reference's ``project`` is a pull onto the observation's own grid and
``backproject`` its push: the port's denoising ``A`` and ``Aᵀ``
(``models.forward``). A tiny ``brainweb_denoise3`` subject (the
``denoise3.subjects`` cell at 8 mm, ``benchmark/tests/tiny_denoise.py``)
then runs through ``pipeline.run.preproc`` as the benchmark's timed path
runs it.

Tolerances, each with its reason:

* ``A``, ``Aᵀ``, ``AᵀA`` against the reference, 1e-4 of the largest value:
  the port forms its sample points in float32 (the reference in float64),
  a shift of ~1e-6 voxel that moves a value by up to its gradient times
  that; no point lies near the edge of the field of view, where the shift
  would flip the mask (checked).
* the port's adjoint, 1e-12: ``push`` is the gather form of ``pull``ᵀ with
  the same float32 points and weights, so only float64 sums differ.
* the fit's last data term against the port's own operator evaluated in
  float64 at the returned answer, 1e-6: the fit sums in float32. Against
  the reference, 5e-4: at 8 mm the recon nearly interpolates the data (the
  residual is ~3 % of the noise), so the float32 sample points alone move
  the small data term by 4e-5 to 9e-5 relative (three seeds).
* the prior term against the reference, 1e-6: float32 stencils and sums
  (sound runs read 1e-8 to 3e-8).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unires_torch.models.forward import proj_apply
from unires_torch.models.proj_op import proj_info
from unires_torch.ops.resample import pull
from unires_torch.utils import trace

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
for _p in (BENCH, BENCH / "tests"):
    if str(_p) not in sys.path:
        sys.path.append(str(_p))

from harness import inputs, judge, program, spec  # noqa: E402
from reference.forward import (  # noqa: E402
    affine_matrix_classic, backproject, obs_geometry, project, sample_points)
from tiny_denoise import tiny_denoise3  # noqa: E402

SEED = 2 ** 31 + 12346
POSES = {
    "shifted": ([0.4, -0.7, 0.3, 0.0, 0.0, 0.0],
                [0.3, 0.2, -0.5, 0.0, 0.0, 0.0]),
    "rotated": ([0.7, -1.1, 0.4, 0.03, -0.02, 0.05],
                [0.3, 0.2, -0.5, 0.01, 0.02, -0.015]),
}


def _case(pose):
    """A ratio-1 geometry: a 24 x 20 x 18 recon grid and an observation of
    the same 1.5 mm voxels at its own header and world pose ``rigid``."""
    header, rigid = (affine_matrix_classic(p) for p in POSES[pose])
    dim_y, mat_y = (24, 20, 18), np.diag([1.5, 1.5, 1.5, 1.0])
    dim_x, mat_x = (23, 21, 18), header @ np.diag([1.5, 1.5, 1.5, 1.0])
    geom = obs_geometry(dim_y, mat_y, dim_x, mat_x, 2, 0)
    po = proj_info(dim_y, mat_y, dim_x, mat_x, rigid=rigid, prof_ip=2,
                   prof_tp=0)
    return po, geom, rigid


def _clear_of_the_edges(M, out_dim, vol_dim, margin=1e-5):
    """No sample point lies within ``margin`` voxel of [-0.5, n - 0.5]:
    several times the float32 points' error at these coordinates (< 25
    voxels, a few roundings of 6e-8 relative each)."""
    g = sample_points(M, out_dim, "cpu", torch.float64)
    return all(float(((g[d] + 0.5).abs().min())) > margin
               and float(((g[d] - vol_dim[d] + 0.5).abs().min())) > margin
               for d in range(3))


@pytest.mark.parametrize("pose", sorted(POSES))
@pytest.mark.parametrize("op", ["A", "At", "AtA"])
def test_denoising_operator_matches_the_reference(op, pose):
    po, geom, rigid = _case(pose)
    assert geom["ratio"] == po.ratio == (1, 1, 1)
    assert geom["dim_yx"] == po.dim_x and np.allclose(geom["mat_yx"],
                                                      po.mat_x)
    M = np.linalg.solve(po.mat_y, rigid @ geom["mat_yx"])
    assert _clear_of_the_edges(M, po.dim_x, po.dim_y)
    g = torch.Generator().manual_seed(3)
    y = torch.rand(po.dim_y, generator=g, dtype=torch.float64) * 1000
    x = torch.rand(po.dim_x, generator=g, dtype=torch.float64) * 1000
    if op == "A":
        got = proj_apply("A", y, po, "denoising")
        want = project(y, po.mat_y, rigid, geom, 0.0)
    elif op == "At":
        got = proj_apply("At", x, po, "denoising")
        want = backproject(x, po.mat_y, rigid, geom, 0.0)
    else:
        got = proj_apply("AtA", y, po, "denoising")
        want = backproject(project(y, po.mat_y, rigid, geom, 0.0),
                           po.mat_y, rigid, geom, 0.0)
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.parametrize("pose", sorted(POSES))
def test_denoising_operator_is_adjoint(pose):
    po, _, _ = _case(pose)
    g = torch.Generator().manual_seed(7)
    y = torch.rand(po.dim_y, generator=g, dtype=torch.float64)
    x = torch.rand(po.dim_x, generator=g, dtype=torch.float64)
    lhs = float((proj_apply("A", y, po, "denoising") * x).sum())
    rhs = float((proj_apply("At", x, po, "denoising") * y).sum())
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.fixture(scope="module")
def tiny_run():
    """One tiny subject through ``pipeline.run.preproc`` (the harness's
    ``program.run_unit``): (subject, output, config, the unit's spans)."""
    cell = tiny_denoise3()
    cf = cell["config"]
    gts = inputs.ground_truths(cf, "cpu")
    subject = inputs.make_subject(cf, cell["traffic"], gts, SEED, 0, 0, "cpu")
    since = trace.serial()
    _, _, outs = program.run_unit(cf, [subject], "cpu")
    return subject, outs[0], cf, trace.spans(since=since)


def test_preproc_denoises_and_fits_no_scale(tiny_run):
    subject, out, cf, spans = tiny_run
    fit = [s for s in spans if s.name == "fit"]
    assert len(fit) == 1 and fit[0].attrs["method"] == "denoising"
    assert 0 < out["n_iter"] < out["max_iter"]
    assert out["scls"] == [0.0] * len(subject["obs"])
    # the recon keeps the inputs' 8 mm voxels
    assert np.allclose(np.sqrt((out["mat_y"][:3, :3] ** 2).sum(0)), 8.0)


def test_last_objective_row_agrees_with_the_reference(tiny_run):
    subject, out, cf, _ = tiny_run
    data, prior = judge.reference_objective(subject, out, cf)
    own = 0.0  # the port's own operator, in float64 values
    for o in judge._obs(subject, out, cf):
        M = np.linalg.solve(out["mat_y"], o["rigid"] @ o["geom"]["mat_yx"])
        Ay = pull(out["ys"][o["c"]].double(), M[:3].astype(np.float32),
                  o["geom"]["dim_yx"])
        x = o["x"].double()
        res = torch.where(x != 0, x - Ay, 0.0)
        own += 0.5 * o["tau"] * float((res * res).sum())
    got = out["obj_last"]
    assert abs(got[1] - own) <= 1e-6 * own
    assert abs(got[1] - data) <= 5e-4 * data
    assert abs(got[2] - prior) <= 1e-6 * prior


def test_the_spans_carry_method_and_resamples(tiny_run):
    _, _, _, spans = tiny_run
    grid = [s for s in spans if s.name == "init.grid"]
    assert len(grid) == 1
    assert grid[0].attrs == {"method": "denoising", "proj": True}
    fit = next(s for s in spans if s.name == "fit")
    # the plain versions ran: no kernel launched
    assert fit.attrs["resamples"] == 0 and fit.attrs["stencils"] == 0
