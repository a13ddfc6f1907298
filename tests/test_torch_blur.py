"""The slice-profile blur's dispatch on the CPU, and the geometry that the
``common.subjects`` benchmark cell runs it at.

``blur_down_sep`` / ``blur_up_sep`` take the plain per-axis chain
(``_down_1d`` / ``_up_1d``) for a CPU tensor, bit for bit, and leave the
device launch counters of the CUDA passes (``conv.BLURS``) untouched; the
CUDA passes themselves are held to the same chain on the card
(``tests/test_torch_gpu.py``). The geometry: an observation of the
``brainweb_common`` configuration, aligned to the atlas by a rigid plus
isotropic scale (``--common_output``), whose voxels come out a little
larger than 1 mm, is refined by 2 in plane and 5 through plane (the
reference's ``ceil(ratio - 1e-4)``), with 9-tap Gaussian in-plane
profiles; at a scale of exactly 1 it is refined by 1 and 4, as in
``brainweb_sr3``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from unires_torch.geometry import affine_matrix_classic
from unires_torch.kernels import kernel_1d
from unires_torch.models.proj_op import proj_info
from unires_torch.ops import conv
from unires_torch.ops.cuda_build import volume_batch
from unires_torch.settings import Settings

COMMON = Path(__file__).resolve().parents[1] / "benchmark" / "configs" / \
    "brainweb_common.json"
COMMON_GRID = (192, 256, 192)  # the configuration's output grid at 1 mm

# (1D kernels per axis, ratio): brainweb_sr3's geometry with the thick axis
# on each axis, and brainweb_common's after the atlas alignment
GEOMETRIES = {
    "sr3_thick2": ((-1, -1, 0), (1, 1, 4)),
    "sr3_thick0": ((0, -1, -1), (4, 1, 1)),
    "common_thick1": ((2, 0, 2), (2, 5, 2)),
    "common_thick2": ((2, 2, 0), (2, 2, 5)),
}


def _kers(profiles, ratio):
    return tuple(kernel_1d(p, float(r)).astype(np.float32)
                 for p, r in zip(profiles, ratio))


def _vol(shape, seed):
    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    v.reshape(-1)[::11] = -0.0
    return torch.from_numpy(v)


def _chain(dat, kers, ratio, one_d):
    lead = dat.dim() - 3
    for axis, (k, r) in enumerate(zip(kers, ratio)):
        dat = one_d(dat, k, r, lead + axis)
    return dat


@pytest.mark.parametrize("lead", [(), (2,)], ids=["one", "batch2"])
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_a_cpu_tensor_takes_the_plain_chain(geom, lead):
    """On the CPU both directions are the per-axis plain chain, bit for bit,
    leading axes riding along, and no blur kernel counts a launch."""
    kers, ratio = _kers(*GEOMETRIES[geom]), GEOMETRIES[geom][1]
    n_out = (4, 5, 3)
    dim_in = tuple((n - 1) * r + k.shape[0]
                   for n, r, k in zip(n_out, ratio, kers))
    u, v = _vol(lead + dim_in, 1), _vol(lead + n_out, 2)
    n0 = [f.launches for f in conv.BLURS]
    down = conv.blur_down_sep(u, kers, ratio)
    up = conv.blur_up_sep(v, kers, ratio)
    assert down.shape == lead + n_out and up.shape == lead + dim_in
    for got, want in ((down, _chain(u, kers, ratio, conv._down_1d)),
                      (up, _chain(v, kers, ratio, conv._up_1d))):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # adjoint: <A u, v> = <u, A^T v>
    lhs = float((down.double() * v.double()).sum())
    rhs = float((u.double() * up.double()).sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), abs(rhs))
    assert [f.launches for f in conv.BLURS] == n0


def test_the_batch_view_is_none_on_the_cpu_and_refuses_other_devices():
    """``volume_batch`` sends a CPU tensor to the plain version and refuses
    a device that has no kernel (only the CUDA kernels exist)."""
    assert volume_batch(torch.zeros(2, 3, 4, 5), 3, "blur") is None
    with pytest.raises(ValueError, match="no kernel for device"):
        volume_batch(torch.zeros(3, 4, 5, device="meta"), 3, "blur")
    with pytest.raises(ValueError, match="no kernel for device"):
        conv.blur_down_sep(torch.zeros(9, 9, 9, device="meta"),
                           _kers((2, 2, 0), (2, 2, 5)), (2, 2, 5))


def _aligned_obs(config, c, scale):
    """Observation ``c`` of ``config`` (dims, header) after an atlas
    alignment that undoes the configuration's displacement and scales by
    ``scale``: the header the program's ``init`` hands ``proj_info``."""
    acq = config["acquisition"]
    dim_gt = config["phantom"]["dim"]
    vx = [config["phantom"]["vx_mm"]] * 3
    vx[acq["thick_axes"][c]] = acq["slice_mm"]
    dim_x = [int(np.ceil(n / v)) for n, v in zip(dim_gt, vx)]
    mni = np.eye(4)
    mni[:3, 3] = acq["placement"]["mni_origin_mm"]
    disp = affine_matrix_classic(acq["placement"]["displacement"])
    header = disp @ mni @ np.diag(vx + [1.0])
    mat_a = disp @ np.diag([1.0 / scale] * 3 + [1.0])
    return dim_x, np.linalg.solve(mat_a, header)


@pytest.mark.parametrize("scale, want", [
    (1.0, [((1, 1, 4), (1, 1, 5), (181, 217, 185)),
           ((1, 4, 1), (1, 5, 1), (181, 221, 181)),
           ((4, 1, 1), (5, 1, 1), (185, 217, 181))]),
    (1.0002, [((2, 2, 5), (9, 9, 5), (369, 441, 230)),
              ((2, 5, 2), (9, 5, 9), (369, 275, 369)),
              ((5, 2, 2), (5, 9, 9), (230, 441, 369))]),
], ids=["scale1", "scale1.0002"])
def test_common_output_geometry_at_an_atlas_scale(scale, want):
    """Each ``brainweb_common`` observation's decimation ratio, taps per
    axis and upsampled grid on the 192x256x192 atlas grid: a scale of
    1.0002 (the cell's alignment reads ~1.001) refines by (2, 2, 5) with
    (9, 9, 5) taps; a scale of 1 by (1, 1, 4) with (1, 1, 5)."""
    config = json.loads(COMMON.read_text())
    sett = Settings()
    mat_y = np.eye(4)
    mat_y[:3, 3] = config["output_grid"]["bb_min_mm"]
    for c, (ratio, taps, dim_yx) in enumerate(want):
        dim_x, mat_x = _aligned_obs(config, c, scale)
        po = proj_info(COMMON_GRID, mat_y, dim_x, mat_x,
                       prof_ip=sett.profile_ip, prof_tp=sett.profile_tp,
                       gap=sett.gap)
        assert po.ratio == ratio
        assert tuple(k.shape[0] for k in po.smo_ker_1d) == taps
        assert tuple(po.dim_yx) == dim_yx
