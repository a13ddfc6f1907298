"""The benchmark's own tests: the harness on the CPU at a tiny grid, and one
run on a CUDA card (marker ``gpu``, skipped without one)::

    python -m pytest benchmark/tests -q
"""
import copy
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE.parents[1])]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")


# the fit's thousands of small operations per iteration run fastest on one
# thread at this size
torch.set_num_threads(1)


# Limits of the tiny cells, from their readings on the CPU (seed 2**31 +
# 12345 and the two after it). At 8 mm the recon has more voxels than the
# data and poses and scales are barely determined: sound runs read
# recon_rel 0.432 to 0.440 (brainweb_sr3) and 0.567 (brainweb_common),
# pose_mm 4.0 to 6.3 and 9.8, frame_mm 0.10 to 0.22 and 11.5, scale_err
# 0.087 to 0.089, data_rel up to 4.5e-6, prior_rel up to 3.1e-8; the
# faults: a solve that returns its initial guess recon_rel 0.467 to 0.469,
# atlas alignment skipped 0.648 to 0.675 and frame_mm 16.6 to 16.7; the
# TF32 control data_rel 7.7e-5 to 5.2e-4, prior_rel 8.4e-7 to 6.7e-6. The
# poses and scales are held loosely here; the skipped rigid and scaling
# steps are shown to fail on the card (PERF.md).
TINY_LIMITS = {
    "brainweb_sr3": dict(recon_rel=0.452, scale_err=0.2, data_rel=2e-5,
                         prior_rel=2e-7),
    "brainweb_common": dict(recon_rel=0.61, pose_mm=20.0, frame_mm=14.0,
                            scale_err=0.2, data_rel=2e-5, prior_rel=2e-7),
}


def tiny(cell):
    """A copy of ``cell`` at 8 mm: the whole head in 23 x 28 x 23 voxels,
    32 mm slices, coreg finishing at 8 mm, one lambda and a gain tolerance
    of 5e-2 (the fit stops at its least, 27 iterations), at most 60; the
    limits of ``TINY_LIMITS``."""
    cell = copy.deepcopy(cell)
    cf = cell["config"]
    cf["phantom"].update(vx_mm=8.0, dim=[23, 28, 23])
    cf["acquisition"]["slice_mm"] = 32.0
    cf["settings"].update(vx=8.0, sched_num=0, tolerance=5e-2, max_iter=60,
                          coreg_params=dict(cost_fun="nmi", group="SE",
                                            samp=8, fwhm=7.0,
                                            mean_space=False))
    cf["limits"].update(TINY_LIMITS[cf["name"]])
    return cell


@pytest.fixture(scope="session")
def tiny_cell():
    from harness import spec

    return lambda name: tiny(spec.cell(name))
