"""The cell's inputs, made from the seed by the benchmark's own plain code.

The ground truths are the phantom's contrasts (``reference/phantom.py``),
one anatomy for every subject. Each subject is a set of thick-slice
observations of them, one per channel, made by the plain forward model
(``reference/forward.py``): each channel's thick axis, its rigid pose
(uniform in +-``rigid_mm`` / +-``rigid_rad``, the channels' poses then
moved to a zero Lie mean), the even / odd scaling, and Gaussian noise. A
subject's noise comes from ``SeedSequence([seed, unit, subject])``, so the
same seed gives the same subjects and every seed the same sizes; its poses
from ``SeedSequence([pose_seed, unit, subject])`` of the traffic mix: the
k-th subject of every run has the same misalignment, so that the
registration's work, which follows from it, is the same for every seed.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.linalg
import torch

from reference.forward import (affine_matrix_classic, obs_geometry, project,
                               pull)
from reference.phantom import brain_phantom

WARM_UP_UNIT = 2 ** 20  # the unit index of the warm-up's subjects


def ground_truths(config, device):
    """{contrast: volume} on ``device``."""
    ph = config["phantom"]
    return brain_phantom(ph["dim"], ph["vx_mm"], config["contrasts"],
                         ph["amplitude"], ph["seed"], ph["texture"], device)


def _placement(config, displaced):
    """Where the truths' voxel origin lies: the identity (a scanner frame at
    the grid's corner), or with a ``placement`` the MNI origin of the atlas
    frame, ``displaced`` by its known rigid transform or not."""
    pl = config["acquisition"].get("placement")
    if not pl:
        return np.eye(4)
    mni = np.eye(4)
    mni[:3, 3] = pl["mni_origin_mm"]
    return (affine_matrix_classic(pl["displacement"]) @ mni if displaced
            else mni)


def output_frame(config):
    """The truths' voxel-to-world affine in the frame the program
    reconstructs in: its scanner frame, or for an atlas-aligned output the
    atlas frame, where the phantom sits at its MNI placement."""
    vx = config["phantom"]["vx_mm"]
    return _placement(config, False) @ np.diag([vx, vx, vx, 1.0])


def draw_rigids(rng, n, mm, rad):
    """n world rigid transforms of the truth's voxel frame, uniform in
    +-mm / +-rad, moved so that their matrix logarithms average zero."""
    logs = [np.real(scipy.linalg.logm(affine_matrix_classic(
        np.r_[rng.uniform(-mm, mm, 3), rng.uniform(-rad, rad, 3)])))
        for _ in range(n)]
    mean = np.mean(logs, axis=0)
    return [np.real(scipy.linalg.expm(lg - mean)) for lg in logs]


def _rng(seed, unit, subject):
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % 2 ** 64, unit, subject]))


def make_subject(config, traffic, gts, seed, unit, subject, device):
    """One subject: ``inputs`` (per channel [float32 array, world affine],
    as a user hands them to the program) and ``obs`` (the same data on the
    device with each channel's index, header and ``pose``: the true map of
    its voxels into the output frame)."""
    acq = config["acquisition"]
    C = len(config["contrasts"])
    rigids = draw_rigids(_rng(traffic["pose_seed"], unit, subject), C,
                         acq["rigid_mm"], acq["rigid_rad"])
    rng = _rng(seed, unit, subject)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 63)))
    world = _placement(config, True)
    frame = _placement(config, False)
    vx_gt = config["phantom"]["vx_mm"]
    inputs, obs = [], []
    for c, contrast in enumerate(config["contrasts"]):
        gt = gts[contrast]
        vx = [vx_gt] * 3
        axis = acq["thick_axes"][c]
        vx[axis] = acq["slice_mm"]
        dim_x = [int(math.ceil(n * vx_gt / v)) for n, v in zip(gt.shape, vx)]
        vox_x = np.diag(vx + [1.0])
        # made in the truth's voxel frame (the pose about its origin); the
        # header places the observation where the world puts the truth
        geom = obs_geometry(gt.shape, np.diag([vx_gt] * 3 + [1.0]), dim_x,
                            vox_x, acq["profile_ip"], acq["profile_tp"])
        clean = project(gt.to(torch.float64), np.diag([vx_gt] * 3 + [1.0]),
                        rigids[c], geom, acq["scaling"])
        noise = torch.randn(clean.shape, generator=gen, device=device,
                            dtype=torch.float32)
        # C order, as the program's kernels take a volume (it does not
        # reorder an input array of another layout)
        x = (clean.to(torch.float32) + float(acq["noise_sd"]) * noise
             ).contiguous()
        header = world @ vox_x
        inputs.append([x.cpu().numpy(), header])
        obs.append(dict(c=c, x=x, header=header,
                        pose=frame @ rigids[c] @ vox_x))
        del clean, noise
    return dict(inputs=inputs, obs=obs)


def unit_subjects(config, traffic, gts, seed, unit, device):
    """The subjects of unit ``unit`` of the traffic mix."""
    return [make_subject(config, traffic, gts, seed, unit, b, device)
            for b in range(int(traffic["subjects_per_unit"]))]


def truth_on_grid(gt, frame, mat_y, dim_y):
    """The truth (at voxel-to-world ``frame``) resampled onto a recon grid,
    in float64."""
    M = np.linalg.solve(frame, mat_y)
    return pull(gt.to(torch.float64), M, tuple(dim_y))

