"""Whether what the timed path produced is correct.

Each fitted subject is judged twice. Against the truth that made its
inputs: the recon volumes against the phantom's contrasts on the output
grid, each observation's fitted pose (the program's registration
transforms composed with its fitted rigid) against the drawn one, the
recon's frame against the truth's (for an atlas-aligned output, the atlas
transform against the known displacement), the even / odd scales against
the drawn one. And against the plain reference at the program's own
answer: the reference works out again, from the inputs, the noise
precisions tau and the prior weights lambda (``reference/hyperpar.py``)
and, from the inputs' headers and the program's outputs, each
observation's geometry; then it evaluates the fit's objective at the
program's recon volumes in float64 (``reference/forward.py``), which the
program reports for its last iteration. The numbers compared, each the
largest over the window's subjects (counts: summed):

``recon_rel``
    the largest over channels of |y - truth| / |truth| over the truth's
    support on the output grid.
``pose_mm``
    the largest displacement, over the truth's box, of an observation's
    fitted map into the output frame against its true one, once the
    subject's common part (the gauge, ``frame_mm``) is taken out.
``frame_mm``
    the largest displacement, over the truth's box, of that common part:
    the mean (in the Lie algebra) of the observations' pose errors.
``scale_err``
    the largest gap of a fitted even / odd scale from the drawn one.
``data_rel``, ``prior_rel``
    the relative gap between the program's data term (prior term) and the
    reference's at the program's answer.
``unfinished``
    subjects without a converged fit (no objective row, ``max_iter``
    reached, or a volume that is not finite): an exact comparison.
``grid``
    where the configuration states the output grid (``output_grid``): its
    dims and voxel-to-world affine entries that differ from the reference's
    (beyond 1e-6 mm of rounding): an exact comparison.

The control puts the reference, computed in float32 with TF32 operands in
its matrix products (rounded as a tensor core reads them, so the CPU gives
the card's), in the program's place (:func:`control_readings`).
"""
from __future__ import annotations

import itertools
import math

import numpy as np
import scipy.linalg
import torch

from harness.inputs import output_frame, truth_on_grid
from reference.forward import obs_geometry, objective, voxel_size
from reference.grid import common_grid
from reference.hyperpar import weights

COUNTS = ("unfinished", "grid")  # summed over subjects; the rest: largest


def subject_weights(subject, config):
    """(tau per observation, lambda per channel) of a subject's inputs."""
    if "weights" not in subject:
        chans = [[] for _ in config["contrasts"]]
        for o, (x, _) in zip(subject["obs"], subject["inputs"]):
            chans[o["c"]].append(x)
        subject["weights"] = weights(chans, config["settings"]["reg_scl"])
    return subject["weights"]


def _header(out, i, header):
    """Observation i's header moved by the program's registration
    transforms, as its fit sees it."""
    mat_x = np.asarray(header, np.float64)
    if out["mat_coreg"] is not None:
        mat_x = np.linalg.solve(out["mat_coreg"][i], mat_x)
    if out["mat_atlas"] is not None:
        mat_x = np.linalg.solve(out["mat_atlas"], mat_x)
    return mat_x


def _obs(subject, out, config):
    """The reference's observations of one subject, at the program's
    answer: the moved header, the geometry worked out again, the program's
    pose and scale, tau as the fit holds it (float32)."""
    acq = config["acquisition"]
    taus, _ = subject_weights(subject, config)
    obs = []
    for i, o in enumerate(subject["obs"]):
        geom = obs_geometry(out["dim_y"], out["mat_y"], tuple(o["x"].shape),
                            _header(out, i, o["header"]), acq["profile_ip"],
                            acq["profile_tp"])
        obs.append(dict(c=out["chan"][i], x=o["x"], geom=geom,
                        rigid=out["rigids"][i], scl=out["scls"][i],
                        tau=float(np.float32(taus[i]))))
    return obs


def reference_objective(subject, out, config, dtype=torch.float64,
                        tf32=False):
    """(data, prior) of the program's answer, computed in ``dtype``."""
    return objective(out["ys"], subject_weights(subject, config)[1],
                     out["mat_y"], _obs(subject, out, config), dtype, tf32)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-300)


def _finished(out):
    return (out["obj_last"] is not None and 0 < out["n_iter"] < out["max_iter"]
            and bool(torch.isfinite(out["ys"]).all())
            and all(math.isfinite(v) for v in out["obj_last"]))


def grid_mismatches(out, config) -> int:
    want = config.get("output_grid")
    if not want:
        return 0
    mat, dim = common_grid(want, voxel_size(out["mat_y"]))
    bad = sum(int(a != b) for a, b in zip(out["dim_y"], dim))
    return bad + int((np.abs(np.asarray(out["mat_y"]) - mat) > 1e-6).sum())


def recon_error(out, config, gts) -> float:
    """The largest over channels of |y - truth| / |truth| over the truth's
    support on the output grid, in float64."""
    frame = output_frame(config)
    worst = 0.0
    for c, contrast in enumerate(config["contrasts"]):
        t = truth_on_grid(gts[contrast], frame, out["mat_y"], out["dim_y"])
        m = t > 0
        d = out["ys"][c].to(t.device, torch.float64)[m] - t[m]
        worst = max(worst, float(d.norm() / t[m].norm()))
        del t, m, d
    return worst


def _box(config) -> np.ndarray:
    """The corners of the truth's volume in the output frame, (8, 4)."""
    n = config["phantom"]["dim"]
    vox = np.array([[i, j, k, 1.0] for i, j, k in itertools.product(
        (0, n[0] - 1), (0, n[1] - 1), (0, n[2] - 1))])
    return vox @ output_frame(config).T


def _moves(T, box) -> float:
    """The largest displacement (mm) of the box's corners under ``T``."""
    return float(np.linalg.norm((box @ T.T - box)[:, :3], axis=1).max())


def pose_errors(subject, out, config) -> dict:
    """``pose_mm`` and ``frame_mm`` of one subject: each observation's
    error E_i = P_i T_i^-1, P_i the program's map of its voxels into the
    output frame (its rigid after its moved header), T_i the true one; the
    common part G, the mean of log E_i, is the frame's error, each
    E_i G^-1 an observation's own."""
    errs = [out["rigids"][i] @ _header(out, i, o["header"])
            @ np.linalg.inv(o["pose"]) for i, o in enumerate(subject["obs"])]
    G = np.real(scipy.linalg.expm(np.mean(
        [np.real(scipy.linalg.logm(E)) for E in errs], axis=0)))
    box = _box(config)
    return dict(pose_mm=max(_moves(E @ np.linalg.inv(G), box) for E in errs),
                frame_mm=_moves(G, box))


def subject_numbers(subject, out, config, gts, ref=None) -> dict:
    """The numbers of one subject (an unfinished one has only
    ``unfinished``); ``ref``: its reference objective, computed here when
    None."""
    if not _finished(out):
        return {"unfinished": 1}
    ref = ref if ref is not None else reference_objective(subject, out,
                                                          config)
    nums = dict(recon_rel=recon_error(out, config, gts),
                **pose_errors(subject, out, config),
                scale_err=max(abs(s - config["acquisition"]["scaling"])
                              for s in out["scls"]),
                data_rel=_rel(out["obj_last"][1], ref[0]),
                prior_rel=_rel(out["obj_last"][2], ref[1]), unfinished=0)
    if config.get("output_grid"):
        nums["grid"] = grid_mismatches(out, config)
    return nums


def combine(per, limits) -> dict:
    """The numbers of the limits' keys over subjects' numbers ``per``."""
    nums = {}
    for k in limits:
        vals = [p[k] for p in per if k in p]
        nums[k] = sum(vals) if k in COUNTS else max(vals, default=math.inf)
    return nums


def readings(pairs, config, gts, refs=None):
    """(numbers compared, subjects failed) over (subject, output)
    ``pairs``; ``refs``: the reference objectives (computed here when
    None). A subject fails where its own numbers fail :func:`verdict`."""
    limits = config["limits"]
    per = [subject_numbers(s, o, config, gts,
                           None if refs is None else refs[k])
           for k, (s, o) in enumerate(pairs)]
    failed = sum(not verdict(p, limits)[0] for p in per)
    return combine(per, limits), failed, per


def control_readings(pairs, config, refs=None):
    """``data_rel`` and ``prior_rel`` with the reference in float32 and
    TF32 matrix products in the program's place, against the float64
    reference."""
    data, prior = [], []
    for k, (subject, out) in enumerate(pairs):
        ref = refs[k] if refs is not None else reference_objective(
            subject, out, config)
        low = reference_objective(subject, out, config, torch.float32, True)
        data.append(_rel(low[0], ref[0]))
        prior.append(_rel(low[1], ref[1]))
    return {"data_rel": max(data), "prior_rel": max(prior)}


def verdict(nums, limits):
    """(correct, checks): each number of ``nums`` that has a limit beside
    it (a subject's numbers that the configuration does not hold are only
    logged)."""
    checks = {k: {"value": nums[k], "limit": v} for k, v in limits.items()
              if k in nums}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
