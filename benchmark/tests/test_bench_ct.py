"""A configuration that is not MR, through the harness from new files alone
(``tiny_ct.py``): truths and observations in Hounsfield units, the plain
reference's CT weights, and ``correct`` of the port's fit on the CPU.

The limits in ``tiny_ct.json`` come from its readings on the CPU (seeds
2**31 + 12345 and the two after it, one thread): sound runs read recon_rel
0.1708 to 0.1710, data_rel 8.7e-9 to 2.0e-8, prior_rel 1.2e-8 to 4.7e-8,
scale_err 0 (a single CT fits no scale); the control (the reference in
float32 with TF32 operands) data_rel 3.1e-5 to 9.7e-5, prior_rel 4.0e-6 to
1.1e-5; a y-solve that returns its initial guess recon_rel 0.2242 to
0.2244; the answer scaled by 1.001 where it is produced data_rel 1.25e-3 to
1.27e-3, prior_rel 9.1e-4. The fit zeroes the recon outside the field of
view after its last objective row (one observation: ``clean_fov``), here
1978 of 20010 voxels, so data_rel would read 0.98 at the returned answer:
the judge takes the fit's values there (``judge.fitted_volumes``), and
holds every voxel the clean changed to lie outside the field of view it
works out itself (``fov_cleaned``, 0; the clean zeroing a 4 x 4 x 4 block
inside it reads 64 and passes every other number). ``tissue_rel`` is not
held here: at 8 mm the recon does not resolve the brain's 30 HU of contrast
(sound runs read 13.80 to 13.81, the skull's partial volume through 16 mm
slices), so only its construction is tested.
"""
import math

import numpy as np
import pytest
import torch

from harness import inputs, judge, main, program
from reference.forward import pull, voxel_size
from reference.grid import super_resolution
from reference.hyperpar import noise_and_level
from reference.phantom import brain_classes
from tiny_ct import SEED_CT, tiny_ct


@pytest.fixture(scope="module")
def ct():
    cell = tiny_ct()
    cf = cell["config"]
    gts = inputs.ground_truths(cf, "cpu")
    subject = inputs.make_subject(cf, cell["traffic"], gts, SEED_CT, 0, 0,
                                  "cpu")
    return cell, gts, subject


def test_air_holds_its_value_inside_and_outside_the_truths_grid(ct):
    cell, gts, subject = ct
    cf = cell["config"]
    t = gts["ct"]
    air = cf["phantom"]["tissues"]["ct"][0]
    assert air == -1000.0 and inputs.backgrounds(cf) == {"ct": air}
    # every voxel is air exactly or tissue (scalp fat at -80 is the least),
    # not clamped to 0; the grid's faces but the lowest (the neck) are air
    assert bool(((t == air) | (t > -200.0)).all()) and float(t.max()) > 1000
    assert 0.3 < float((t == air).double().mean()) < 0.9
    for d, i in [(0, 0), (0, -1), (1, 0), (1, -1), (2, -1)]:
        assert bool((t.select(d, i % t.shape[d]) == air).all())
    # resampled for the judge onto a grid that overhangs the truth's
    frame = inputs.output_frame(cf)
    shift = np.eye(4)
    shift[:3, 3] = [-4.0, 2.5, 3.0]
    on = inputs.truth_on_grid(t, frame, frame @ shift, t.shape, air)
    assert bool((on[:4] == air).all()) and float(on.max()) > 1000.0
    # the observation's slab beyond the truth's grid reads air and noise
    x = subject["obs"][0]["x"]
    sd = cf["acquisition"]["noise_sd"]
    edge = x[:4]
    assert abs(float(edge.mean()) - air) < 5 * sd / math.sqrt(edge.numel())


def test_the_observation_has_its_stated_voxels_and_dims(ct):
    cell, _, subject = ct
    acq = cell["config"]["acquisition"]
    o = subject["obs"][0]
    assert tuple(o["x"].shape) == tuple(acq["dim"][0])
    assert np.allclose(voxel_size(o["header"]), acq["vx_mm"][0])
    assert subject["inputs"][0][0].shape == tuple(acq["dim"][0])
    # centred on the truth's grid (no placement: the truth's voxel frame)
    ph = cell["config"]["phantom"]
    centre = (np.asarray(o["x"].shape) - 1) / 2
    want = (np.asarray(ph["dim"]) - 1) / 2 * ph["vx_mm"]
    assert np.allclose((o["header"] @ np.r_[centre, 1.0])[:3], want)


def test_the_reference_weights_are_cts(ct):
    cell, _, subject = ct
    cf = cell["config"]
    x, header = subject["inputs"][0]
    assert super_resolution(cf["settings"]["vx"], [header])
    taus, lams = judge.subject_weights(subject, cf)
    sd, mu = noise_and_level(x, ct=True)
    # the background class is the air, below 0: its spread is the noise
    assert taus == [1.0 / sd ** 2]
    assert abs(sd / cf["acquisition"]["noise_sd"] - 1.0) < 0.15
    assert 950.0 < mu < 1100.0
    assert lams == [cf["settings"]["reg_scl"] * 1.0 / (mu / 4.0)]
    # the MR rule (negative voxels dropped) loses the air, and its level
    # is the gap of soft tissue and bone (454 against 993 here)
    assert noise_and_level(x, ct=False)[1] < 0.6 * mu


@pytest.fixture(scope="module")
def fitted(ct):
    cell, gts, subject = ct
    _, _, outs = program.run_unit(cell["config"], [subject], "cpu")
    return outs[0]


def _fov(subject, out, margin, monkeypatch):
    monkeypatch.setattr(judge, "FOV_MARGIN", margin)
    return judge.fov_inside(subject, out, 0, "cpu")


def test_the_fov_clean_is_held_to_the_judges_field_of_view(ct, fitted,
                                                          monkeypatch):
    cell, gts, subject = ct
    idx, vals = fitted["cleaned"][0]
    assert idx.numel() > 1000 and bool((vals != 0).all())
    assert judge.subject_numbers(subject, fitted, cell["config"],
                                 gts)["fov_cleaned"] == 0
    # the judge's field of view is the program's: every voxel outside it by
    # more than the margin was zeroed, and none inside it was changed
    strict = _fov(subject, fitted, 1e-2, monkeypatch).reshape(-1)
    loose = _fov(subject, fitted, -1e-2, monkeypatch).reshape(-1)
    y = fitted["ys"][0].reshape(-1)
    assert int((~loose).sum()) > 1000 and bool((y[~loose] == 0).all())
    assert not bool(strict[idx].any())


def test_the_judges_own_limit_holds_only_where_a_subject_reports_it():
    limits = {"recon_rel": 0.2}
    assert judge.combine([{"recon_rel": 0.1}], limits) == {"recon_rel": 0.1}
    assert judge.verdict({"recon_rel": 0.1}, limits)[1] == {
        "recon_rel": {"value": 0.1, "limit": 0.2}}
    per = [{"recon_rel": 0.1, "fov_cleaned": 0},
           {"recon_rel": 0.1, "fov_cleaned": 3}]
    nums = judge.combine(per, limits)
    assert nums == {"recon_rel": 0.1, "fov_cleaned": 3}
    ok, checks = judge.verdict(nums, limits)
    assert not ok and checks["fov_cleaned"] == {"value": 3, "limit": 0}


def test_tissue_rel_sees_the_soft_tissue_contrast(ct, fitted):
    cell, gts, subject = ct
    cf = cell["config"]
    ph = cf["phantom"]
    truth = inputs.truth_on_grid(gts["ct"], inputs.output_frame(cf),
                                 fitted["mat_y"], fitted["dim_y"], -1000.0)
    exact = dict(fitted, ys=truth[None].float(), cleaned=None)
    assert judge.tissue_error(subject, exact, cf, gts) < 1e-6
    # the brain flattened to its mean: recon_rel, over |t + 1000|, hardly
    # moves; tissue_rel reads at least 1
    brain = torch.isin(brain_classes(ph["dim"], ph["vx_mm"], ph["seed"],
                                     "cpu"), torch.tensor(judge.BRAIN))
    M = np.linalg.solve(inputs.output_frame(cf), fitted["mat_y"])
    m = pull(brain.double(), M, tuple(fitted["dim_y"])) > 1.0 - 1e-9
    assert int(m.sum()) > 100
    flat = truth.clone()
    flat[m] = truth[m].mean()
    flat = dict(exact, ys=flat[None].float())
    assert judge.tissue_error(subject, flat, cf, gts) > 0.99
    assert judge.recon_error(flat, cf, gts) < 0.02
    # MR contrasts have no table of their own: no number
    assert judge.tissue_error(subject, exact, dict(
        cf, phantom=dict(ph, tissues={})), gts) is None


def test_a_sound_run_is_correct():
    out = main.run_cell("ct.subjects", SEED_CT, 0.5, True, device="cpu",
                        cell=tiny_ct())
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 1
    assert out["checks"]["scale_err"]["value"] == 0.0
    assert out["checks"]["fov_cleaned"] == {"value": 0, "limit": 0}
    assert out["metrics"]["fit.n_iter"]["value"] > 0
    assert "kernels.resample_roofline" not in out["metrics"]  # no card


def test_the_control_and_the_faults_fail():
    import control

    cell = tiny_ct()
    limits = cell["config"]["limits"]
    names = ["answer_altered", "solve_unchanged", "fov_inside_zeroed"]
    rows = list(control.readings(cell, [SEED_CT], "cpu", fault_names=names,
                                 fault_seeds=[SEED_CT]))
    sound, altered, unchanged, inside = rows
    assert judge.verdict(sound["program"], limits)[0], sound
    assert not judge.verdict(sound["control"], limits)[0], sound
    assert [r["fault"] for r in rows[1:]] == names
    assert altered["program"]["data_rel"] > limits["data_rel"], altered
    assert unchanged["program"]["recon_rel"] > limits["recon_rel"], unchanged
    assert not judge.verdict(altered["program"], limits)[0]
    assert not judge.verdict(unchanged["program"], limits)[0]
    # zeroed inside the field of view: only the judge's own check sees it
    ok, checks = judge.verdict(inside["program"], limits)
    assert not ok and checks["fov_cleaned"]["value"] == 64, checks
    assert all(c["value"] <= c["limit"] for k, c in checks.items()
               if k != "fov_cleaned"), checks
