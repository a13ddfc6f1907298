"""``correct`` at a tiny grid on the CPU: a sound run passes; the control
(the reference in float32 with TF32 operands in the program's place) and
each fault of ``harness/faults.py``, planted underneath the timed path,
fail.
The chip's look is skipped; the rest of a run is driven as ``run.py``
drives it."""
import pytest

from harness import faults, judge, main

SEED = 2 ** 31 + 12345


def run(cell, traced=False):
    return main.run_cell(cell["entry"]["name"], SEED, 0.5, traced,
                         device="cpu", cell=cell)


@pytest.fixture(scope="module")
def sound(tiny_cell):
    return run(tiny_cell("sr3.subjects"), traced=True)


def test_a_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert sound["failed"] == 0 and sound["attempted"] == 1


def test_the_last_line_keys(sound):
    assert list(sound)[:5] == ["correct", "attempted", "failed", "metrics",
                               "device"]
    assert list(sound)[-1] == "checks"
    assert set(sound["metrics"]) >= {"fit.n_iter", "fit.capture_s"} or \
        set(sound["metrics"]) >= {"fit.n_iter"}
    for v in sound["checks"].values():
        assert set(v) == {"value", "limit"}


def test_the_control_fails(tiny_cell):
    import control

    cell = tiny_cell("sr3.subjects")
    limits = cell["config"]["limits"]
    rows = list(control.readings(cell, [SEED, SEED + 1, SEED + 2], "cpu"))
    for row in rows:
        assert judge.verdict(row["program"], limits)[0], row
        assert not judge.verdict(row["control"], limits)[0], row


def planted(name, cell):
    with faults.FAULTS[name]():
        return run(cell)


def test_a_step_that_returns_its_state_unchanged_fails(tiny_cell):
    out = planted("solve_unchanged", tiny_cell("sr3.subjects"))
    assert not out["correct"], out["checks"]


def test_half_of_the_batch_left_out_fails(tiny_cell):
    out = planted("half_batch", tiny_cell("sr3.batch2"))
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


def test_an_answer_altered_where_it_is_produced_fails(tiny_cell):
    out = planted("answer_altered", tiny_cell("sr3.subjects"))
    assert not out["correct"], out["checks"]


# the skipped rigid and scaling steps are shown on the card (PERF.md): at
# 8 mm poses and scales are not determined well enough to tell
@pytest.mark.parametrize("name, cell", [
    ("push_volume_zeroed", "sr3.batch2"), ("atlas_skipped", "common.subjects")])
def test_a_skipped_step_of_the_fit_or_its_init_fails(tiny_cell, name, cell):
    out = planted(name, tiny_cell(cell))
    assert not out["correct"], out["checks"]


def test_the_common_grid_is_checked(tiny_cell):
    cell = tiny_cell("common.subjects")
    out = dict(dim_y=(192, 256, 192), mat_y=None)
    import numpy as np

    from reference.grid import common_grid

    mat, dim = common_grid(cell["config"]["output_grid"], np.ones(3))
    assert dim == (192, 256, 192)
    assert np.allclose(mat[:3, 3], [-96.0, -146.0, -78.0])
    out["mat_y"] = mat
    assert judge.grid_mismatches(out, cell["config"]) == 0
    out["mat_y"] = mat + 1e-3
    assert judge.grid_mismatches(out, cell["config"]) > 0


@pytest.mark.parametrize("name", ["sr3.subjects", "common.subjects"])
def test_the_pose_numbers_take_the_gauge_apart(tiny_cell, name):
    import numpy as np

    from harness import inputs
    from reference.forward import affine_matrix_classic

    cell = tiny_cell(name)
    cf = cell["config"]
    gts = inputs.ground_truths(cf, "cpu")
    subject = inputs.make_subject(cf, cell["traffic"], gts, SEED, 0, 0, "cpu")
    atlas = affine_matrix_classic([1.0, -2.0, 0.5, 0.01, 0.0, -0.02])
    coreg = [affine_matrix_classic([0.3 * i, 0.1, 0.0, 0.0, 0.01 * i, 0.0])
             for i in range(len(subject["obs"]))]
    # the fitted rigids that undo the registration transforms exactly
    exact = [o["pose"] @ np.linalg.inv(np.linalg.solve(
        atlas, np.linalg.solve(coreg[i], o["header"])))
        for i, o in enumerate(subject["obs"])]
    out = dict(mat_coreg=np.stack(coreg), mat_atlas=atlas, rigids=exact)
    nums = judge.pose_errors(subject, out, cf)
    assert nums["pose_mm"] < 1e-9 and nums["frame_mm"] < 1e-9
    shift = affine_matrix_classic([0.0, 3.0, 0.0, 0.0, 0.0, 0.0])
    out["rigids"] = [shift @ r for r in exact]
    nums = judge.pose_errors(subject, out, cf)
    assert nums["pose_mm"] < 1e-9 and abs(nums["frame_mm"] - 3.0) < 1e-9
    out["rigids"] = exact[:1] + [shift @ r for r in exact[1:]]
    assert judge.pose_errors(subject, out, cf)["pose_mm"] > 1.0
