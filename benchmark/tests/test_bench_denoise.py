"""The ``denoise3.subjects`` cell (UniRes' denoising method) on the CPU at a
tiny grid (``tiny_denoise.py``): the cell resolves by name, a sound run is
``correct``, the control and a solve that returns its initial guess fail."""
from harness import judge, main, spec
from tiny_denoise import SEED_TINY, tiny_denoise3


def run(cell, traced=False):
    return main.run_cell(cell["entry"]["name"], SEED_TINY, 0.5, traced,
                         device="cpu", cell=cell)


def test_the_cell_resolves_by_name():
    cell = spec.cell("denoise3.subjects")
    assert cell["entry"]["chips"] == 1
    cf = cell["config"]
    assert cf["name"] == "brainweb_denoise3" and cf["reduced"] == []
    assert cf["settings"]["vx"] == 0
    assert cf["acquisition"]["slice_mm"] == cf["phantom"]["vx_mm"]
    assert cf["acquisition"]["scaling"] == 0.0
    assert cf["limits"]["scale_err"] == 0 and cf["limits"]["unfinished"] == 0
    assert cell["traffic"]["name"] == "subjects"
    assert {m["name"] for m in cell["end_to_end"]} >= {
        "subject_s", "fit_s_per_iter", "init_s", "setup_s"}
    names = {m["name"] for m in cell["per_layer"]}
    assert {"fit.resample_launches_per_iter", "fit.stencil_launches_per_iter",
            "kernels.resample_roofline"} <= names
    assert "registration.atlas_s" not in names


def test_a_sound_tiny_run_is_correct():
    out = run(tiny_denoise3(), traced=True)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] == 1
    assert out["checks"]["scale_err"]["value"] == 0.0
    # the plain versions ran on the CPU: no kernel launched
    assert out["metrics"]["fit.resample_launches_per_iter"]["value"] == 0.0


def test_the_control_and_an_unchanged_solve_fail():
    import control

    cell = tiny_denoise3()
    limits = cell["config"]["limits"]
    rows = list(control.readings(cell, [SEED_TINY], "cpu",
                                 fault_names=["solve_unchanged"],
                                 fault_seeds=[SEED_TINY]))
    sound, unchanged = rows
    assert judge.verdict(sound["program"], limits)[0], sound
    assert not judge.verdict(sound["control"], limits)[0], sound
    assert unchanged["fault"] == "solve_unchanged"
    assert not judge.verdict(unchanged["program"], limits)[0], unchanged
