"""The per-layer readers of the program's own spans
(``unires_torch.utils.trace``, read through ``harness/recorder.py``) on
tiny units on the CPU: each gives a number where the program's last
``run.unit`` spans match the record's units, and None where they do not."""
import copy

import pytest

from harness import inputs, main, program, spec

SEED = 2 ** 31 + 4242
READERS = ("init.self_s", "registration.capture_s", "registration.evals",
           "fit.fixed_s", "fit.chunk_ms_per_iter", "fit.host_syncs_per_iter")


def _record(units):
    return dict(units=units, spans={}, profile=None, pairs=[], config={},
                device_kind="cpu", peaks={})


@pytest.fixture(scope="module")
def batch_unit(tiny_cell):
    """One tiny two-subject unit as the window runs it: its record's
    units."""
    cell = tiny_cell("sr3.batch2")
    config = cell["config"]
    gts = inputs.ground_truths(config, "cpu")
    subjects = inputs.unit_subjects(config, cell["traffic"], gts, SEED, 0,
                                    "cpu")
    t_init, t_fit, outs = program.run_unit(config, subjects, "cpu")
    return [dict(B=len(subjects), init_s=t_init, fit_s=t_fit,
                 n_iter=[o["n_iter"] for o in outs])]


def test_the_readers_are_in_the_benchmark():
    names = {m["name"] for m in spec.load_benchmark()["per_layer"]}
    assert names >= set(READERS)


@pytest.mark.parametrize("name", READERS)
def test_a_matching_unit_gives_a_number(batch_unit, name):
    v = spec.metric_reader(name)(_record(batch_unit))
    assert isinstance(v, float) and v >= 0.0, v
    if name in ("registration.evals", "fit.host_syncs_per_iter",
                "fit.chunk_ms_per_iter"):
        assert v > 0.0


@pytest.mark.parametrize("change", ["B", "n_iter", "seconds", "more_units"])
def test_a_unit_that_does_not_match_gives_none(batch_unit, change):
    units = copy.deepcopy(batch_unit)
    u = units[0]
    if change == "B":
        u["B"] = 1
    elif change == "n_iter":
        u["n_iter"][1] += 1
    elif change == "seconds":
        u["init_s"] += 0.1 * (u["init_s"] + u["fit_s"])
    else:  # more units in the window than the program ran
        units = units * 1000
    for name in READERS:
        assert spec.metric_reader(name)(_record(units)) is None, name


def test_the_counts_agree_with_the_record(batch_unit):
    """The unit's ``fit`` span holds the record's ``n_iter``, and the host
    reads per iteration are that span's ``syncs`` over them."""
    from unires_torch.utils import trace

    run = trace.spans("run.unit")[-1]
    fit = next(s for s in trace.spans("fit") if s.parent == run.serial)
    assert fit.attrs["n_iter"] == batch_unit[0]["n_iter"]
    syncs = spec.metric_reader("fit.host_syncs_per_iter")(_record(batch_unit))
    assert syncs == fit.attrs["syncs"] / sum(batch_unit[0]["n_iter"])


def test_a_traced_run_reports_the_readers(tiny_cell):
    out = main.run_cell("sr3.subjects", SEED, 0.5, True, device="cpu",
                        cell=tiny_cell("sr3.subjects"))
    assert out["correct"], out["checks"]
    for name in READERS:
        assert isinstance(out["metrics"][name]["value"], float), name
