"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic mix and per-layer readers by name."""
import json
import re

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_cells_find_their_files_by_name():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell["config"]["name"] == w["config"]
        assert cell["traffic"]["name"] == w["traffic"]
        assert int(cell["traffic"]["subjects_per_unit"]) >= 1
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
        assert cell["per_layer"], w["name"]
        for m in cell["per_layer"]:
            assert callable(spec.metric_reader(m["name"]))


def test_names_units_and_configs():
    bench = spec.load_benchmark()
    names = ([c["name"] for c in bench["configs"]]
             + [w["name"] for w in bench["workloads"]]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(m["moves"] in e2e for m in bench["per_layer"])
    assert len(layers) <= len(bench["per_layer"])
    for c in bench["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert conf["reduced"] == c["reduced"]
        assert set(conf["limits"]) >= {"data_rel", "prior_rel", "unfinished"}
    assert all(0 < m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_metric_readers_leave_out_what_they_cannot_read():
    record = dict(units=[dict(B=1, init_s=1.0, fit_s=2.0, n_iter=[10])],
                  spans={}, profile=None, pairs=[], config={},
                  device_kind="cpu", peaks={})
    for m in spec.load_benchmark()["per_layer"]:
        got = spec.metric_reader(m["name"])(record)
        if m["name"] == "fit.n_iter":
            assert got == 10
        else:
            assert got is None, m["name"]
