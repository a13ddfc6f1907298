"""What a cell is made of, found by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix. A configuration is the JSON file that its
entry names; a traffic mix is ``traffic/<mix>.json``; a per-layer metric is
``metrics/<metric>.py``, a module with ``read(record) -> float | None``.
Adding a cell takes new files and a ``workloads`` entry, no edit here.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict = None) -> dict:
    """The cell ``name``: its entry, configuration, traffic mix, and the
    end-to-end and per-layer metrics it reports."""
    bench = bench if bench is not None else load_benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    return dict(entry=entry, config=load_json(ROOT / conf["file"]),
                traffic=load_json(BENCH_DIR / "traffic"
                                  / f"{entry['traffic']}.json"),
                end_to_end=[m for m in bench["end_to_end"] if here(m)],
                per_layer=[m for m in bench["per_layer"] if here(m)])


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_reader(name: str):
    """``read`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks() -> dict:
    """Published peaks per device name (``peaks.json``)."""
    return load_json(BENCH_DIR / "peaks.json")
