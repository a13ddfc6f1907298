"""A CT configuration that is not a cell, for the CPU tests of the harness
(``test_bench_ct.py``, ``test_bench_roofline.py``): ``tiny_ct.json``, one
channel of Hounsfield units (air -1000) observed at 4 x 4 x 16 mm, finer
in-plane than the 8 mm recon grid, over a field of view wider than the
truth's grid, fitted with ``settings.ct``. The harness takes it as it takes
a cell, by name from ``BENCHMARK.json``'s entries, here a copy with one
configuration and one workload added: new files alone, no code of its own.
"""
from harness import spec

SEED_CT = 2 ** 31 + 12345


def tiny_ct():
    """The cell ``ct.subjects`` of ``tiny_ct.json`` under the ``subjects``
    traffic, as :func:`harness.spec.cell` resolves it."""
    bench = spec.load_benchmark()
    bench["configs"].append(dict(name="tiny_ct",
                                 file="benchmark/tests/tiny_ct.json"))
    bench["workloads"].append(dict(name="ct.subjects", config="tiny_ct",
                                   traffic="subjects", chips=1))
    return spec.cell("ct.subjects", bench)
