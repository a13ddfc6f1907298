"""Run one cell of the benchmark of ``unires_torch`` once, on one CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cells, their configurations, traffic
mixes and metrics are named in ``BENCHMARK.json``. Prints what it does and
the numbers compared with their limits on standard error, and as the last
line of standard output one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``
of the profiled fit chunk, and last ``checks``. Exits non-zero, printing no
result, without CUDA, or if JAX or the JAX package was loaded.
"""
import time

T_BEGIN = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# kernel caches at fixed paths inside the checkout (the program builds its
# own library under build/unires_torch_kernels/)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(var, str(ROOT / "build" / "benchmark_cache" / sub))
os.environ.setdefault("USE_FLAX", "0")
sys.path[:0] = [str(HERE), str(ROOT)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from harness import spec

    cell = spec.cell(args.workload)
    chips = int(cell["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    from harness.main import check_line, forbidden_modules, run_cell

    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_begin=T_BEGIN)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"[bench] JAX was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    if args.trace:
        kind = result["device"]["kind"]
        print(f"[bench] card {kind}, power limit {power_limit()}",
              file=sys.stderr)
    for line in check_line(result["checks"]):
        print(f"[check] {line}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "not read"


if __name__ == "__main__":
    sys.exit(main())
