"""Profile steady iterations of the misaligned bench fit on one CUDA card.

    python3 scripts/cuda_profile_fit.py [--first 5] [--count 3] [--uncaptured]

Builds the bench.py workload as ``chip_smoke.py`` phase 5 does (3 channels,
181x217x181, 4 mm slices, rigid misalignment, even/odd scaling; coreg,
unified rigid and scaling on), runs init, then the fit's stepper
(``pipeline.fit.FitRun``): one chunk of ``first`` iterations (its warm-up
and the graph's capture included), then a chunk of ``count`` iterations
with ``torch.profiler`` (CPU and CUDA activities) around it, its one read of
the host included. ``--uncaptured`` runs the chunk without a graph, each
decision read on the host. Prints the window's wall time, the device's busy
time (union of the device events' intervals), its idle share, host syncs
per iteration, and the device time by kernel group, with launches and ms
per launch for the port's three kernels.
"""
import argparse
import importlib
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
import unires_torch  # noqa: E402
from unires_torch.utils.host import to_host  # noqa: E402

# the module, not the function that unires_torch.pipeline exports as ``fit``
fit_mod = importlib.import_module("unires_torch.pipeline.fit")

# kernel name fragment -> group, first match wins
GROUPS = (("push_kernel", "push kernel"),
          ("pull_grad_kernel", "pull_grad kernel"), ("pull_kernel", "pull kernel"),
          ("CatArrayBatchedCopy", "torch.cat"), ("gemm", "matmuls"),
          ("reduce", "reductions"), ("Reduce", "reductions"),
          ("copy", "copies"), ("Memcpy", "copies"), ("Memset", "copies"))


def group_of(name):
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other elementwise"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--first", type=int, default=5)
    ap.add_argument("--count", type=int, default=3)
    ap.add_argument("--uncaptured", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the profile needs a GPU")
    print(f"[profile] {chip_smoke.phase_device()} | "
          f"{'uncaptured' if args.uncaptured else 'captured'}")
    _, _, chans = chip_smoke._bench_workload("cuda", chip_smoke.DIM_Y, True)
    x, y, sett = unires_torch.init(chans, unires_torch.Settings(
        device="cuda", vx=1.0, do_print=0, write_out=False, tolerance=0,
        max_iter=args.first + args.count, sched_num=3, reg_scl=4.0,
        do_coreg=True, unified_rigid=True, scaling=True))

    run = fit_mod.FitRun(x, y, sett, capture=not args.uncaptured)
    run.step(args.first)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    torch.cuda.synchronize()
    prof.start()  # the window excludes start/stop
    window.update(t0=time.perf_counter(), s0=to_host.syncs)
    rows = run.step(args.count)
    torch.cuda.synchronize()
    window.update(t1=time.perf_counter(), s1=to_host.syncs)
    prof.stop()
    if len(rows) != args.count:
        raise RuntimeError(f"the profiled chunk ran {len(rows)} iterations")

    wall = 1e3 * (window["t1"] - window["t0"])
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    by_group, launches = defaultdict(float), defaultdict(int)
    for e in dev:
        g = group_of(e.name)
        by_group[g] += (e.time_range.end - e.time_range.start) / 1e3
        launches[g] += 1
    total = sum(by_group.values())
    print(f"[profile] iterations {args.first}..{args.first + args.count - 1}: "
          f"wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}, {len(dev)} device events, host syncs/iter "
          f"{(window['s1'] - window['s0']) / args.count:.1f}")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {g}: {100 * ms / total:.2f} % of device time, "
              f"{ms:.3f} ms, {launches[g]} launches, "
              f"{ms / launches[g]:.4f} ms each")


if __name__ == "__main__":
    main()
