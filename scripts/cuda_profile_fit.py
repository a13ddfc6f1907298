"""Profile steady iterations of the misaligned bench fit on one CUDA card.

    python3 scripts/cuda_profile_fit.py [--first 5] [--count 3] [--uncaptured]
                                        [--batch B]

Builds the bench.py workload as ``chip_smoke.py`` phase 5 does (3 channels,
181x217x181, 4 mm slices, rigid misalignment, even/odd scaling; coreg,
unified rigid and scaling on), runs init, then the fit's stepper
(``pipeline.fit.FitStepper``, as ``FitRun``): one chunk of ``first``
iterations (its warm-up and the graph's capture included), then a chunk of
``count`` iterations with ``torch.profiler`` (CPU and CUDA activities)
around it, its one read of the host included. ``--uncaptured`` runs the
chunk without a graph, each decision read on the host. Prints the window's
wall time, the device's busy time (union of the device events' intervals),
its idle share, host syncs per iteration, and the device time by kernel
group, with launches and ms per launch for the port's three kernels.
``--batch B`` profiles B subjects (the workload at seeds 0 to B - 1, all on
subject 0's grid) as one stacked chunk (the stepper as
``parallel.fit_batch.BatchRun``), as ``fit_batch`` runs a device's share,
and also prints the graph's node count.
"""
import argparse
import importlib
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
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
GROUPS = (("push_kernel", "push kernel"), ("push_batch_kernel", "push kernel"),
          ("pull_grad_kernel", "pull_grad kernel"),
          ("pull_grad_batch_kernel", "pull_grad kernel"),
          ("pull_kernel", "pull kernel"), ("pull_batch_kernel", "pull kernel"),
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
    ap.add_argument("--batch", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the profile needs a GPU")
    print(f"[profile] {chip_smoke.phase_device()} | "
          f"{'uncaptured' if args.uncaptured else 'captured'}"
          f"{f' | batch of {args.batch}' if args.batch else ''}")
    n_iter = args.first + args.count
    inits = []
    for seed in range(max(args.batch, 1)):
        force = (None if not inits else
                 (inits[0][1][0].mat, inits[0][1][0].dim))
        inits.append(chip_smoke._bench_init("cuda", chip_smoke.DIM_Y,
                                            n_iter, seed=seed,
                                            force_y_space=force))
    cap = {}
    chip_smoke._timed_captures(cap)
    if args.batch:
        from unires_torch.parallel.fit_batch import BatchRun

        xs, ys, setts = (list(t) for t in zip(*inits))
        run = BatchRun(xs, ys, setts[0], capture=not args.uncaptured)
    else:
        run = fit_mod.FitRun(*inits[0], capture=not args.uncaptured)
    run.step(args.first)
    if cap:
        print(f"[profile] warm-up + capture {cap['s']:.3f} s, graph nodes "
              f"{cap['nodes']}")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    window = {}
    torch.cuda.synchronize()
    prof.start()  # the window excludes start/stop
    window.update(t0=time.perf_counter(), s0=to_host.syncs)
    n0 = run.state.host["n_iter"]
    run.step(args.count)
    torch.cuda.synchronize()
    window.update(t1=time.perf_counter(), s1=to_host.syncs)
    prof.stop()
    done = np.min(np.asarray(run.state.host["n_iter"]) - n0)
    if done != args.count:
        raise RuntimeError(f"the profiled chunk ran {done} iterations")

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
