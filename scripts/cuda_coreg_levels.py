"""Time the NMI registration levels of a checkout of this repository on one
card: co-registration of the bench workload and atlas alignment.

    python3 scripts/cuda_coreg_levels.py [--tree PATH] [--label NAME]
                                         [--profile]

Loads ``--tree``'s own ``chip_smoke.py`` (default: this checkout), which
binds that tree's ``unires_torch``, so that two commits (for example an
unpacked ``git archive`` of the parent) are timed in one call. Builds
``chip_smoke.py`` phase 5's workload (3 channels, 181x217x181, 4 mm slices,
rigid misalignment, seed 0) and runs ``unires_torch.init`` with
co-registration (and nothing else that registers), then atlas alignment
(CSO, the bundled template) of channel 0 with its header placed in the atlas
frame and displaced as in phase 6. Every call of the tree's
``pipeline.registration._opt_level`` (one per level and mover in a tree
that runs the movers one after another, one per level where they run
together) is timed between two synchronisations, with its pull_grad
launches (one per NMI evaluation), its host syncs and, where the tree
keeps them, the level's own figures (its ``registration.level`` span in
``unires_torch.utils.trace``, or in an older tree ``_opt_level``'s second
return value); the calls of one level are summed. ``--profile`` runs both again with ``torch.profiler`` around
each call and prints the device's busy time (the union of its events'
intervals) against that call's unprofiled wall time.
"""
import argparse
import importlib.util
import sys
import time
from collections import OrderedDict
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _busy_ms(prof):
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return 0.0, 0
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / 1e3, len(spans)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="this")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # binds the tree's unires_torch

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import unires_torch
    from unires_torch.ops.resample import pull_grad
    from unires_torch.pipeline import registration as reg
    from unires_torch.utils.host import to_host
    try:
        from unires_torch.utils import trace
    except ImportError:  # a tree without the recorder
        trace = None

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the timing needs a GPU")
    tag = f"[levels {args.label}]"
    print(f"{tag} {cs.phase_device()} | unires_torch from "
          f"{Path(unires_torch.__file__).parents[1]}")
    _, _, chans = cs._bench_workload("cuda", cs.DIM_Y, misaligned=True)
    opt_level = reg._opt_level
    calls = []
    mode = {"profile": False}
    walls = {}  # (name, grid) -> the unprofiled pass's wall seconds

    def timed(fd, *a, **kw):
        torch.cuda.synchronize()
        since = trace.serial() if trace is not None else None
        n0, s0, t0 = pull_grad.launches, to_host.syncs, time.perf_counter()
        prof = None
        if mode["profile"]:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        out = opt_level(fd, *a, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        calls.append(dict(grid=tuple(fd.shape), s=t,
                          evals=pull_grad.launches - n0,
                          syncs=to_host.syncs - s0,
                          busy=_busy_ms(prof) if prof is not None else None,
                          stats=_figures(out, since)))
        return out

    def _figures(out, since):
        """The level's own figures, with its warm-up + capture seconds."""
        if isinstance(out, tuple):
            return out[1]
        if since is None:
            return None
        spans = trace.spans(since=since)
        lv = next(s for s in spans if s.name == "registration.level")
        cap = [s.s for s in spans if s.parent == lv.serial
               and s.name == "registration.level.capture"]
        return dict(lv.attrs, setup_s=sum(cap))

    reg._opt_level = timed

    def levels(name):
        """The recorded calls grouped by level (grid), in order."""
        out = OrderedDict()
        for c in calls:
            lv = out.setdefault(c["grid"], dict(s=0.0, evals=[], syncs=0,
                                                busy=0.0, events=0))
            lv["s"] += c["s"]
            lv["syncs"] += c["syncs"]
            if c["busy"] is not None:
                lv["busy"] += c["busy"][0]
                lv["events"] += c["busy"][1]
            lv["evals"].append(c["evals"])
            rec = c["stats"]
            if rec is not None:  # the level's own figures (batched movers)
                lv.update(evals=rec["evals"], turns=rec["turns"],
                          nodes=rec["nodes"], setup_s=rec["setup_s"])
        total = sum(lv["s"] for lv in out.values())
        pas = "profiled" if mode["profile"] else "timed"
        for grid, lv in out.items():
            extra = (f" | WHILE turns {lv['turns']}, warm-up + capture "
                     f"{lv['setup_s']:.3f} s, {lv['nodes']} nodes"
                     if "turns" in lv else "")
            if mode["profile"]:
                wall = walls[(name, grid)]
                extra += (f" | device busy {lv['busy']:.1f} ms against the "
                          f"timed pass's {1e3 * wall:.1f} ms wall (busy "
                          f"share {lv['busy'] / (1e3 * wall):.3f}; "
                          f"{lv['events']} device events)")
            else:
                walls[(name, grid)] = lv["s"]
            print(f"{tag} {pas} {name} grid {grid}: {lv['s']:.3f} s | "
                  f"evaluations per mover {lv['evals']} | host syncs "
                  f"{lv['syncs']}{extra}")
        print(f"{tag} {pas} {name} total {total:.3f} s over {len(out)} "
              f"levels")
        calls.clear()

    def coreg():
        x, y, sett = unires_torch.init(
            [[c[0], c[1]] for c in chans], unires_torch.Settings(
                device="cuda", vx=1.0, do_print=0, write_out=False,
                max_iter=1, do_coreg=True, unified_rigid=True, scaling=True))
        levels("coreg")
        return x

    def atlas(x):
        o = x[0][0]
        mat = cs.T_SYNTH @ cs.MAT_MNI @ np.asarray(o.mat, np.float64)
        reg.atlas_align((o.dat, mat), rigid=False)
        levels("atlas CSO")

    for profiled in (False, True) if args.profile else (False,):
        mode["profile"] = profiled
        atlas(coreg())


if __name__ == "__main__":
    main()
