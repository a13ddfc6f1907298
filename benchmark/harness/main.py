"""One run of one cell: set-up, the measured window, the judge, the result.

Set-up imports the program, loads its kernel library (the first run in a
checkout builds it), makes the ground truths on the device and warms up
once at the cell's own shapes (one unit of the cell's traffic whose fits
stop after 2 iterations). The window then runs units back to back, a closed
loop as a pipeline over a cohort runs them: a unit starts while its
expected end, taken from the previous unit's duration, lies inside
``seconds``, and at least one unit runs. Every metric is taken over whole
units. After the window the peak memory is read, the program's state is
dropped and the reference judges every subject the window fitted.
"""
from __future__ import annotations

import gc
import sys
import time

import torch

from harness import inputs, judge, program, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "unires_tpu")


def forbidden_modules(names) -> list:
    """Names among ``names`` whose top-level module (before the first dot) is
    JAX, its libraries or the JAX package."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _window(config, traffic, gts, seed, seconds, device, profile=None):
    """Units back to back; returns (units, pairs, seconds): per unit its
    subjects, init and fit seconds and iterations; (subject, output) per
    subject; the window's length."""
    units, pairs = [], []
    t_start = time.perf_counter()
    last = 0.0
    while not units or time.perf_counter() - t_start + last <= seconds:
        subjects = inputs.unit_subjects(config, traffic, gts, seed,
                                        len(units), device)
        t_init, t_fit, outs = program.run_unit(config, subjects, device)
        last = t_init + t_fit
        units.append(dict(B=len(subjects), init_s=t_init, fit_s=t_fit,
                          n_iter=[o["n_iter"] for o in outs]))
        log(f"[bench] unit {len(units) - 1}: init {t_init:.3f} s, fit "
            f"{t_fit:.3f} s, n_iter {units[-1]['n_iter']}")
        pairs.extend(zip(subjects, outs))
        if profile is not None:
            profile.remove()
    return units, pairs, time.perf_counter() - t_start


def end_to_end(units, setup_s) -> dict:
    subjects = sum(u["B"] for u in units)
    iters = sum(sum(u["n_iter"]) for u in units)
    return {
        "subject_s": sum(u["init_s"] + u["fit_s"] for u in units) / subjects,
        "fit_s_per_iter": sum(u["fit_s"] for u in units) / max(iters, 1),
        "init_s": sum(u["init_s"] for u in units) / subjects,
        "setup_s": setup_s,
    }


def run_cell(name, seed, seconds, traced, device="cuda", t_begin=None,
             cell=None):
    """Run cell ``name`` once; returns the result's dict (the last line).
    ``t_begin``: when the process started (set-up counts from there);
    ``cell``: the cell as :func:`spec.cell` gives it (default: that)."""
    t_begin = time.perf_counter() if t_begin is None else t_begin
    c = cell if cell is not None else spec.cell(name)
    config, traffic = c["config"], c["traffic"]
    build_s = program.build_kernels(device)
    gts = inputs.ground_truths(config, device)
    warm = inputs.unit_subjects(config, traffic, gts, seed,
                                inputs.WARM_UP_UNIT, device)
    program.run_unit(config, warm, device, max_iter=2)
    del warm
    program.sync(device)
    setup_s = time.perf_counter() - t_begin
    log(f"[bench] {name}: set-up {setup_s:.3f} s (kernel build "
        f"{build_s:.3f} s)")

    spans = profile = None
    if traced:
        spans = program.Spans(device).install()
        profile = program.ChunkProfile(device).install()
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    units, pairs, window_s = _window(config, traffic, gts, seed, seconds,
                                     device, profile)
    if spans is not None:
        spans.remove()
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    prof = profile.result if profile is not None else None
    reduced = None
    if prof is not None:
        reduced = trace.reduce(prof.pop("prof"), prof["wall_s"])
        reduced.update(prof)
        log(f"[bench] profiled chunk: {prof['iters']} subject-iterations, "
            f"kernel events in the trace {reduced['kernels']}, "
            f"{reduced['events']} device events")
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    # the reference, after the window, on the window's subjects
    t0 = time.perf_counter()
    nums, failed, per = judge.readings(pairs, config, gts)
    correct, checks = judge.verdict(nums, config["limits"])
    for k, (p, (_, out)) in enumerate(zip(per, pairs)):
        log(f"[bench] subject {k}: n_iter {out['n_iter']}, {p}")
    log(f"[bench] reference {time.perf_counter() - t0:.3f} s")

    record = dict(units=units, spans=spans.s if spans is not None else {},
                  profile=reduced, pairs=pairs, config=config,
                  device_kind=device_kind(device), peaks=spec.peaks())
    if traced:
        metrics = {}
        for m in c["per_layer"]:
            v = spec.metric_reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = end_to_end(units, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in c["end_to_end"]}
    attempted = sum(u["B"] for u in units)
    dev = dict(platform="gpu" if device != "cpu" else "cpu",
               kind=device_kind(device), count=1, memory_peak_bytes=int(peak))
    if traced and reduced is not None:
        dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
    result = dict(correct=bool(correct), attempted=attempted,
                  failed=failed, metrics=metrics,
                  device=dev)
    if traced and reduced is not None:
        result["breakdown"] = dict(device_ops=reduced["device_ops"],
                                   idle_gaps=reduced["idle_gaps"])
    result["checks"] = checks
    log(f"[bench] window {window_s:.3f} s, {len(units)} units, "
        f"{attempted} subjects, n_iter "
        f"{[n for u in units for n in u['n_iter']]}")
    return result


def device_kind(device) -> str:
    if device == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(torch.device(device))


def check_line(checks) -> list:
    """The compared numbers, one line each, beside their limits."""
    return [f"{k} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
            for k, v in checks.items()]

