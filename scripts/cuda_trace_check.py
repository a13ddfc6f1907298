"""What the span recorder (``unires_torch.utils.trace``) costs, whether its
clock is the profiler's, and whether its spans agree with the benchmark's
own timers, on one CUDA card.

    python3 scripts/cuda_trace_check.py --workload sr3.subjects --seed N
                                        [--seconds 47] [--count 200000]

1. Host microseconds a span: ``count`` empty spans inside one open span,
   without a profiler.
2. One traced run of the benchmark cell ``workload`` as
   ``benchmark/run.py --trace 1`` makes it (``harness.main.run_cell``),
   holding on to the record that its per-layer readers read and to the
   profiler trace of its profiled chunk. Prints the spans a subject by
   name and their cost at the measured microseconds a span; per subject or
   fit the program's ``registration.coreg``, ``registration.atlas`` and
   ``fit.capture`` spans beside the harness's timers of the same calls
   (``program.Spans``); the offset of each profiled span from its
   profiler event, start and end, on the profiler's clock (its trace start
   plus the event's microseconds); the device-side events that carry a
   span's name (none is expected).
3. Host microseconds a span under an active ``torch.profiler`` (CPU and
   CUDA activities), where each span also opens its profiler range. This
   comes after the run: in one process a profiler session after the first
   loses device events (on torch 2.11 with CUDA 12.8 the second session of
   a process held a third of a chunk's kernel events), so the run's
   profiled chunk has to be the process's first.

The run's result line is printed last.
"""
import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]


def per_span_us(trace, count, profiled):
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = None
    if profiled:
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    with trace.span("cost.outer"):
        t0 = time.perf_counter_ns()
        for _ in range(count):
            with trace.span("cost.span", k=1):
                pass
        t1 = time.perf_counter_ns()
    if prof is not None:
        prof.stop()
    trace.clear()
    return (t1 - t0) / count / 1e3


def agreement(record, spans):
    """Lines: each program span beside the harness timer of the same call."""
    lines, worst = [], (0.0, 0.0)
    for name in ("registration.coreg", "registration.atlas", "fit.capture"):
        mine = [s.s for s in sorted((s for s in spans if s.name == name),
                                    key=lambda s: s.serial)]
        theirs = record["spans"].get(name, [])
        # the harness times the window's calls; the set-up's come first
        mine = mine[len(mine) - len(theirs):] if theirs else []
        pairs = list(zip(mine, theirs))
        for a, b in pairs:
            worst = max(worst, (abs(a - b), abs(a - b) / b if b else 0.0))
        lines.append(f"{name}: program {[round(a, 4) for a, _ in pairs]} s, "
                     f"harness {[round(b, 4) for _, b in pairs]} s")
    lines.append(f"largest gap: {worst[0] * 1e3:.2f} ms, "
                 f"{100 * worst[1]:.2f} %")
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="sr3.subjects")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=47.0)
    ap.add_argument("--count", type=int, default=200000)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType

    from harness import main as bench, spec
    from unires_torch.utils import trace

    device = "cuda" if torch.cuda.is_available() else "cpu"
    plain = per_span_us(trace, args.count, False)
    print(f"[trace] torch {torch.__version__} | host us a span: {plain:.3f} "
          f"without a profiler ({args.count} spans)")

    kept = {}
    reduce = bench.trace.reduce

    def keep_prof(prof, wall_s):
        kept["prof"] = prof
        return reduce(prof, wall_s)

    reader = spec.metric_reader

    def keep_record(name):
        read = reader(name)

        def wrapped(record):
            kept["record"] = record
            return read(record)
        return wrapped

    bench.trace.reduce, bench.spec.metric_reader = keep_prof, keep_record
    since = trace.serial()
    try:
        result = bench.run_cell(args.workload, args.seed, args.seconds, True,
                                device=device)
    finally:
        bench.trace.reduce, bench.spec.metric_reader = reduce, reader
    record, prof = kept["record"], kept["prof"]
    spans = trace.spans(since=since)
    units = record["units"]
    subjects = sum(u["B"] for u in units)
    runs = trace.spans("run.unit", since)
    window = [s for s in spans if s.serial >= runs[-len(units)].serial]
    names = Counter(s.name for s in window)
    print(f"[trace] {args.workload}: {len(window)} spans in the window's "
          f"{len(units)} units, {len(window) / subjects:.1f} a subject, "
          f"{len(window) / subjects * plain:.1f} us a subject at "
          f"{plain:.3f} us a span")
    print("[trace] spans a subject: " + ", ".join(
        f"{n} {c / subjects:g}" for n, c in sorted(names.items())))
    for line in agreement(record, spans):
        print(f"[trace] {line}")

    t0 = prof.profiler.kineto_results.trace_start_ns()
    events, named_dev = {}, Counter()
    span_names = {s.name for s in spans}
    for e in prof.events():
        if e.name in span_names:
            if e.device_type == DeviceType.CUDA:
                named_dev[e.name] += 1
            else:
                events.setdefault(e.name, e)
    worst = 0.0
    for s in spans:
        e = events.get(s.name) if s.profiled else None
        if e is None:
            continue
        d0 = (s.start_ns - (t0 + 1000 * e.time_range.start)) / 1e6
        d1 = (s.end_ns - (t0 + 1000 * e.time_range.end)) / 1e6
        worst = max(worst, abs(d0), abs(d1))
        print(f"[trace] {s.name}: span {s.s * 1e3:.3f} ms, event "
              f"{(e.time_range.end - e.time_range.start) / 1e3:.3f} ms | "
              f"span - event: start {d0:+.4f} ms, end {d1:+.4f} ms")
    print(f"[trace] largest clock offset of a profiled span: {worst:.4f} ms | "
          f"device events named after a span: {dict(named_dev)}")
    prof_n = max(args.count // 20, 1000)
    under = per_span_us(trace, prof_n, True)
    print(f"[trace] host us a span under torch.profiler: {under:.3f} "
          f"({prof_n} spans, each with its profiler range)")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
