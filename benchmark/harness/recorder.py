"""The program's own spans (``unires_torch.utils.trace``) of the window's
units, as the per-layer readers of ``metrics/`` take them.

The window's units are the last ``len(record["units"])`` ``run.unit``
spans the program kept (the set-up's warm-up unit comes before them). They
are read only where they match ``record["units"]`` one for one: the same
``B``, the same ``n_iter`` of every subject (the unit's ``fit`` span), and
a length within 5 % of the unit's ``init_s + fit_s`` on the harness's
clock. Without the recorder (a program that keeps no spans) or without a
match there is nothing to read: None.
"""
from __future__ import annotations

from collections import defaultdict

MATCH = 0.05  # a unit span's length against the harness's, relative


def units(record):
    """[(the unit's ``run.unit`` span, {name: [its descendants]}), ...]
    in the window's order, or None."""
    try:
        from unires_torch.utils import trace
    except ImportError:
        return None
    want = record.get("units") or []
    kept = trace.spans()
    runs = [s for s in kept if s.name == "run.unit"]
    if not want or len(runs) < len(want):
        return None
    children = defaultdict(list)
    for s in kept:
        children[s.parent].append(s)
    out = []
    for u, run in zip(want, runs[-len(want):]):
        below = defaultdict(list)
        todo = list(children[run.serial])
        while todo:
            s = todo.pop()
            below[s.name].append(s)
            todo.extend(children[s.serial])
        fits = [s for s in below["fit"] if s.parent == run.serial]
        seconds = u["init_s"] + u["fit_s"]
        if (run.attrs.get("B") != u["B"] or len(fits) != 1
                or list(fits[0].attrs.get("n_iter", ())) != list(u["n_iter"])
                or abs(run.s - seconds) > MATCH * seconds):
            return None
        for spans in below.values():
            spans.sort(key=lambda s: s.serial)
        out.append((run, below))
    return out


def subjects(matched) -> int:
    return sum(run.attrs["B"] for run, _ in matched)


def inside(span, spans) -> float:
    """Seconds of those of ``spans`` that lie inside ``span``'s interval on
    its thread."""
    return sum(s.s for s in spans if s.thread == span.thread
               and span.start_ns <= s.start_ns and s.end_ns <= span.end_ns)


def chunk_s(chunk, below) -> float:
    """A ``fit.chunk`` span's seconds less the ``fit.capture`` it holds
    (the first chunk of a fit captures its graph)."""
    return chunk.s - inside(chunk, below["fit.capture"])


def profiler_s(below) -> float:
    """Seconds that a traced run's profiler took around its profiled
    ``fit.chunk`` spans, outside them (starting, waiting, stopping): for
    each, from the end of the span before it to the start of the span after
    it, on the same parent, less the chunk."""
    s = 0.0
    for c in below["fit.chunk"]:
        if not c.profiled:
            continue
        sib = sorted((x for spans in below.values() for x in spans
                      if x.parent == c.parent), key=lambda x: x.serial)
        k = sib.index(c)
        if 0 < k < len(sib) - 1:
            s += (sib[k + 1].start_ns - sib[k - 1].end_ns) * 1e-9 - c.s
    return s
