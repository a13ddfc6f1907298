"""Spans of the port's host-side phases, kept in memory.

A span is a named interval of one host thread: a phase of ``init``, a
registration level, the fit's set-up, a chunk, the output. It records its
start and end, its parent (the innermost span open on the same thread when
it opened), the thread, the trace ids of the subject or subjects it serves
and its counts (``attrs``). ``pipeline.run.init`` gives each subject a new
id (:func:`new_id`) and carries it on the subject's ``y`` structs
(:func:`subject`); a span without ids of its own takes its parent's.

    from unires_torch.utils import trace
    unires_torch.preproc(data, sett)
    for s in trace.spans():
        print(s.name, s.ids, f"{s.s:.3f} s", s.attrs)

Spans sit only at host-side boundaries that run every time (none inside a
captured graph's body, so none runs per iteration), and a span waits for
nothing: it times what the host does. The device's work is inside a span's
interval only where the span ends at a host read that the program makes
anyway: ``registration.level.capture`` (the capture's own wait),
``registration.level.run`` (the level's one read), ``fit.capture`` (the
capture's wait), ``fit.chunk`` and ``fit.chunk.read`` (the chunk's one
read), ``run.output`` (the volumes' copy to the host), and the spans that
hold one of these (``registration.*``, ``init``, ``fit``, ``run.unit``).
``fit.chunk.launch`` only enqueues (the first chunk of a fit holds that
fit's ``fit.capture``).

Times are nanoseconds on the Unix-epoch clock that ``torch.profiler``
stamps its events with: ``perf_counter_ns()`` plus one offset to
``time_ns()`` taken at import. While a profiler is active a span also
opens a host range of its name in the profiler (and records
``profiled=True``), so a profiler trace, ``Settings.profile_dir``'s
included, shows the program's phases beside its kernels. The range is the
profiler's fast record function, an operator's range: unlike
``torch.profiler.record_function``'s user annotation, it draws no range on
the device's timeline, where it would read as device work to whatever sums
the device's events. The kept spans are bounded (:data:`MAX_SPANS`); the
oldest are dropped first.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Iterable, Optional, Tuple

import torch

MAX_SPANS = 1 << 16  # about 50 a subject: over a thousand subjects

_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
_kept = collections.deque(maxlen=MAX_SPANS)
_serials = itertools.count()
_ids = itertools.count(1)
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled


def now_ns() -> int:
    """Nanoseconds since the Unix epoch, on the profiler's clock."""
    return time.perf_counter_ns() + _OFFSET_NS


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: ``name``, ``start_ns`` / ``end_ns`` (:func:`now_ns`),
    ``serial`` (the order spans opened in), the ``parent``'s serial (None at
    a thread's top), ``thread`` (``threading.get_ident()``), ``ids`` (the
    subjects' trace ids), ``attrs`` (its counts; the code that opened it
    may add some before it ends) and ``profiled``. A context manager: it is
    kept when it ends."""

    __slots__ = ("name", "start_ns", "end_ns", "serial", "parent", "thread",
                 "ids", "attrs", "profiled", "_rf")

    def __init__(self, name: str, ids: Optional[Iterable[int]] = None,
                 attrs: Optional[dict] = None):
        self.name = name
        self.ids = None if ids is None else tuple(ids)
        self.attrs = {} if attrs is None else attrs
        self.start_ns = self.end_ns = None
        self.profiled = False
        self._rf = None

    @property
    def s(self) -> float:
        """Seconds from start to end."""
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        stack = _stack()
        top = stack[-1] if stack else None
        self.serial = next(_serials)
        self.parent = None if top is None else top.serial
        self.thread = threading.get_ident()
        if self.ids is None:
            self.ids = () if top is None else top.ids
        if _profiling():
            # the range first: its first entry in a profiler session can
            # take a millisecond before the profiler stamps the range's start
            self._rf = torch._C._profiler._RecordFunctionFast(self.name)
            self._rf.__enter__()
            self.profiled = True
        stack.append(self)
        self.start_ns = now_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = now_ns()
        _stack().pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        _kept.append(self)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, serial={self.serial}, parent="
                f"{self.parent}, ids={self.ids}, s={self.s:.6f}, "
                f"attrs={self.attrs})")


def span(name: str, ids: Optional[Iterable[int]] = None, **attrs) -> Span:
    """A span named ``name`` with the counts ``attrs``, for a ``with``
    block; ``ids``: the trace ids of the subjects it serves (default: its
    parent's)."""
    return Span(name, ids, attrs)


@contextlib.contextmanager
def within(parent: Span):
    """Open spans inside the block on this thread as children of
    ``parent``, a span open on another thread (``parallel.fit_batch``'s
    device threads): nothing is recorded for ``parent`` here."""
    stack = _stack()
    stack.append(parent)
    try:
        yield
    finally:
        stack.pop()


def new_id() -> int:
    """A new subject trace id."""
    return next(_ids)


def subject(y) -> Optional[int]:
    """The trace id of the subject whose ``y`` structs these are (set by
    ``pipeline.run.init``), or None."""
    return getattr(y[0], "trace_id", None) if y else None


def subjects(ys) -> Tuple[int, ...]:
    """The trace ids of the subjects of ``ys``, those without one left out."""
    return tuple(i for i in map(subject, ys) if i is not None)


def spans(name: Optional[str] = None, since: int = 0) -> list:
    """A snapshot of the kept spans in the order they ended: those named
    ``name`` (default: all) that opened at serial ``since`` or later
    (:func:`serial`)."""
    return [s for s in list(_kept)
            if s.serial >= since and (name is None or s.name == name)]


def serial() -> int:
    """A serial below that of every span opened after this call:
    ``spans(since=serial())`` taken later holds only those spans."""
    return next(_serials)


def clear() -> None:
    """Drop every kept span (spans still open are kept when they end)."""
    _kept.clear()
