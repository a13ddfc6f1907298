"""Conditional execution that a CUDA graph can capture.

The fit chunk (``solvers.fitloop.make_fit_chunk``) decides on the device:
whether a CG step runs, whether a line-search candidate is evaluated,
whether an outer iteration is frozen. :func:`cond` is the one place that
takes such a decision:

* inside :func:`capture` (on the card) it becomes a conditional IF node of
  the graph (``csrc/graph.cu``: PyTorch 2.11 has no such node of its own):
  the predicate is read by the device at every replay, and the body's
  launches run only where it holds. The body is captured on a stream of its
  own (one per nesting depth); what the bodies allocate during the capture
  comes from a second private memory pool, which lives as long as the
  graph;
* inside :func:`forced` every body runs, whatever its predicate, on the
  stream it would be captured on (fenced on both sides): the warm-up before
  a capture, which launches every kernel and creates every library handle
  and workspace of every branch once;
* elsewhere (the CPU, or an uncaptured run on the card) the host reads the
  predicate (``utils.host.to_host``, counted) and runs the body or not.

A body returns nothing: it writes its results into tensors that exist
before it (``copy_`` or in place), since what a skipped body would have
allocated does not exist at replay.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Callable

import torch

from ..ops.cuda_build import kernels
from .host import to_host

_local = threading.local()
_capture_lock = threading.Lock()  # one capture at a time in the process
MAX_DEPTH = 8  # nesting depth of the conditions


def capturing() -> bool:
    """True inside :func:`capture` on this thread."""
    return getattr(_local, "graph", None) is not None


def _body_stream(depth: int) -> torch.cuda.Stream:
    """The stream that bodies at nesting ``depth`` run on (per device)."""
    streams = _local.__dict__.setdefault("streams", {}).setdefault(
        torch.cuda.current_device(), [])
    while len(streams) <= depth:
        streams.append(torch.cuda.Stream())
    return streams[depth]


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def cond(pred: torch.Tensor, body: Callable[[], None]) -> bool:
    """Run ``body()`` where the 0-d bool tensor ``pred`` holds. Returns
    False when the host read ``pred`` and skipped the body, else True."""
    graph = getattr(_local, "graph", None)
    force = getattr(_local, "force", False)
    if graph is None and not force:
        if not bool(to_host(pred)):
            return False
        body()
        return True
    depth = getattr(_local, "depth", 0)
    if depth >= MAX_DEPTH:
        raise RuntimeError(f"conditions nested deeper than {MAX_DEPTH}")
    parent = torch.cuda.current_stream()
    stream = _body_stream(depth)
    _local.depth = depth + 1
    try:
        if graph is not None:
            flag = pred.reshape(()).to(torch.bool)
            _check(kernels.get().unires_if_begin(
                flag.data_ptr(), parent.cuda_stream, stream.cuda_stream),
                "IF node")
            try:
                with torch.cuda.stream(stream):
                    body()
            except BaseException:
                # end the body's capture; the body's error is the one to see
                kernels.get().unires_if_end(stream.cuda_stream)
                raise
            _check(kernels.get().unires_if_end(stream.cuda_stream),
                   "end of an IF node's body")
        else:
            stream.wait_stream(parent)
            with torch.cuda.stream(stream):
                body()
            parent.wait_stream(stream)
    finally:
        _local.depth = depth
    return True


@contextlib.contextmanager
def forced():
    """Every :func:`cond` body inside runs (the warm-up of a capture; on
    the card only)."""
    _local.force = True
    try:
        yield
    finally:
        _local.force = False


def capture(fn: Callable[[], None]) -> "torch.cuda.CUDAGraph":
    """Capture ``fn()`` (launches on the current device) into a CUDA graph,
    its :func:`cond` calls as IF nodes, on a side stream. Raises whatever
    the capture raises: there is no fallback to an uncaptured run. Replay
    with ``graph.replay()`` on the stream that should order it.

    The capture first waits for the device and returns the memory of the
    graphs that were freed to the device (``empty_cache``, as
    ``torch.cuda.graph`` does: a capture may not free memory, so the pools
    of a process's earlier fits would otherwise fill the card); that wait
    counts as a host sync (``utils.host.to_host.syncs``).
    """
    for depth in range(MAX_DEPTH):  # no stream is created while capturing
        _body_stream(depth)
    dev = torch.cuda.current_device()
    graph = torch.cuda.CUDAGraph()
    # the bodies' streams capture into graphs of their own, which the
    # capture's allocation filter does not recognise: what is allocated on
    # them (on any stream of this device but the capturing one) comes from
    # this pool, released with the graph
    bodies = torch.cuda.graph_pool_handle()
    stream = torch.cuda.Stream()
    with _capture_lock, torch.cuda.stream(stream):
        torch.cuda.synchronize()
        to_host.syncs += 1
        torch.cuda.empty_cache()
        # thread_local: fit_batch drives one device per host thread
        graph.capture_begin(capture_error_mode="thread_local")
        torch._C._cuda_beginAllocateToPool(dev, bodies)
        weakref.finalize(graph, torch._C._cuda_releasePool, dev, bodies)
        _local.graph = graph
        try:
            # an error leaves the capture unfinished: ending it then can
            # crash the process, and the error is the one to see
            fn()
        finally:
            _local.graph = None
            _local.depth = 0
            torch._C._cuda_endAllocateToPool(dev, bodies)
        graph.capture_end()
    return graph
