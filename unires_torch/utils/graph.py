"""Conditional execution and loops that a CUDA graph can capture.

The fit chunk (``solvers.fitloop.make_fit_chunk``) decides on the device:
whether a CG step runs, whether a line-search candidate is evaluated,
whether an outer iteration is frozen. :func:`cond` is the one place that
takes such a decision; :func:`while_loop`, the counterpart of
``lax.while_loop``, repeats a body while a device predicate holds (the NMI
descent of a registration level, ``pipeline.registration``). Both have
three modes:

* inside :func:`capture` (on the card) ``cond`` becomes a conditional IF
  node of the graph and ``while_loop`` a WHILE node (``csrc/graph.cu``:
  PyTorch 2.11 has no such node of its own): the predicate is read by the
  device at every replay (a WHILE node's again at the end of every turn),
  and the body's launches run only where it holds. The body is captured on
  a stream of its own (one per nesting depth); what the bodies allocate
  during the capture comes from a second private memory pool, which lives
  as long as the graph;
* inside :func:`forced` every body runs once, whatever its predicate, on
  the stream it would be captured on (fenced on both sides): the warm-up
  before a capture, which launches every kernel and creates every library
  handle and workspace of every branch once;
* elsewhere (the CPU, or an uncaptured run on the card) the host reads the
  predicate (``utils.host.to_host``, counted): once for a ``cond``, once
  per turn (and once more to stop) for a ``while_loop``.

A body returns nothing: it writes its results into tensors that exist
before it (``copy_`` or in place), since what a skipped body would have
allocated does not exist at replay.
"""
from __future__ import annotations

import contextlib
import ctypes
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


def _streams() -> list:
    """This thread's streams on the current device: MAX_DEPTH body streams
    (one per nesting depth), then the capture's own. They are created
    once with the CUDA runtime, not taken from PyTorch's stream pool, whose
    streams repeat after 32 requests: a body stream that is also the
    capturing stream, or another caller's, cannot begin its capture."""
    streams = _local.__dict__.setdefault("streams", {})
    dev = torch.cuda.current_device()
    if dev not in streams:
        made = []
        for _ in range(MAX_DEPTH + 1):
            ptr = ctypes.c_void_p()
            _check(kernels.get().unires_stream_create(ctypes.byref(ptr)),
                   "creating a stream")
            made.append(torch.cuda.ExternalStream(ptr.value, device=dev))
        streams[dev] = made
    return streams[dev]


# the steps of csrc/graph.cu's begin_node
_STEPS = ("", "cudaStreamGetCaptureInfo", "cudaGraphConditionalHandleCreate",
          "the condition's setter kernel", "the capture's dependencies",
          "cudaGraphAddNode", "cudaStreamUpdateCaptureDependencies",
          "cudaStreamBeginCaptureToGraph")


def _check(err: int, what: str, step=None) -> None:
    if err != 0:
        at = "" if step is None else f" at {_STEPS[step.value]}"
        raise RuntimeError(f"{what}: CUDA error {err}{at}")


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
    with _nested() as (parent, stream):
        if graph is not None:
            flag = pred.reshape(()).to(torch.bool)
            step = ctypes.c_int(0)
            _check(kernels.get().unires_if_begin(
                flag.data_ptr(), parent.cuda_stream, stream.cuda_stream,
                ctypes.byref(step)), "IF node", step)
            _capture_body(stream, body,
                          lambda n: kernels.get().unires_if_end(
                              stream.cuda_stream, n), "an IF node")
        else:
            _fenced(parent, stream, body)
    return True


def while_loop(pred: Callable[[], torch.Tensor],
               body: Callable[[], None]) -> None:
    """While the 0-d bool tensor ``pred()`` holds, run ``body()`` (which
    updates what ``pred`` reads, in place). Under :func:`capture` a WHILE
    node: ``pred()`` is evaluated on the device before the node and again at
    the end of every turn; under :func:`forced` the body runs once; elsewhere
    the host reads ``pred()`` before every turn and once more to stop."""
    graph = getattr(_local, "graph", None)
    force = getattr(_local, "force", False)
    if graph is None and not force:
        while bool(to_host(pred())):
            body()
        return
    with _nested() as (parent, stream):
        if graph is not None:
            flag = pred().reshape(()).to(torch.bool, copy=True)
            handle, step = ctypes.c_ulonglong(0), ctypes.c_int(0)
            _check(kernels.get().unires_while_begin(
                flag.data_ptr(), parent.cuda_stream, stream.cuda_stream,
                ctypes.byref(handle), ctypes.byref(step)), "WHILE node", step)

            def turn():
                body()
                flag.copy_(pred().reshape(()))

            _capture_body(stream, turn,
                          lambda n: kernels.get().unires_while_end(
                              handle.value, flag.data_ptr(),
                              stream.cuda_stream, n), "a WHILE node")
        else:
            pred()
            _fenced(parent, stream, lambda: (body(), pred()))


@contextlib.contextmanager
def _nested():
    """(parent stream, body stream) one nesting depth down."""
    depth = getattr(_local, "depth", 0)
    if depth >= MAX_DEPTH:
        raise RuntimeError(f"conditions nested deeper than {MAX_DEPTH}")
    _local.depth = depth + 1
    try:
        yield torch.cuda.current_stream(), _streams()[depth]
    finally:
        _local.depth = depth


def _capture_body(stream, body, end, what: str) -> None:
    """Capture ``body()`` on ``stream`` (whose capture into a conditional
    node's body has begun), then ``end(nodes)`` it, counting its nodes."""
    try:
        with torch.cuda.stream(stream):
            body()
    except BaseException:
        # end the body's capture; the body's error is the one to see
        end(ctypes.byref(ctypes.c_ulonglong(0)))
        raise
    _check(end(ctypes.byref(_local.nodes)), f"end of {what}'s body")


def _fenced(parent, stream, body) -> None:
    """``body()`` on ``stream``, ordered after and before ``parent``'s work
    (a forced body runs where it would be captured)."""
    stream.wait_stream(parent)
    with torch.cuda.stream(stream):
        body()
    parent.wait_stream(stream)


@contextlib.contextmanager
def forced():
    """Every :func:`cond` and :func:`while_loop` body inside runs once (the
    warm-up of a capture; on the card only)."""
    _local.force = True
    try:
        yield
    finally:
        _local.force = False


def capture(fn: Callable[[], None]) -> "torch.cuda.CUDAGraph":
    """Capture ``fn()`` (launches on the current device) into a CUDA graph,
    its :func:`cond` calls as IF nodes and its :func:`while_loop` calls as
    WHILE nodes, on a side stream. Raises whatever the capture raises: there
    is no fallback to an uncaptured run. Replay with ``graph.replay()`` on
    the stream that should order it. ``graph.nodes`` is its node count,
    those of the conditional nodes' bodies included.

    The capture first waits for the device; that wait counts as a host sync
    (``utils.host.to_host.syncs``). Where less than half the device's
    memory is free, it then returns the memory of the graphs that were freed
    to the device (``empty_cache``): a capture may not free memory, so the
    pools of a process's earlier fits would otherwise fill the card. It
    does not empty the cache before every capture, as ``torch.cuda.graph``
    does: that frees and maps again a few hundred blocks a fit, whose
    system time varies from one capture to the next by tenths of a second.
    """
    stream = _streams()[MAX_DEPTH]  # none is created while capturing
    dev = torch.cuda.current_device()
    graph = torch.cuda.CUDAGraph()
    # the bodies' streams capture into graphs of their own, which the
    # capture's allocation filter does not recognise: what is allocated on
    # them (on any stream of this device but the capturing one) comes from
    # this pool, released with the graph
    bodies = torch.cuda.graph_pool_handle()
    with _capture_lock, torch.cuda.stream(stream):
        torch.cuda.synchronize()
        to_host.syncs += 1
        free, total = torch.cuda.mem_get_info(dev)
        if free < total // 2:
            torch.cuda.empty_cache()
        # thread_local: fit_batch drives one device per host thread
        graph.capture_begin(capture_error_mode="thread_local")
        torch._C._cuda_beginAllocateToPool(dev, bodies)
        weakref.finalize(graph, torch._C._cuda_releasePool, dev, bodies)
        _local.graph = graph
        _local.nodes = ctypes.c_ulonglong(0)
        try:
            # an error leaves the capture unfinished: ending it then can
            # crash the process, and the error is the one to see
            fn()
            _check(kernels.get().unires_capture_nodes(
                stream.cuda_stream, ctypes.byref(_local.nodes)),
                "counting the graph's nodes")
        finally:
            _local.graph = None
            _local.depth = 0
            torch._C._cuda_endAllocateToPool(dev, bodies)
        graph.capture_end()
    graph.nodes = int(_local.nodes.value)
    return graph
