"""Start a group of ranks on one host: one fresh process per rank.

``spawn(fn, world, backend, *args)`` runs ``fn(*args)`` in ``world``
processes started with the ``spawn`` method, each one thread, joined into
one ``torch.distributed`` group through a ``file://`` rendezvous in a fresh
temporary directory (no port to collide with another group on the host),
and returns the ranks' results in rank order. ``fn`` must be importable by
name: a function of this package, so that a child imports nothing else. A
rank that raises, or a group that outlives ``TIMEOUT_S``, stops every rank
and raises here. The multi-rank tests (on gloo) and
:func:`unires_torch.parallel.dryrun.dryrun_multichip` run the parallel
solvers through it.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .sharding import init_multihost

TIMEOUT_S = 300.0  # a hung group fails its caller after this long


def _rank_main(rank, world, device, init_method, fn, args_path, results):
    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)  # written by spawn, in this process group
        init_multihost(init_method, world, rank, device=device)
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world: int, backend: str = "gloo", *args) -> list:
    """``[fn(*args) on rank 0, ..., on rank world - 1]``.

    ``backend``: "gloo" (CPU ranks) or "nccl" (rank r on CUDA device r).
    The arguments reach the ranks through a file in the call's temporary
    directory, not through the start-up pipe: a child reads the pipe only
    once it has imported torch, so a large argument there would start the
    ranks one after another.
    """
    device = {"gloo": "cpu", "nccl": "cuda"}[backend]
    tmp = tempfile.mkdtemp(prefix="unires_torch_spawn_")
    init_file = os.path.join(tmp, "rendezvous")
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, f"{device}:{r}" if device == "cuda"
                               else device, f"file://{init_file}", fn,
                               args_path, results))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        out = [None] * world
        deadline = time.monotonic() + TIMEOUT_S
        for _ in range(world):  # drain the queue before joining
            try:
                rank, ok, val = results.get(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except queue.Empty:
                raise TimeoutError(
                    f"spawn: {fn.__name__} on {world} ranks did not finish "
                    f"in {TIMEOUT_S} s") from None
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} of {world} failed in "
                                   f"{fn.__name__}:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
        shutil.rmtree(tmp, ignore_errors=True)


def run_cases(cases) -> list:
    """Run ``fn(**kw)`` for every ``(fn, kw)`` of ``cases`` in order, on
    every rank alike (their collectives then match), and return the list of
    results: many cases for the price of one spawn."""
    return [fn(**kw) for fn, kw in cases]
