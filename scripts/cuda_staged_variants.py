"""Time the shared-memory staged pull and push against the port's kernels.

    python3 scripts/cuda_staged_variants.py

Builds ``scripts/staged_resample.cu`` with nvcc (the port's flags) into
``build/staged/``, and for the pull and push cases of ``chip_smoke.py``
phase 3 (``kernel_cases``) times the port's kernel and the staged variant
at each tile, with ``chip_smoke._time_ms`` (CUDA events around each call,
L2 flushed before it). Every staged result must equal the plain version to
the bit, like the port's kernels. The box each tile needs is planned on the
host from the map; a pull box over the shared-memory budget is reported and
skipped (the staged pull has no slab walk), a push box is walked in slabs.
"""
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402
from unires_torch.ops import cuda_build  # noqa: E402
from unires_torch.ops import resample as tr  # noqa: E402

SOURCE = HERE / "scripts" / "staged_resample.cu"
LIB = HERE / "build" / "staged" / "libstaged_resample.so"
SMEM_BUDGET = 200 * 1024  # bytes of dynamic shared memory per block
BOX_EPS = 1.0 / 256.0  # the kernels' kEps
PULL_TILES = ((2, 8, 64), (4, 8, 64), (8, 8, 64), (1, 8, 64), (4, 8, 32),
              (8, 8, 32), (4, 16, 32))
PUSH_TILES = ((4, 8, 32), (2, 8, 32), (8, 8, 32), (4, 16, 32), (2, 16, 32),
              (4, 4, 32), (8, 4, 32), (2, 8, 16))
_VP, _I = ctypes.c_void_p, ctypes.c_int


def build():
    LIB.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([cuda_build.nvcc_path(), *cuda_build._FLAGS, "-o",
                    str(LIB), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(LIB))
    lib.staged_pull.argtypes = [_VP, _VP, _VP] + [_I] * 6 + [_VP, _VP]
    lib.staged_push.argtypes = [_VP] * 5 + [_I] * 10 + [_VP, _VP]
    print(f"[staged] built {SOURCE.name} in {time.perf_counter() - t0:.2f} s")
    return lib


def span(M, tile, dims):
    """Per axis, how far the map moves across a tile, plus float32 slack."""
    M = np.asarray(M, np.float64)
    s = np.abs(M[:, :3]) @ (np.asarray(tile, np.float64) - 1)
    mag = np.abs(M[:, :3]) @ np.asarray(dims, np.float64) + np.abs(M[:, 3])
    return s + 2.0 ** -19 * mag


def pull_plan(M, out_dim, tile):
    """Tile, input box (the corners' floors, +1 corner, +-BOX_EPS), bytes."""
    t = [min(a, n) for a, n in zip(tile, out_dim)]
    b = [int(np.floor(s + 2 * BOX_EPS)) + 3 for s in span(M, t, out_dim)]
    return np.asarray(t + b + [b[0], 4 * b[0] * b[1] * b[2]], np.int32)


def push_plan(Minv, reach, src_dim, tgt_dim, tile):
    """Tile, source box (Minv of the corners +- reach), slab depth, bytes:
    5 words per staged source (code, 3 fractions, value)."""
    t = [min(a, n) for a, n in zip(tile, tgt_dim)]
    b = [min(int(np.floor(s + 2 * r + 2 * BOX_EPS)) + 1, n)
         for s, r, n in zip(span(Minv, t, tgt_dim), reach, src_dim)]
    face = 20 * b[1] * b[2]
    sd = min(b[0], SMEM_BUDGET // face)
    return np.asarray(t + b + [sd, face * sd], np.int32)


def main():
    smi = cs.phase_device()
    lib = build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for name, case, inp, Mc, out_dim, kw in cs.kernel_cases("cuda"):
        order = kw.get("order", 1)
        if name == "pull_grad" or (name == "pull" and order == 0):
            continue  # not staged: pull_grad is not redesigned, and an
            # order-0 pull reads one value per output
        M = np.ascontiguousarray(Mc, np.float32)
        out = torch.empty(out_dim, device="cuda")
        label = f"{name}/{case}"
        if name == "pull":
            port = lambda: tr.pull(inp, M, out_dim)  # noqa: E731
            want = tr.pull_plain(inp, M, out_dim)
            args = (inp.data_ptr(), out.data_ptr(), M.ctypes.data,
                    *inp.shape, *out_dim)
            plans = [pull_plan(M, out_dim, t) for t in PULL_TILES]
            call = lambda p: lib.staged_pull(  # noqa: E731
                *args, p.ctypes.data, stream())
        else:
            Minv = np.ascontiguousarray(kw.get("Minv", tr.inverse_map(M)),
                                        np.float32)
            reach = tr.push_reach(M, Minv, order, tuple(inp.shape), out_dim)
            window = tr.push_window(M)
            port = lambda: tr.push(inp, M, out_dim, order=order,  # noqa: E731
                                   Minv=Minv)
            want = tr.push_plain(inp, M, out_dim, order=order, Minv=Minv)
            args = (inp.data_ptr(), out.data_ptr(), M.ctypes.data,
                    Minv.ctypes.data, reach.ctypes.data, *inp.shape,
                    *out_dim, *window, order)
            plans = [push_plan(Minv, reach, tuple(inp.shape), out_dim, t)
                     for t in PUSH_TILES]
            call = lambda p: lib.staged_push(  # noqa: E731
                *args, p.ctypes.data, stream())
        err = float((port() - want).abs().max())
        cs.require(err == 0.0, f"{label}: port kernel err {err}")
        print(f"[staged] {label} port kernel: {cs._time_ms(port):.4f} ms")
        for p in plans:
            desc = (f"tile {tuple(p[:3].tolist())} box "
                    f"{tuple(p[3:6].tolist())} slab {p[6]} smem {p[7]} B")
            if p[7] > SMEM_BUDGET:
                print(f"[staged] {label} {desc}: over the budget, skipped")
                continue
            out.fill_(-1.0)
            cs.require(call(p) == 0, f"{label} {desc}: launch failed")
            err = float((out - want).abs().max())
            cs.require(err == 0.0, f"{label} {desc}: max abs err {err}")
            fn = lambda p=p: call(p)  # noqa: E731
            print(f"[staged] {label} {desc}: {cs._time_ms(fn):.4f} ms, "
                  f"max_abs_err 0")
        print(f"[staged] {label} port kernel again: "
              f"{cs._time_ms(port):.4f} ms")
    print(f"[staged] {smi}")


if __name__ == "__main__":
    main()
