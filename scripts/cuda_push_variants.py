"""Time variants of the push kernel against the port's on one card.

    python3 scripts/cuda_push_variants.py [--reps 2]

Builds ``scripts/push_variants.cu`` (which includes the port's
``unires_torch/csrc/resample.cu``) with nvcc, the port's flags and
``-Xptxas -v`` into ``build/push_variants/``, prints what ptxas says of
every push kernel (registers, spills), and for the push cases of
``chip_smoke.py`` phase 3 (``kernel_cases``, ``fov_kernel_cases`` and the
batched launch of ``KERNEL_BATCH`` volumes at the fit's shapes) times the
port's kernel and each variant with ``chip_smoke._time_ms`` (CUDA events
around each call, L2 flushed before it), ``reps`` times in turns, the port
first and last. Every variant must equal ``push_plain`` to the bit.
Variants: the port's first gather (one target per thread), a copy of the
port's tiled kernel at other tile and block shapes and with options it
lacks, and the sums kept in shared memory (order 1 only).
"""
import argparse
import ctypes
import re
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

SOURCE = HERE / "scripts" / "push_variants.cu"
LIB = HERE / "build" / "push_variants" / "libpush_variants.so"
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# variant code of push_variants.cu -> label: tiles TX (x) x TY (y) x TZ (z)
# targets, blocks LZ (z) x LY (y) x LX (x) threads (smem: LZ x LY); 1 is
# the port's tile and block
VARIANTS = {0: "target (one target per thread, block 8x16)",
            1: "tile 1x2x4 block 2x4x16 (the port's shape)",
            2: "tile 1x2x4 block 4x16x1",
            3: "tile 1x2x4 block 2x4x16 select",
            4: "tile 1x2x4 block 2x4x16 unroll2",
            5: "tile 1x2x4 block 2x4x16 fast floor",
            6: "tile 1x2x4 block 2x4x16 exact setup",
            7: "tile 1x3x4 block 2x4x16", 8: "tile 1x2x4 block 2x2x32",
            9: "tile 1x2x4 block 2x4x16 staged store", 10: "tile 1x2x2 block 2x4x16",
            11: "tile 1x1x4 block 2x4x16", 12: "tile 2x2x2 block 2x4x16",
            13: "tile 1x3x4 block 2x4x16 staged store",
            14: "tile 1x4x4 block 2x4x16 staged store",
            15: "tile 1x2x4 block 2x2x32 staged store", 16: "tile 1x1x1 block 8x16x1",
            17: "tile 1x4x4 block 2x4x16", 18: "tile 1x3x4 block 2x2x32",
            19: "tile 1x2x4 block 2x8x8",
            20: "smem 4x4x4 block 8x4", 21: "smem 4x4x4 block 8x8",
            22: "smem 2x4x8 block 4x16", 23: "smem 2x8x8 block 4x8",
            24: "smem 1x8x8 block 4x16", 25: "smem 2x4x4 block 8x8",
            26: "smem 4x4x8 block 4x8", 27: "smem 2x2x8 block 4x16"}


def build():
    LIB.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build._FLAGS,
                          "-Xptxas", "-v", "-o", str(LIB), str(SOURCE)],
                         capture_output=True, text=True, check=True)
    print(f"[pushvar] built {SOURCE.name} in "
          f"{time.perf_counter() - t0:.2f} s")
    name = None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("push" in name or "target" in name) and (
                "Used" in line or "spill" in line):
            print(f"[pushvar] ptxas {name}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(LIB))
    lib.variant_push.argtypes = [_I] + [_VP] * 4 + [_I] * 10 + [_I, _LL, _VP]
    lib.variant_push.restype = _I
    return lib


def cases():
    """(label, vals, plan, the push's keywords, plain result, batch) of the
    push cases of phase 3, the plan on the card as the fit chunk makes it."""
    out = []
    for name, case, inp, Mc, out_dim, kw in (cs.kernel_cases("cuda")
                                              + cs.fov_kernel_cases("cuda")):
        if name != "push":
            continue
        Md = torch.from_numpy(tr._as_map(Mc)).cuda()
        Minv = kw.get("Minv")
        plan = tr.push_plan(Md, None if Minv is None else torch.from_numpy(
            tr._as_map(Minv)).cuda(), kw.get("order", 1), tuple(inp.shape),
            out_dim)
        want = tr.push_plain(inp, Mc, out_dim, **kw)
        out.append((f"push/{case}", inp, Md, plan, kw, want, 0))
    # the batched launch of phase 3
    inp, Ms, kw, out_dim, plain = cs.batch_case("push")
    want = torch.stack([plain(b) for b in range(len(Ms))])
    out.append((f"push/batch{len(Ms)}", inp, torch.from_numpy(Ms).cuda(),
                kw["Minv"], {}, want, len(Ms)))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--only", type=int, nargs="*",
                    help="variant codes to time (default: all)")
    ap.add_argument("--cases", nargs="*",
                    help="cases to time, e.g. fit large (default: all)")
    args = ap.parse_args()
    smi = cs.phase_device()
    lib = build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for label, inp, Md, plan, kw, want, B in cases():
        if args.cases and label.split("/")[1] not in args.cases:
            continue
        out_dim = tuple(want.shape[-3:])
        order = kw.get("order", 1)
        fov = kw.get("fov")
        fov = None if fov is None else np.ascontiguousarray(fov, np.float32)
        window = kw.get("window") or (-1, -1, -1)
        src = tuple(inp.shape[-3:])
        out = torch.empty_like(want)
        port = lambda: tr.push(inp, Md, out_dim, order=order,  # noqa: E731
                               Minv=plan, window=kw.get("window"),
                               fov=kw.get("fov"))
        cs.require(torch.equal(port(), want), f"{label}: port kernel differs")
        bnd, _ = cs.bound_ms("push", inp[0] if B else inp, out_dim, order)
        bnd *= max(B, 1)
        print(f"[pushvar] {label} {tuple(inp.shape)} -> {tuple(want.shape)} "
              f"bound {bnd:.4f} ms | port kernel {cs._time_ms(port):.4f} ms")
        for code, desc in VARIANTS.items():
            if (order != 1 and code) or (args.only and code not in args.only):
                continue
            call = lambda code=code: lib.variant_push(  # noqa: E731
                code, inp.data_ptr(), out.data_ptr(), plan.data_ptr(),
                None if fov is None else fov.ctypes.data, *src, *out_dim,
                *window, order, B, int(inp[0].numel()) if B else 0, stream())
            out.fill_(float("nan"))
            cs.require(call() == 0, f"{label} {desc}: launch failed")
            torch.cuda.synchronize()
            cs.require(torch.equal(out, want),
                       f"{label} {desc}: max abs err "
                       f"{float((out - want).abs().max())}")
            ms = [cs._time_ms(call) for _ in range(args.reps)]
            print(f"[pushvar] {label} {desc}: "
                  + " ".join(f"{t:.4f}" for t in ms)
                  + f" ms (share {bnd / min(ms):.1%}), max_abs_err 0")
        print(f"[pushvar] {label} port kernel again: "
              f"{cs._time_ms(port):.4f} ms")
    print(f"[pushvar] {smi}")


if __name__ == "__main__":
    main()
