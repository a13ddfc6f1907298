"""Time variants of the pull_grad kernel against the port's on one card.

    python3 scripts/cuda_pull_grad_variants.py

Builds ``scripts/pull_grad_variants.cu`` (which includes the port's
``unires_torch/csrc/resample.cu``) with nvcc, the port's flags and
``-Xptxas -v`` into ``build/pull_grad_variants/``, prints what ptxas says
of every pull_grad kernel (registers, shared memory, spills), and for the
pull_grad cases of ``chip_smoke.py`` phase 3 (``kernel_cases``) times the
port's kernel and each variant with ``chip_smoke._time_ms`` (CUDA events
around each call, L2 flushed before it). Every variant must equal
``pull_grad_plain`` to the bit. Variants: the port's first kernel, the
port's kernel at other block shapes, and its results passed through shared
memory (behind a block or a warp barrier) so that each row segment is
written as consecutive floats.
"""
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

SOURCE = HERE / "scripts" / "pull_grad_variants.cu"
LIB = HERE / "build" / "pull_grad_variants" / "libpull_grad_variants.so"
_VP, _I = ctypes.c_void_p, ctypes.c_int
# variant code -> label (block shapes: lanes z x rows y x rows x)
VARIANTS = {
    0: "first (1D launch, two divisions, 6 products per corner)",
    100: "direct 8x16x1", 101: "direct 8x16x2", 102: "direct 32x4x1",
    103: "direct 32x4x2", 104: "direct 32x4x4",
    105: "direct 32x2x2", 106: "direct 32x8x2", 107: "direct 64x2x2",
    108: "direct 16x8x2 (the port's)", 109: "direct 32x4x3",
    110: "direct 64x4x2",
    200: "staged 8x16x1", 201: "staged 8x16x2", 202: "staged 16x8x2",
    203: "staged 32x4x1", 204: "staged 32x4x2", 205: "staged 32x8x2",
    206: "staged 16x16x2", 207: "staged 8x32x2", 208: "staged 64x4x1",
    300: "warp 32x4x1", 301: "warp 32x4x2", 302: "warp 32x8x2",
    303: "warp 32x2x2",
}


def build():
    LIB.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build._FLAGS,
                          "-Xptxas", "-v", "-o", str(LIB), str(SOURCE)],
                         capture_output=True, text=True, check=True)
    print(f"[variants] built {SOURCE.name} in "
          f"{time.perf_counter() - t0:.2f} s")
    # ptxas: "Compiling entry function '<mangled>'" then "Used N registers"
    name = None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "pull_grad" in name and ("Used" in line
                                               or "spill" in line):
            print(f"[variants] ptxas {name}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(LIB))
    lib.variant_pull_grad.argtypes = [_VP, _VP, _VP] + [_I] * 7 + [_VP]
    lib.variant_pull_grad.restype = _I
    return lib


def main():
    smi = cs.phase_device()
    lib = build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for name, case, inp, Mc, out_dim, _ in cs.kernel_cases("cuda"):
        if name != "pull_grad":
            continue
        M = np.ascontiguousarray(Mc, np.float32)
        out = torch.empty(tuple(out_dim) + (3,), device="cuda")
        label = f"pull_grad/{case}"
        want = tr.pull_grad_plain(inp, M, out_dim)
        port = lambda: tr.pull_grad(inp, M, out_dim)  # noqa: E731
        err = float((port() - want).abs().max())
        cs.require(err == 0.0, f"{label}: port kernel err {err}")
        bnd, _ = cs.bound_ms("pull_grad", inp, out_dim)
        print(f"[variants] {label} {tuple(inp.shape)} -> {tuple(out_dim)} "
              f"bound {bnd:.4f} ms | port kernel: {cs._time_ms(port):.4f} ms")
        for code, desc in VARIANTS.items():
            call = lambda code=code: lib.variant_pull_grad(  # noqa: E731
                inp.data_ptr(), out.data_ptr(), M.ctypes.data, *inp.shape,
                *out_dim, code, stream())
            out.fill_(-1.0)
            cs.require(call() == 0, f"{label} {desc}: launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            cs.require(err == 0.0, f"{label} {desc}: max abs err {err}")
            ms = [cs._time_ms(call) for _ in range(2)]
            print(f"[variants] {label} {desc}: "
                  + " ".join(f"{t:.4f}" for t in ms) + " ms, max_abs_err 0")
        print(f"[variants] {label} port kernel again: "
              f"{cs._time_ms(port):.4f} ms")
    print(f"[variants] {smi}")


if __name__ == "__main__":
    main()
