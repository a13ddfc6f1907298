"""Time variants of the pull kernel against the port's on one card.

    python3 scripts/cuda_pull_variants.py [--only CODES] [--cases fit ...]
                                          [--bench]

Builds ``scripts/pull_variants.cu`` (which includes the port's
``unires_torch/csrc/resample.cu``) with nvcc, the port's flags and
``-Xptxas -v`` into ``build/pull_variants/``, prints what ptxas says of
every variant's kernel (registers, spills), and for the pull cases of
``chip_smoke.py`` phase 3 (``kernel_cases``) times the port's kernel and
each variant with ``chip_smoke._time_ms`` (CUDA events around each call, L2
flushed before it), twice each, the port again at the end of a case. Every
variant must equal ``pull_plain`` to the bit. ``--bench`` times them
instead at the forward pulls of the misaligned bench fit
(``chip_smoke.bench_pull_cases``), whose sample points all lie inside the
volume. Variants: the port's previous
tile ("rows": a block of lanes along z times rows along y, rows i and
i + 1 per thread) at block shapes lanes z x rows y x rows x, and a warp of
32 lanes along z of one row ("warp": TZ outputs along z per thread x RY
warps along y x RX rows along x), each with the corners read by floorf and
gather_corners, by rounding-down floors ("rd") and gather_corners' general
path near the edge, by rounding-down floors and edge_corners ("rd+edge"),
("shfl") with the c + 1 corners from the next lane, or ("edge") every
point by rounding-down floors and edge_corners, with no branch, or
("zfix") the z edge taken into the fast path by a clamp and selects; and
the port's block with its lanes chosen per block as 32 along z or 8 (z) x
4 (y), by a block barrier ("adapt") or from the map ("adapt map").
"""
import argparse
import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402
from unires_torch.ops import cuda_build  # noqa: E402
from unires_torch.ops import resample as tr  # noqa: E402

SOURCE = HERE / "scripts" / "pull_variants.cu"
LIB = HERE / "build" / "pull_variants" / "libpull_variants.so"
_VP, _I = ctypes.c_void_p, ctypes.c_int
# variant code -> label (rows: lanes z x rows y x rows x; warp: outputs
# along z per thread x warps along y x rows along x)
VARIANTS = {
    0: "rows 8x16x2 (the port's previous pull)", 1: "rows 32x4x2",
    2: "rows 32x2x2", 3: "rows 32x8x1", 4: "rows 16x8x2", 5: "rows 64x2x2",
    6: "rows 32x4x1", 7: "rows 8x16x1", 8: "rows 16x16x2",
    9: "rows 4x32x2", 10: "rows 8x8x2", 11: "rows 8x32x2",
    100: "warp floorf 1x4x1", 101: "warp floorf 1x4x2",
    102: "warp floorf 2x4x1", 103: "warp floorf 2x4x2",
    104: "warp floorf 4x4x1", 105: "warp floorf 2x8x1",
    200: "warp rd 1x4x1", 201: "warp rd 1x4x2", 202: "warp rd 2x4x1",
    203: "warp rd 2x4x2", 204: "warp rd 4x4x1", 205: "warp rd 2x8x1",
    206: "warp rd 2x2x2", 207: "warp rd 1x8x2", 208: "warp rd 4x2x1",
    209: "warp rd 1x4x4", 210: "warp rd 2x2x1", 211: "warp rd 2x16x1",
    300: "warp shfl 1x4x1", 301: "warp shfl 2x4x1", 302: "warp shfl 1x4x2",
    400: "rows rd 8x16x2", 401: "rows rd 16x8x2", 402: "rows rd 4x32x2",
    500: "rows rd+edge 8x16x2", 501: "rows rd+edge 16x8x2",
    502: "rows rd+edge 4x32x2", 503: "rows rd+edge 8x8x2",
    504: "rows rd+edge 8x32x2", 505: "rows rd+edge 8x16x1",
    506: "rows rd+edge 8x16x3", 507: "rows rd+edge 32x4x2",
    600: "warp rd+edge 1x4x1", 601: "warp rd+edge 1x4x2",
    602: "warp rd+edge 2x4x1", 603: "warp rd+edge 2x4x2",
    604: "warp rd+edge 1x8x2", 605: "warp rd+edge 1x8x1",
    700: "rows edge 8x16x2", 701: "rows edge 16x8x2", 702: "rows edge 8x16x1",
    800: "warp edge 1x4x1", 801: "warp edge 1x4x2", 802: "warp edge 2x4x1",
    803: "warp edge 2x4x2", 804: "warp edge 2x2x2",
    900: "rows zfix 8x16x2", 901: "rows zfix 16x8x2",
    1000: "warp zfix 1x4x1", 1001: "warp zfix 1x4x2", 1002: "warp zfix 2x4x1",
    1003: "warp zfix 2x4x2", 1004: "warp zfix 2x2x2", 1005: "warp zfix 2x8x2",
    1100: "adapt rd+edge 64x4x2",
    1101: "adapt map rd+edge 64x4x2",
}


def build():
    LIB.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([cuda_build.nvcc_path(), *cuda_build._FLAGS,
                          "-Xptxas", "-v", "-o", str(LIB), str(SOURCE)],
                         capture_output=True, text=True, check=True)
    print(f"[pullvar] built {SOURCE.name} in "
          f"{time.perf_counter() - t0:.2f} s")
    # ptxas: "Compiling entry function '<mangled>'" then "Used N registers"
    name = None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "pull" in name and ("Used" in line or "spill" in line):
            print(f"[pullvar] ptxas {name}: {line.split(':', 1)[-1].strip()}")
    lib = ctypes.CDLL(str(LIB))
    lib.variant_pull.argtypes = [_VP, _VP, _VP] + [_I] * 8 + [_VP]
    lib.variant_pull.restype = _I
    return lib


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", type=int, nargs="*", default=None,
                    help="variant codes to time (default: all)")
    ap.add_argument("--cases", nargs="*", default=None,
                    help="phase-3 pull cases to time (default: all)")
    ap.add_argument("--bench", action="store_true")
    args = ap.parse_args()
    smi = cs.phase_device()
    lib = build()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    codes = [c for c in VARIANTS if args.only is None or c in args.only]
    cases = (cs.bench_pull_cases("cuda") if args.bench
             else cs.kernel_cases("cuda"))
    for name, case, inp, Mc, out_dim, kw in cases:
        if name != "pull" or (args.cases and case not in args.cases):
            continue
        order = kw.get("order", 1)
        Md = torch.from_numpy(tr._as_map(Mc)).cuda()
        out = torch.empty(tuple(out_dim), device="cuda")
        label = f"pull/{case}"
        want = tr.pull_plain(inp, Mc, out_dim, **kw)
        port = lambda: tr.pull(inp, Md, out_dim, **kw)  # noqa: E731
        err = float((port() - want).abs().max())
        cs.require(err == 0.0, f"{label}: port kernel err {err}")
        bnd, _ = cs.bound_ms("pull", inp, out_dim, order)
        print(f"[pullvar] {label} {tuple(inp.shape)} -> {tuple(out_dim)} "
              f"bound {bnd:.4f} ms | port kernel: {cs._time_ms(port):.4f} ms")
        for code in codes:
            call = lambda code=code: lib.variant_pull(  # noqa: E731
                inp.data_ptr(), out.data_ptr(), Md.data_ptr(), *inp.shape,
                *out_dim, order, code, stream())
            out.fill_(-1.0)
            cs.require(call() == 0, f"{label} {VARIANTS[code]}: launch failed")
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            cs.require(err == 0.0, f"{label} {VARIANTS[code]}: max abs err "
                       f"{err}")
            ms = [cs._time_ms(call) for _ in range(2)]
            print(f"[pullvar] {label} {code} {VARIANTS[code]}: "
                  + " ".join(f"{t:.4f}" for t in ms) + " ms, max_abs_err 0")
        print(f"[pullvar] {label} port kernel again: "
              f"{cs._time_ms(port):.4f} ms")
    print(f"[pullvar] {smi}")


if __name__ == "__main__":
    main()
