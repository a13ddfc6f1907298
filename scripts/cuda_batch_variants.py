"""Time other mappings of the batched pull, push and pull_grad launches
against the port's.

    python3 scripts/cuda_batch_variants.py [--reps 3]

Builds ``scripts/batch_launch_variants.cu`` (which includes the port's
``unires_torch/csrc/resample.cu``) with the port's nvcc flags into
``build/batchvar/``. At the fit's shapes of ``chip_smoke.py`` phase 3 (B =
3 volumes, each at its own map, as ``_measure_batch`` makes them) it runs
three unbatched launches, the port's batched launch (pull and pull_grad:
one volume's launch grid, each thread its output in every volume in turn;
push: the batch folded into the grid's z, the volumes fastest) and the
variants (``zfold``: the batch folded into the grid's z, the volumes
slowest; ``inter``: the volumes fastest; ``loop``: push in one volume's
launch grid, each thread over the volumes), requires every batched result
to equal the unbatched launches to the bit, and prints each one's device ms
(``chip_smoke._time_ms``: CUDA events around each call, L2 flushed before
it), ``reps`` times in turns.
"""
import argparse
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
from unires_torch.geometry import affine_diag, affine_matrix_classic  # noqa
from unires_torch.models.forward import obs_dyn_args  # noqa: E402
from unires_torch.models.proj_op import proj_info  # noqa: E402
from unires_torch.ops import cuda_build  # noqa: E402
from unires_torch.ops import resample as tr  # noqa: E402

SOURCE = HERE / "scripts" / "batch_launch_variants.cu"
LIB = HERE / "build" / "batchvar" / "libbatch_launch_variants.so"
# each kernel's variants of batch_launch_variants.cu, by index
VARIANTS = {"pull": ("zfold", "inter"), "push": ("zfold", "loop"),
            "pull_grad": ("zfold", "inter")}
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def build():
    LIB.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    subprocess.run([cuda_build.nvcc_path(), *cuda_build._FLAGS, "-o",
                    str(LIB), str(SOURCE)], check=True)
    lib = ctypes.CDLL(str(LIB))
    lib.variant_pull.argtypes = [_I, _VP, _VP, _VP] + [_I] * 8 + [_LL, _VP]
    lib.variant_push.argtypes = [_I, _VP, _VP, _VP] + [_I] * 8 + [_LL, _VP]
    lib.variant_pull_grad.argtypes = ([_I, _VP, _VP, _VP] + [_I] * 7
                                      + [_LL, _VP])
    print(f"[batchvar] built {SOURCE.name} in {time.perf_counter() - t0:.2f} s")
    return lib


def cases(B):
    """(name, the unbatched launches (a list of outputs), the port's
    batched launch, a variant's launch by index) at the fit's shapes."""
    rng = np.random.default_rng(7)
    pos = []
    for p in cs.BATCH_POSES[:B]:
        po = proj_info(cs.DIM_Y, np.eye(4), cs.fit_case()[0].dim_x,
                       affine_diag([1.0, 1.0, 4.0]),
                       rigid=affine_matrix_classic(p), prof_ip=2, prof_tp=0)
        pos.append(obs_dyn_args(po, "super-resolution"))
    Md = torch.from_numpy(np.stack([M for M, _ in pos])).cuda()
    Mi = torch.from_numpy(np.stack([m for _, m in pos])).cuda()
    dim_yx = tuple(po.dim_yx)
    vol = torch.from_numpy(rng.random((B,) + cs.DIM_Y,
                                      dtype=np.float32)).cuda()
    vals = torch.from_numpy(rng.random((B,) + dim_yx,
                                       dtype=np.float32)).cuda()
    plans = tr.push_plan(Md, Mi, 1, dim_yx, cs.DIM_Y)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    lib = build()

    def var_pull(v):
        out = torch.empty((B,) + dim_yx, device="cuda")
        tr.check(lib.variant_pull(v, vol.data_ptr(), out.data_ptr(),
                                  Md.data_ptr(), *cs.DIM_Y, *dim_yx, 1, B,
                                  vol.stride(0), stream()), "pull variant")
        return out

    def var_push(v):
        out = torch.empty((B,) + cs.DIM_Y, device="cuda")
        tr.check(lib.variant_push(v, vals.data_ptr(), out.data_ptr(),
                                  plans.data_ptr(), *dim_yx, *cs.DIM_Y, 1, B,
                                  vals.stride(0), stream()), "push variant")
        return out

    def var_grad(v):
        out = torch.empty((B,) + dim_yx + (3,), device="cuda")
        tr.check(lib.variant_pull_grad(v, vol.data_ptr(), out.data_ptr(),
                                       Md.data_ptr(), *cs.DIM_Y, *dim_yx, B,
                                       vol.stride(0), stream()),
                 "pull_grad variant")
        return out

    return [
        ("pull", lambda: [tr.pull(vol[b], Md[b], dim_yx) for b in range(B)],
         lambda: tr.pull(vol, Md, dim_yx), var_pull),
        ("push", lambda: [tr.push(vals[b], Md[b], cs.DIM_Y, Minv=plans[b])
                          for b in range(B)],
         lambda: tr.push(vals, Md, cs.DIM_Y, Minv=plans), var_push),
        ("pull_grad", lambda: [tr.pull_grad(vol[b], Md[b], dim_yx)
                               for b in range(B)],
         lambda: tr.pull_grad(vol, Md, dim_yx), var_grad),
    ]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(f"[batchvar] {cs.phase_device()}")
    B = cs.KERNEL_BATCH
    for name, unbatched, port, var in cases(B):
        want = torch.stack(unbatched())
        calls = {"unbatched": unbatched, "port": port}
        calls.update({v: (lambda i=i: var(i))
                      for i, v in enumerate(VARIANTS[name])})
        for label, fn in calls.items():
            got = fn()
            got = torch.stack(got) if isinstance(got, list) else got
            torch.cuda.synchronize()
            cs.require(torch.equal(got, want),
                       f"{name} {label}: differs from the unbatched launches")
        for r in range(args.reps):
            ms = {label: cs._time_ms(fn) for label, fn in calls.items()}
            print(f"[batchvar] {name} B={B} round {r}: " + " | ".join(
                f"{k} {v:.4f} ms ({v / ms['unbatched']:.3f})"
                for k, v in ms.items()))


if __name__ == "__main__":
    main()
