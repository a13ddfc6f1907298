"""End-to-end smoke test of unires_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines:

1. Device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions. No CUDA -> the script raises and prints no result.
2. Build: nvcc builds the kernels of ``unires_torch/csrc/`` from the
   checkout's sources.
3. Kernels vs plain: the pull and push kernels against their plain PyTorch
   versions on the same CUDA tensors, at the shapes of the bench workload
   (1 mm 181x217x181 recon grid, one 4 mm observation, a ~1 degree / 1 mm
   pose); adjointness through the kernels; median times (CUDA events).
4. The slice: a small 2-channel problem fitted on the card and on the CPU
   (plain versions), objective traces compared; then a 3-channel
   181x217x181 brain phantom degraded to 4 mm slices, reconstructed by
   ``unires_torch.init`` + the fit that ``unires_torch.fit`` runs, with the
   kernel launch counters reset just before and read just after.

The line before the last holds the kernels' JSON record, the one before it
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failure raises: nothing is caught.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import unires_torch
from unires_torch.geometry import affine_diag, affine_matrix_classic
from unires_torch.models.forward import obs_dyn_args, proj_apply
from unires_torch.models.proj_op import proj_info
from unires_torch.ops import cuda_build
from unires_torch.ops.resample import (affine_to_M, pull, pull_plain, push,
                                       push_plain)
from unires_torch.pipeline.fit import fit as fit_solver
from unires_torch.pipeline.run import write_data
from unires_torch.utils.phantoms import brain_phantom

DIM_Y = (181, 217, 181)
KERNEL_TOL = 1e-5  # max abs error <= KERNEL_TOL * max|input| (f32 rounding)
ADJOINT_TOL = 1e-5  # relative <pull u, v> - <u, push v>
SLICE_TOL = 1e-4  # card vs CPU objective traces, relative (f32 sums)
SOURCE = "unires_torch/csrc/resample.cu"
REPLACES = {"pull": "unires_tpu/ops/pallas_resample.py:423",
            "push": "unires_tpu/ops/pallas_resample.py:782"}


def require(ok, msg):
    """A failed check raises (``assert`` would vanish under ``python -O``)."""
    if not ok:
        raise RuntimeError(msg)


def _run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs a GPU")
    smi = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    nvcc = _run([cuda_build.nvcc_path(), "--version"]).splitlines()[-1]
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")
    print(f"[device] python {sys.version.split()[0]} | torch "
          f"{torch.__version__} | CUDA {torch.version.cuda} | nvcc: {nvcc}")
    return smi


def phase_build():
    cuda_build.kernels.get()
    print(f"[build] {cuda_build.library_path().name} in "
          f"{cuda_build.kernels.build_seconds:.2f} s")


def _time_ms(fn, reps=7):
    """Median of ``reps`` CUDA-event timings of fn() (after one warm-up)."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _max_err(got, want, scale, name):
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(err <= KERNEL_TOL * scale,
            f"{name}: max abs err {err} > {KERNEL_TOL} * {scale}")
    return err


def phase_kernels(device="cuda"):
    """Each kernel against its plain version at the main path's shapes."""
    rng = np.random.default_rng(0)
    dim_x = (DIM_Y[0], DIM_Y[1], int(np.ceil(DIM_Y[2] / 4.0)))
    rigid = affine_matrix_classic([1.0, -0.7, 0.6, 0.017, -0.012, 0.01])
    po = proj_info(DIM_Y, np.eye(4), dim_x, affine_diag([1.0, 1.0, 4.0]),
                   rigid=rigid, prof_ip=2, prof_tp=0)
    M, Minv = obs_dyn_args(po, "super-resolution")
    # the init reslice map: recon voxel -> observation voxel
    M_init = affine_to_M(np.linalg.solve(po.mat_x, po.mat_y))
    vol_y = torch.from_numpy(rng.random(DIM_Y, dtype=np.float32)).to(device)
    vol_x = torch.from_numpy(rng.random(dim_x, dtype=np.float32)).to(device)
    vals = torch.from_numpy(rng.random(po.dim_yx, dtype=np.float32)).to(device)
    print(f"[kernels] dim_y {DIM_Y} dim_yx {po.dim_yx} dim_x {dim_x}")

    rec = {}
    cases = [
        ("pull", "fit", lambda: pull(vol_y, M, po.dim_yx),
         lambda: pull_plain(vol_y, M, po.dim_yx), vol_y),
        ("pull", "init", lambda: pull(vol_x, M_init, DIM_Y),
         lambda: pull_plain(vol_x, M_init, DIM_Y), vol_x),
        ("pull", "order0", lambda: pull(vol_y, M, po.dim_yx, order=0),
         lambda: pull_plain(vol_y, M, po.dim_yx, order=0), vol_y),
        ("push", "fit", lambda: push(vals, M, DIM_Y, Minv=Minv),
         lambda: push_plain(vals, M, DIM_Y, Minv=Minv), vals),
        ("push", "order0", lambda: push(vals, M, DIM_Y, order=0, Minv=Minv),
         lambda: push_plain(vals, M, DIM_Y, order=0, Minv=Minv), vals),
    ]
    for name, case, kern, plain, inp in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = _max_err(got, want, float(inp.abs().max()), f"{name}/{case}")
        ms, plain_ms = _time_ms(kern), _time_ms(plain)
        print(f"[kernels] {name}/{case}: max_abs_err {err:.3e} | kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms")
        if case == "fit":
            rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # adjointness through the kernels: <pull u, v> = <u, push v>
    lhs = float((pull(vol_y, M, po.dim_yx).double() * vals.double()).sum())
    rhs = float((vol_y.double() * push(vals, M, DIM_Y, Minv=Minv).double())
                .sum())
    rel = abs(lhs - rhs) / abs(lhs)
    print(f"[kernels] adjoint <pull u, v> {lhs:.10e} <u, push v> {rhs:.10e} "
          f"rel {rel:.3e}")
    require(rel <= ADJOINT_TOL, f"adjointness rel {rel} > {ADJOINT_TOL}")
    return rec


def _degrade(gt, thick_axis, noise_sd, rng, device):
    """x = A gt + noise for a 4 mm acquisition (identity pose, no scaling)."""
    vx = [1.0, 1.0, 1.0]
    vx[thick_axis] = 4.0
    mat_x = affine_diag(vx)
    dim_x = list(gt.shape)
    dim_x[thick_axis] = int(np.ceil(gt.shape[thick_axis] / 4.0))
    po = proj_info(gt.shape, np.eye(4), tuple(dim_x), mat_x, prof_ip=2,
                   prof_tp=0)
    x = proj_apply("A", torch.from_numpy(gt).to(device), po,
                   "super-resolution").cpu().numpy()
    x = x + noise_sd * rng.standard_normal(x.shape).astype(np.float32)
    return [x.astype(np.float32), mat_x]


def _settings(device, max_iter, do_print):
    return unires_torch.Settings(
        device=device, do_coreg=False, unified_rigid=False, scaling=False,
        write_out=False, max_iter=max_iter, tolerance=0, do_print=do_print)


def phase_small_slice():
    """A small 2-channel fit on the card against the same fit on the CPU."""
    rng = np.random.default_rng(1)
    gt = brain_phantom(dim=(40, 48, 41), contrast="t1", seed=3)
    chans = [_degrade(gt, ax, 75.0, rng, "cpu") for ax in (2, 0)]
    traces = {}
    for dev in ("cuda", "cpu"):
        x, y, sett = unires_torch.init(chans, _settings(dev, 3, 0))
        _, _, _, obj, _ = fit_solver(x, y, sett)
        traces[dev] = obj[:, 0]
    rel = float(np.max(np.abs(traces["cuda"] - traces["cpu"])
                       / np.abs(traces["cpu"])))
    print(f"[slice-small] 2 x (40, 48, 41), 3 iterations: nll card "
          f"{traces['cuda'].tolist()} cpu {traces['cpu'].tolist()} rel {rel:.3e}")
    require(rel <= SLICE_TOL, f"card vs CPU objective rel {rel} > {SLICE_TOL}")


def phase_slice(device="cuda", dim=DIM_Y, max_iter=8):
    """init + fit of the 3-channel brain phantom on the card."""
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    gts = [brain_phantom(dim=dim, contrast=c, amplitude=2000.0, seed=0)
           for c in ("t1", "t2", "pd")]
    chans = [_degrade(gts[c], ax, 75.0, rng, device)
             for c, ax in enumerate((2, 1, 0))]
    print(f"[slice] phantom + degrade {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pull.launches = push.launches = 0
    t0 = time.perf_counter()
    x, y, sett = unires_torch.init(chans, _settings(device, max_iter, 1))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tri = y[0].dat.clone()  # the trilinear init reslice
    t0 = time.perf_counter()
    y, _, jtv, obj, n_iter = fit_solver(x, y, sett)
    dat_y, _, _, _ = write_data(x, y, sett, jtv=jtv)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = {"pull": pull.launches, "push": push.launches}
    peak = torch.cuda.max_memory_allocated()

    require(launches["pull"] > 0 and launches["push"] > 0,
            f"a kernel of the path never launched: {launches}")
    require(dat_y.shape == tuple(y[0].dim) + (3,), f"output {dat_y.shape}")
    require(bool(np.isfinite(dat_y).all() and np.isfinite(obj).all()
                 and torch.isfinite(jtv).all()), "non-finite output")
    require(n_iter == max_iter, f"n_iter {n_iter} != {max_iter}")
    require(obj[-1, 0] < obj[0, 0],
            f"objective did not fall: {obj[0, 0]} -> {obj[-1, 0]}")

    # quality of channel 0 against the phantom on the recon grid
    M = affine_to_M(np.linalg.solve(np.eye(4), y[0].mat))
    gt_on_y = pull(torch.from_numpy(gts[0]).to(device), M, y[0].dim)
    msk = gt_on_y > 0
    mse_tri = float(((tri - gt_on_y)[msk] ** 2).mean())
    mse = float(((y[0].dat - gt_on_y)[msk] ** 2).mean())
    psnr = 10.0 * np.log10(float(gt_on_y.max()) ** 2 / max(mse, 1e-12))
    print(f"[slice] dims {tuple(y[0].dim)} x 3 | init {t_init:.3f} s | fit "
          f"{t_fit:.3f} s, {t_fit / n_iter:.4f} s/iter, n_iter {n_iter} | "
          f"nll_first {obj[0, 0]:.6e} nll_last {obj[-1, 0]:.6e} | psnr "
          f"{psnr:.3f} dB | sr_vs_trilinear {mse / mse_tri:.4f} | peak mem "
          f"{peak / 2 ** 30:.3f} GiB | launches {launches}")
    return launches


def main():
    smi = phase_device()
    phase_build()
    rec = phase_kernels()
    phase_small_slice()
    launches = phase_slice()
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    **rec[name]) for name in ("pull", "push")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
