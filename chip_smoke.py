"""End-to-end smoke test of unires_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its lines:

1. Device: the card's name and power limit (nvidia-smi), torch, CUDA and
   nvcc versions. No CUDA -> the script raises and prints no result.
2. Build: nvcc builds the kernels of ``unires_torch/csrc/`` from the
   checkout's sources.
3. Kernels vs plain: the pull, push and pull_grad kernels against their
   plain PyTorch versions on the same CUDA tensors, at the shapes of the
   bench workload (1 mm 181x217x181 recon grid, one 4 mm observation, a
   ~1 degree / 1 mm pose; pull_grad also on a 1 mm co-registration level);
   adjointness through the kernels; median times (CUDA events) and GB/s.
4. Small slices, each fitted on the card and on the CPU (plain versions)
   with the objective traces compared: a pre-aligned 2-channel problem, and
   a misaligned one with co-registration, unified rigid and even/odd
   scaling (coreg run on both devices and compared on its own; the two fits
   start from the same co-registered init).
5. Full width: the 3-channel 181x217x181 brain phantom degraded to 4 mm
   slices, first pre-aligned (init + fit, no GN updates), then as
   ``bench.py`` builds it (per-channel rigid misalignment, even/odd scaling
   0.1) through ``unires_torch.init`` (NMI co-registration) + fit with
   unified rigid and scaling. Kernel launch counters are reset just before
   each run and read just after it. Prints init / coreg seconds, s/iter,
   PSNR and sr_vs_trilinear (as bench.py), each channel's residual pose
   error against the simulated rigids before and after coreg and after the
   fit, the fitted scales, launches, host syncs per iteration, peak memory.

The line before the last holds the kernels' JSON record (launches from the
misaligned run), the one before it the card's name and power limit; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises: nothing
is caught.
"""
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import unires_torch
import unires_torch.pipeline.run as run_mod
from unires_torch.geometry import (affine_basis, affine_diag,
                                   affine_matrix_classic, expm, rigid_log)
from unires_torch.models.forward import obs_dyn_args, proj_apply
from unires_torch.models.proj_op import proj_info
from unires_torch.ops import cuda_build
from unires_torch.ops.resample import (affine_to_M, pull, pull_grad,
                                       pull_grad_plain, pull_plain, push,
                                       push_plain)
from unires_torch.pipeline.convert import convert_state
from unires_torch.pipeline.fit import fit as fit_solver
from unires_torch.pipeline.run import write_data
from unires_torch.utils.host import to_host
from unires_torch.utils.phantoms import brain_phantom

DIM_Y = (181, 217, 181)
KERNEL_TOL = 1e-5  # max abs error <= KERNEL_TOL * max|input| (f32 rounding)
ADJOINT_TOL = 1e-5  # relative <pull u, v> - <u, push v>
SLICE_TOL = 1e-4  # card vs CPU objective traces, relative (f32 sums)
# card vs CPU with rigid and scaling on: the GN updates feed back into the
# fit, so float32 differences of the sums grow over the iterations
GN_SLICE_TOL = 1e-3
COREG_TOL = (0.1, 2e-3)  # card vs CPU coreg mats: mm, rotation entries
SMALL_DIM = (48, 56, 48)  # centre crop of the phantom for the small GN slice
SOURCE = "unires_torch/csrc/resample.cu"
# the Pallas kernels each CUDA kernel replaces (shear variant first; the
# JAX fit runs it): pull also :219, push also :673, pull_grad also :328
REPLACES = {"pull": "unires_tpu/ops/pallas_resample.py:423",
            "push": "unires_tpu/ops/pallas_resample.py:782",
            "pull_grad": "unires_tpu/ops/pallas_resample.py:547"}


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
    # a co-registration map between two 1 mm iso levels of the bench images
    M_coreg = affine_to_M(affine_matrix_classic(
        [0.8, -1.1, 0.5, 0.012, -0.015, 0.009]))
    vol_y = torch.from_numpy(rng.random(DIM_Y, dtype=np.float32)).to(device)
    vol_x = torch.from_numpy(rng.random(dim_x, dtype=np.float32)).to(device)
    vals = torch.from_numpy(rng.random(po.dim_yx, dtype=np.float32)).to(device)
    print(f"[kernels] dim_y {DIM_Y} dim_yx {po.dim_yx} dim_x {dim_x}")

    rec = {}
    cases = [
        ("pull", "fit", lambda: pull(vol_y, M, po.dim_yx),
         lambda: pull_plain(vol_y, M, po.dim_yx), vol_y, po.dim_yx),
        ("pull", "init", lambda: pull(vol_x, M_init, DIM_Y),
         lambda: pull_plain(vol_x, M_init, DIM_Y), vol_x, DIM_Y),
        ("pull", "order0", lambda: pull(vol_y, M, po.dim_yx, order=0),
         lambda: pull_plain(vol_y, M, po.dim_yx, order=0), vol_y, po.dim_yx),
        ("push", "fit", lambda: push(vals, M, DIM_Y, Minv=Minv),
         lambda: push_plain(vals, M, DIM_Y, Minv=Minv), vals, DIM_Y),
        ("push", "order0", lambda: push(vals, M, DIM_Y, order=0, Minv=Minv),
         lambda: push_plain(vals, M, DIM_Y, order=0, Minv=Minv), vals, DIM_Y),
        ("pull_grad", "fit", lambda: pull_grad(vol_y, M, po.dim_yx),
         lambda: pull_grad_plain(vol_y, M, po.dim_yx), vol_y,
         po.dim_yx + (3,)),
        ("pull_grad", "coreg", lambda: pull_grad(vol_y, M_coreg, DIM_Y),
         lambda: pull_grad_plain(vol_y, M_coreg, DIM_Y), vol_y, DIM_Y + (3,)),
    ]
    for name, case, kern, plain, inp, out_dim in cases:
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = _max_err(got, want, float(inp.abs().max()), f"{name}/{case}")
        ms, plain_ms = _time_ms(kern), _time_ms(plain)
        # bytes: the input volume once and the output once (bench.py:169)
        gbps = 4.0 * (inp.numel() + np.prod(out_dim)) / (ms * 1e-3) / 1e9
        print(f"[kernels] {name}/{case}: max_abs_err {err:.3e} | kernel "
              f"{ms:.4f} ms | plain {plain_ms:.4f} ms | {gbps:.1f} GB/s")
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


def _degrade(gt, thick_axis, noise_sd, rng, device, rigid=None, scl=0.0):
    """x = A gt + noise for a 4 mm acquisition at pose ``rigid`` with
    even/odd scaling ``scl`` (the simulation of bench.py:78-91)."""
    vx = [1.0, 1.0, 1.0]
    vx[thick_axis] = 4.0
    mat_x = affine_diag(vx)
    dim_x = list(gt.shape)
    dim_x[thick_axis] = int(np.ceil(gt.shape[thick_axis] / 4.0))
    po = proj_info(gt.shape, np.eye(4), tuple(dim_x), mat_x, rigid=rigid,
                   prof_ip=2, prof_tp=0, scl=scl)
    x = proj_apply("A", torch.from_numpy(gt).to(device), po,
                   "super-resolution").cpu().numpy()
    x = x + noise_sd * rng.standard_normal(x.shape).astype(np.float32)
    return [x.astype(np.float32), mat_x]


def _draw_rigids(rng, n):
    """Per-channel rigid misalignment as bench.py:70-75: +-2 mm / +-0.02 rad,
    projected to zero Lie-mean."""
    basis = affine_basis("SE")
    rps = [rng.uniform(-2, 2, 3).tolist() + rng.uniform(-0.02, 0.02, 3).tolist()
           for _ in range(n)]
    logs = [rigid_log(affine_matrix_classic(rp), basis) for rp in rps]
    qm = np.mean(logs, axis=0)
    return [expm(lg - qm, basis) for lg in logs]


def _settings(device, max_iter, do_print, gn=False):
    return unires_torch.Settings(
        device=device, do_coreg=gn, unified_rigid=gn, scaling=gn,
        write_out=False, max_iter=max_iter, tolerance=0, do_print=do_print)


def _rel_trace(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


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
    rel = _rel_trace(traces["cuda"], traces["cpu"])
    print(f"[slice-small] 2 x (40, 48, 41), 3 iterations: nll card "
          f"{traces['cuda'].tolist()} cpu {traces['cpu'].tolist()} rel {rel:.3e}")
    require(rel <= SLICE_TOL, f"card vs CPU objective rel {rel} > {SLICE_TOL}")


def phase_small_misaligned():
    """Coreg + rigid + scaling on a small misaligned problem, card vs CPU."""
    rng = np.random.default_rng(2)
    gt = _phantom("t1", SMALL_DIM)
    rigids = _draw_rigids(rng, 2)
    chans = [_degrade(gt, ax, 75.0, rng, "cpu", rigid=r, scl=0.1)
             for ax, r in zip((2, 0), rigids)]
    inits = {dev: unires_torch.init(chans, _settings(dev, 4, 0, gn=True))
             for dev in ("cuda", "cpu")}
    mats = {dev: np.asarray(inits[dev][2].mat_coreg) for dev in inits}
    dt = float(np.abs(mats["cuda"][:, :3, 3] - mats["cpu"][:, :3, 3]).max())
    dr = float(np.abs(mats["cuda"][:, :3, :3] - mats["cpu"][:, :3, :3]).max())
    print(f"[slice-small-gn] coreg card vs cpu: translation {dt:.3e} mm, "
          f"rotation entries {dr:.3e}")
    require(dt <= COREG_TOL[0] and dr <= COREG_TOL[1],
            f"card vs CPU coreg differ: {dt} mm, {dr}")
    # both fits from the CPU's co-registered init
    x, y, sett = inits["cpu"]
    xg, yg, sg = convert_state(x, y, sett, "cuda")
    n0 = pull_grad.launches
    _, _, _, obj_g, _ = fit_solver(xg, yg, sg)
    require(pull_grad.launches > n0, "the card's rigid update ran no pull_grad")
    _, _, _, obj_c, _ = fit_solver(x, y, sett)
    rel = _rel_trace(obj_g[:, 0], obj_c[:, 0])
    qg = np.stack([o.rigid_q for xc in xg for o in xc])
    qc = np.stack([o.rigid_q for xc in x for o in xc])
    sg_ = [o.po.scl for xc in xg for o in xc]
    sc_ = [o.po.scl for xc in x for o in xc]
    print(f"[slice-small-gn] 2 x {SMALL_DIM}, 4 iterations: nll card "
          f"{obj_g[:, 0].tolist()} cpu {obj_c[:, 0].tolist()} rel {rel:.3e} | "
          f"max |dq| {float(np.abs(qg - qc).max()):.3e} | scl card {sg_} "
          f"cpu {sc_}")
    require(rel <= GN_SLICE_TOL,
            f"card vs CPU objective rel {rel} > {GN_SLICE_TOL}")


def _quality(y, gt, tri, device):
    """PSNR and sr_vs_trilinear of channel 0 (bench.py:102-110, 175-193)."""
    M = affine_to_M(np.linalg.solve(np.eye(4), y[0].mat))
    gt_on_y = pull(torch.from_numpy(gt).to(device), M, y[0].dim)
    msk = gt_on_y > 0
    mse_tri = float(((tri - gt_on_y)[msk] ** 2).mean())
    mse = float(((y[0].dat - gt_on_y)[msk] ** 2).mean())
    psnr = 10.0 * np.log10(float(gt_on_y.max()) ** 2 / max(mse, 1e-12))
    return psnr, mse / mse_tri


def _check_fit(dat_y, y, obj, jtv, n_iter, max_iter):
    require(dat_y.shape == tuple(y[0].dim) + (3,), f"output {dat_y.shape}")
    require(bool(np.isfinite(dat_y).all() and np.isfinite(obj).all()
                 and torch.isfinite(jtv).all()), "non-finite output")
    require(n_iter == max_iter, f"n_iter {n_iter} != {max_iter}")
    require(obj[-1, 0] < obj[0, 0],
            f"objective did not fall: {obj[0, 0]} -> {obj[-1, 0]}")


def _phantom(contrast, dim):
    """The bench's 181x217x181 brain phantom, or its centre crop of ``dim``
    (the phantom lives in an MNI-like frame: a smaller grid of its own would
    hold only a corner of the head)."""
    vol = brain_phantom(dim=DIM_Y, contrast=contrast, amplitude=2000.0, seed=0)
    lo = [(n - d) // 2 for n, d in zip(DIM_Y, dim)]
    return np.ascontiguousarray(
        vol[tuple(slice(a, a + d) for a, d in zip(lo, dim))])


def _bench_workload(device, dim, misaligned):
    """The 3-channel brain phantom of bench.py:40-91 (rigids and scaling
    only when ``misaligned``), with its ground truths and rigids."""
    rng = np.random.default_rng(0)
    gts = [_phantom(c, dim) for c in ("t1", "t2", "pd")]
    rigids = _draw_rigids(rng, 3) if misaligned else [np.eye(4)] * 3
    scl = 0.1 if misaligned else 0.0
    chans = [_degrade(gts[c], ax, 75.0, rng, device, rigid=rigids[c], scl=scl)
             for c, ax in enumerate((2, 1, 0))]
    return gts, rigids, chans


def phase_slice(device="cuda", dim=DIM_Y, max_iter=8):
    """init + fit of the pre-aligned 3-channel brain phantom on the card."""
    t0 = time.perf_counter()
    gts, _, chans = _bench_workload(device, dim, misaligned=False)
    print(f"[slice] phantom + degrade {time.perf_counter() - t0:.2f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pull.launches = push.launches = pull_grad.launches = 0
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
    launches = {"pull": pull.launches, "push": push.launches,
                "pull_grad": pull_grad.launches}
    peak = torch.cuda.max_memory_allocated()

    require(launches["pull"] > 0 and launches["push"] > 0,
            f"a kernel of the path never launched: {launches}")
    _check_fit(dat_y, y, obj, jtv, n_iter, max_iter)
    psnr, ratio = _quality(y, gts[0], tri, device)
    print(f"[slice] dims {tuple(y[0].dim)} x 3 | init {t_init:.3f} s | fit "
          f"{t_fit:.3f} s, {t_fit / n_iter:.4f} s/iter, n_iter {n_iter} | "
          f"nll_first {obj[0, 0]:.6e} nll_last {obj[-1, 0]:.6e} | psnr "
          f"{psnr:.3f} dB | sr_vs_trilinear {ratio:.4f} | peak mem "
          f"{peak / 2 ** 30:.3f} GiB | launches {launches}")


def _pose_error(E, dim):
    """(rotation angle rad, max displacement mm over the FOV corners) of
    E - I for a 1 mm grid of ``dim`` at the world origin."""
    ang = float(np.arccos(np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1, 1)))
    corners = np.array([[i, j, k, 1.0] for i in (0, dim[0] - 1)
                        for j in (0, dim[1] - 1) for k in (0, dim[2] - 1)])
    disp = np.linalg.norm(((E - np.eye(4)) @ corners.T)[:3], axis=0)
    return ang, float(disp.max())


def phase_misaligned(device="cuda", dim=DIM_Y, max_iter=8):
    """The bench.py workload: coreg + unified rigid + scaling at full width."""
    t0 = time.perf_counter()
    gts, rigids, chans = _bench_workload(device, dim, misaligned=True)
    print(f"[bench] phantom + degrade {time.perf_counter() - t0:.2f} s")

    coreg = {}
    affine_align = run_mod.affine_align

    def timed_align(*args, **kw):  # coreg's seconds and pull_grad launches
        n0, c0 = pull_grad.launches, time.perf_counter()
        out = affine_align(*args, **kw)
        torch.cuda.synchronize()
        coreg.update(s=time.perf_counter() - c0,
                     pull_grad=pull_grad.launches - n0)
        return out

    run_mod.affine_align = timed_align
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pull.launches = push.launches = pull_grad.launches = 0
    t0 = time.perf_counter()
    x, y, sett = unires_torch.init(chans, unires_torch.Settings(
        device=device, vx=1.0, do_print=1, write_out=False, tolerance=0,
        max_iter=max_iter, sched_num=3, reg_scl=4.0, do_coreg=True,
        unified_rigid=True, scaling=True))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    run_mod.affine_align = affine_align
    peak_init = torch.cuda.max_memory_allocated()
    tri = y[0].dat.clone()
    mat_a = np.asarray(sett.mat_coreg)
    n_grad0, syncs0 = pull_grad.launches, to_host.syncs
    t0 = time.perf_counter()
    y, R, jtv, obj, n_iter = fit_solver(x, y, sett)
    dat_y, _, _, _ = write_data(x, y, sett, jtv=jtv)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    launches = {"pull": pull.launches, "push": push.launches,
                "pull_grad": pull_grad.launches}
    syncs = (to_host.syncs - syncs0) / max(n_iter, 1)
    peak = torch.cuda.max_memory_allocated()

    require(coreg["pull_grad"] > 0, "coreg launched no pull_grad")
    require(launches["pull_grad"] - n_grad0 > 0,
            "the rigid update launched no pull_grad")
    require(launches["pull"] > 0 and launches["push"] > 0,
            f"a kernel of the path never launched: {launches}")
    _check_fit(dat_y, y, obj, jtv, n_iter, max_iter)
    psnr, ratio = _quality(y, gts[0], tri, device)
    scl = [o.po.scl for xc in x for o in xc]
    require(all(np.isfinite(R).ravel()) and all(np.isfinite(scl)),
            "non-finite pose or scale")
    print(f"[bench] dims {tuple(y[0].dim)} x 3 | init {t_init:.3f} s "
          f"(coreg {coreg['s']:.3f} s, {coreg['pull_grad']} pull_grad) | fit "
          f"{t_fit:.3f} s, {t_fit / n_iter:.4f} s/iter, n_iter {n_iter} | "
          f"nll {obj[:, 0].tolist()} | psnr {psnr:.3f} dB | "
          f"sr_vs_trilinear {ratio:.4f} | peak mem init "
          f"{peak_init / 2 ** 30:.3f} GiB, all {peak / 2 ** 30:.3f} GiB | "
          f"host syncs/iter {syncs:.1f} | launches {launches}")
    print(f"[bench] fitted scl {scl} (simulated 0.1)")
    for c in range(3):
        inv_true = np.linalg.inv(rigids[c])
        before = _pose_error(inv_true, dim)
        after_coreg = _pose_error(inv_true @ np.linalg.inv(mat_a[c]), dim)
        after_fit = _pose_error(inv_true @ R[c] @ np.linalg.inv(mat_a[c]), dim)
        print(f"[bench] channel {c} pose error (rad, max mm): before "
              f"{before[0]:.5f}, {before[1]:.3f} | after coreg "
              f"{after_coreg[0]:.5f}, {after_coreg[1]:.3f} | after fit "
              f"{after_fit[0]:.5f}, {after_fit[1]:.3f}")
        require(after_coreg[1] < before[1],
                f"coreg did not reduce channel {c}'s misalignment")
    return launches


def main():
    smi = phase_device()
    phase_build()
    rec = phase_kernels()
    phase_small_slice()
    phase_small_misaligned()
    phase_slice()
    launches = phase_misaligned()
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    **rec[name]) for name in ("pull", "push", "pull_grad")]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
