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
   ~1 degree / 1 mm pose; pull also as the init reslice, at order 0 and on
   a 45 degree x 3 map; pull_grad also on a 1 mm co-registration level, on
   the 45 degree x 3 map and on the 2 mm level of an atlas alignment);
   every kernel must equal its plain version bitwise, with its map read
   from device memory (a CUDA tensor; push's plan computed on the card by
   ``push_plan``), as the fit chunk launches it. Per case: device
   ms (each call timed alone, L2 flushed before it) and host ms per call,
   GB/s, the bound (bytes or float32 operations at the H100's peak rates)
   and the kernel's share of it, and the one PyTorch call that computes
   the same function (``grid_sample``, ``grid_sampler_3d_backward``)
   checked against the plain version, with its ms and the kernel / library
   ratio; adjointness through the kernels. Then the kernels' ``fov``
   override (their FOV = true instantiation): pull and push at the fit's
   map with bounds narrower and wider than the volume, and at the maps and
   bounds of the one-slab spatial steps (the extended slab with its halo of
   zero rows at each end), each bitwise equal to its plain version.
   Then each kernel's batched launch: B = 3 volumes at the fit's shapes,
   each at its own map (push: its own plan), in one launch, against three
   unbatched launches and against the plain version (both bitwise), with
   its device ms beside that of the three unbatched launches, its bound
   (three volumes) and the library call with N = 3. Then the
   finite-difference stencils (``ops/finite_diff.py``: gradient, divergence
   and the membrane D^T D, scaled as the ADMM body scales them) at the
   fit's recon grids (190x232x189 of ``brainweb_sr3``, 192x256x192 of
   ``brainweb_common``) and as B = 2 strided channel views at the first,
   each bitwise equal to the plain zero-fill chain on the card, with its
   device ms, the plain chain's, and its bound (input read once, output
   written once at 3.35 TB/s). Then the slice-profile blur
   (``ops/conv.py``: ``blur_down_sep`` and its adjoint ``blur_up_sep``, one
   launch a pass that is not a dirac axis) at the observations' upsampled
   grids of ``brainweb_sr3`` (ratio (1, 1, 4)) and ``brainweb_common``
   (ratio (2, 2, 5) after the atlas alignment, each thick axis) and as a
   B = 2 batch at the first, each bitwise equal to the plain per-axis chain
   on the card, with its device ms, the plain chain's, the library call's
   (``conv3d`` / ``conv_transpose3d`` with a (K, 1, 1) kernel at stride
   (r, 1, 1) a pass, TF32 off, held to the plain chain to 1e-5 of scale)
   and its bound (each pass's input read once and output written once at
   3.35 TB/s). Then the rigid GN statistics (``ops/gn_stats.py``:
   ``gn_moments``, the 72 float64 moments of G and W) at the observations'
   grids of ``brainweb_sr3`` (dim_yx), ``brainweb_common`` (each thick
   axis), ``brainweb_denoise3`` (dim_x, no C^T C) and as a B = 2 batch at
   the first: every moment within ``GN_TOL`` of the plain chain's,
   relative to its sum of |terms|, a rerun equal to the bit, two launches;
   its device ms beside the plain chain's and its bound (gradient,
   residual and C^T C read once at 3.35 TB/s).
4. Small slices, each fitted on the card and on the CPU (plain versions)
   with the objective traces compared: a pre-aligned 2-channel problem, and
   a misaligned one with co-registration, unified rigid and even/odd
   scaling (coreg run on both devices and compared on its own; the two fits
   start from the same co-registered init).
5. Full width: the 3-channel 181x217x181 brain phantom degraded to 4 mm
   slices, first pre-aligned (init + fit, no GN updates), then as
   ``bench.py`` builds it (per-channel rigid misalignment, even/odd scaling
   0.1) through ``unires_torch.init`` (NMI co-registration) + fit with
   unified rigid and scaling. Kernel launch counters (the stencils', the
   blur's and the GN statistics' too; each must be > 0 after the misaligned
   fit) are
   reset just before each run and read just after it (the kernels count
   their own launches on the device, those of a graph's replays included). Prints init / coreg
   seconds, s/iter, PSNR and sr_vs_trilinear (as bench.py), each channel's
   residual pose error against the simulated rigids before and after coreg
   and after the fit, the fitted scales, launches, host syncs per
   iteration, peak memory of init and of the whole, each beside the
   figures of the host-driven loop the chunk replaced; requires init's peak <= 3.5 GiB and at most 0.25 host syncs
   per iteration (the fit runs in chunks of 16 iterations, each one CUDA
   graph replayed with conditional nodes and read once). Co-registration
   runs each pyramid level as one CUDA graph (a WHILE node over the NMI
   descent, an IF node per mover's evaluation) read once: one line per
   level (voxel size, grid, movers, evaluations per mover, WHILE turns,
   seconds of warm-up + capture and of replay + read, graph nodes, host
   syncs), coreg's seconds and host syncs beside the host-driven descent's;
   requires at most 2 host syncs per level. The inputs, the init and the
   first 8 objective values are held against the JAX package's own float32
   run of this workload on the CPU (``JAX_REFERENCE``, ``jax_diffs``): the
   inputs' sums and sums of squares, tau, the coreg translations and
   rotation entries, the recon grid, mse_trilinear, each difference on a
   line of its own, each within ``JAX_TOL``. Then (5b) the
   same 8 iterations from a copy of the same init, uncaptured on the card
   (every decision read on the host): the traces and the poses must equal
   the captured run's; both runs' host syncs per iteration and s/iter.
   (5c) The same coreg from copies of the same inputs, uncaptured: its
   mat_a must equal the captured run's digit for digit; both times.
6. Init options at full width: the same misaligned phantom placed in the
   atlas frame and displaced by a known rigid transform, through
   ``unires_torch.init`` with ``common_output`` (co-registration, atlas
   alignment, crop to the atlas box, pow 256) and a label on channel 0,
   then 4 fit iterations. Counters reset before and read after. Atlas
   alignment (CSO) prints its levels as phase 5's coreg, with the same
   bound on host syncs. Requires the atlas transform recovered, the output grid equal to the atlas box's,
   a finite falling objective and a label volume on the output grid with
   the input's values. Then a small CT-flagged observation with a label
   through ``do_res_origin`` and ``force_inplane_res``, card against CPU.
7. The command line on the card: two NIfTI files in a temporary directory
   through ``unires_torch.cli.run([... "--common_output"])``, the outputs
   read back and checked for shape and affine.
8. What a long or many-subject run needs, at full width on the misaligned
   workload: (a) a fit of 8 iterations, the same cut after 4 with a
   checkpoint every 2, and its resume from the file to 8, all from copies
   of one init, the resumed run held against the uninterrupted one;
   (b) 2 iterations under ``profile_dir``: the trace must name the
   hand-written kernels; (c) two subjects (two noise and pose seeds of the
   phantom, the second on the first's grid) through ``fit_batch``, held
   against single fits from copies of the same inits, with the counters
   reset before the batch and read after it: the two subjects are one
   stacked chunk, one captured graph read once per chunk, each kernel
   launched once for both subjects (the batch's launches must be 0.9-1.4x
   one subject's alone); prints the batch's seconds beside the single
   fits', its warm-up + capture seconds, graph nodes, host syncs and peak
   memory; then ``--shard`` with ``--common_output`` on two subjects of
   two 2 mm channels each. (d) Four subjects (seeds 0-3, one grid) x 4
   iterations in one batch, uncaptured and captured: the captured traces
   must equal the uncaptured ones digit for digit and each subject its
   single fit within the batch tolerance; prints seconds, peak memory and
   seconds per subject iteration. In (b) the trace must hold as many pull
   and push kernel events as the kernels counted launches: the replays of
   the graph are traced kernel by kernel.

9. Converged quality: the misaligned ``bench.py`` workload fitted to its
   tolerance of 1e-4 (coreg, unified rigid, scaling, ``sched_num=3``,
   ``reg_scl=4.0``), held against the JAX package's converged float32 run
   (``JAX_REFERENCE``) within ``JAX_TOL``, each difference on a line of
   its own: phase 5's figures, then n_iter, PSNR, sr_vs_trilinear, the
   fitted rigid_q and scales, the objective before the first lambda step
   of either run, the steps' iterations and the last objective; requires
   PSNR >= 25.6 dB and sr_vs_trilinear <= 0.50; prints n_iter, PSNR, the
   ratio, s/iter and host syncs per iteration beside the host-driven
   loop's (100, 25.782 dB, 0.4817; it read the host every iteration).
10. The multi-device solvers on the one card, at full width: the
   pre-aligned phantom, every channel thick along z, through
   ``init_multihost`` on NCCL with a world of 1: (a) the (batch, channel)
   sharded step (B = 1, C = 3) and (b) the one-slab denoising and
   super-resolution spatial steps (no message; the extended slab's zero
   rows put the kernels' FOV bounds to work), 3 iterations each (CG 60 /
   1e-6; the denoising step, on observations at a shifted and rotated
   pose, is printed at that depth and held at 200 / 1e-8), against
   ``make_admm_step`` on the card. The counters are set to 0 just before
   each spatial step's iterations and read just after: each step must
   launch pull and push, every launch through FOV = true; the SR step must
   launch both blur passes, the denoising step none.

The line before the last holds the kernels' JSON record (``launches`` from
the misaligned run, ``launches_coreg`` the part of them inside its
co-registration, ``launches_atlas`` from phase 6, ``launches_batch`` from
phase 8's ``fit_batch``, ``launches_converged`` from phase 9,
``launches_parallel`` and ``launches_parallel_fov`` (the FOV = true ones)
summed over phase 10's two spatial steps; ``fov`` the FOV = true cases of
phase 3; ``batch_ms`` and ``unbatched_x3_ms`` phase 3's batched launch of
three volumes and the three unbatched launches, ``batch_bound_ms`` and
``batch_library_ms`` its bound and its library call with N = 3) and the
stencils' record (phase 3's cases by ``entry/case``, each with its entry's
``launches`` in the misaligned run and ``launches_converged`` in phase 9,
both required > 0) and the blur's record (phase 3's cases by
``direction/case``, each with its ``passes`` there and its direction's
``launches`` in the misaligned run and ``launches_converged`` in phase 9,
both required > 0) and the GN statistics' record (phase 3's cases, each
with the kernel's ``launches`` in the misaligned run and
``launches_converged`` in phase 9, both required > 0), the one
before it the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``. Any failure raises: nothing is
caught.
"""
import copy
import functools
import glob
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

import unires_torch
import unires_torch.pipeline.run as run_mod
from unires_torch.cli import run as cli_run
from unires_torch.geometry import (affine_basis, affine_diag,
                                   affine_matrix_classic, bb_atlas, ceil_pow,
                                   expm, rigid_log, voxel_size)
from unires_torch.models.forward import obs_dyn_args, proj_apply
from unires_torch.models.proj_op import proj_info
from unires_torch.kernels import kernel_1d
from unires_torch.ops import conv, cuda_build, gn_stats
from unires_torch.ops import finite_diff as fd
from unires_torch.ops.resample import (_as_map, _fov_mask, _sample_coords,
                                       affine_to_M, pull, pull_grad,
                                       pull_grad_plain, pull_plain, push,
                                       push_plain, push_plan, push_window)
from unires_torch.parallel.spatial import (slab_maps, spatial_halo_bound,
                                           sr_halo_bounds)
from unires_torch.pipeline.convert import convert_state
from unires_torch.pipeline.fit import fit as fit_solver
from unires_torch.pipeline.nifti import load as nifti_load
from unires_torch.pipeline.nifti import save as nifti_save
from unires_torch.pipeline.run import write_data
from unires_torch.utils import trace
from unires_torch.utils.host import to_host
from unires_torch.utils.phantoms import brain_phantom

# the module (the package re-exports the function ``fit`` under its name)
fit_mod = importlib.import_module("unires_torch.pipeline.fit")
fitloop = importlib.import_module("unires_torch.solvers.fitloop")

DIM_Y = (181, 217, 181)
# a yardstick against the plain version: max abs error <= YARDSTICK_TOL *
# max|plain|. grid_sample maps each point to [-1, 1] and back, which moves
# it by a few float32 ulps of the coordinate (1.5e-5 at 217).
YARDSTICK_TOL = 1e-4
# pull_grad's yardstick is compared this far from knots, the nearest
# yardsticks this far from half-voxel ties
KNOT_EPS = 1e-3
# H100 SXM peaks (NVIDIA's data sheet): HBM3 and float32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations per trilinear sample point: the map 18, fractions and
# weights 18, 8 multiply-adds 16 (pull and push); pull_grad 3 x 8 weight
# products and multiply-adds instead; nearest: the map and 3 roundings
OPS_PER_POINT = {"pull": 52, "push": 52, "pull_grad": 120}
OPS_NEAREST = 21
SLEEP_CYCLES = 20_000_000  # ~10 ms of device sleep ahead of a timed run
ADJOINT_TOL = 1e-5  # relative <pull u, v> - <u, push v>
SLICE_TOL = 1e-4  # card vs CPU objective traces, relative (f32 sums)
# card vs CPU with rigid and scaling on: the GN updates feed back into the
# fit, so float32 differences of the sums grow over the iterations
GN_SLICE_TOL = 1e-3
COREG_TOL = (0.1, 2e-3)  # card vs CPU coreg mats: mm, rotation entries
SMALL_DIM = (48, 56, 48)  # centre crop of the phantom for the small GN slice
# the phantom's placement in the atlas frame (1 mm, utils/phantoms.py) and
# the known "scanner" displacement of phase 6 (tests/test_atlas_geometry.py)
MAT_MNI = np.eye(4)
MAT_MNI[:3, 3] = [-90.0, -126.0, -72.0]
T_SYNTH = affine_matrix_classic([8.0, -5.0, 4.0, 0.04, -0.03, 0.02])
# residual of a recovered atlas placement: |t| mm + 90 mm * angle, as
# tests/test_atlas_geometry.py:41-54
ATLAS_TOL_MM = 6.0
INIT_TOL = 1e-5  # card vs CPU init volumes, relative to max|input|
# a resumed fit against the uninterrupted one: objective rows relative,
# volumes relative to their scale, poses (mm / rad) absolute. Not bitwise: a
# resume recomputes the CG preconditioner's data-term diagonals
RESUME_TOL = dict(trace=1e-4, vol=1e-3, pose=1e-4)
# a subject in a batch against the same subject alone (the batch reduces
# every subject on its own, on a single fit's shapes)
BATCH_TOL = dict(trace=1e-6, vol=1e-5)
# phase 3's batched launches: volumes per launch, and each one's pose (the
# fit's, then two more)
KERNEL_BATCH = 3
BATCH_POSES = ([1.0, -0.7, 0.6, 0.017, -0.012, 0.01],
               [-0.8, 0.5, -0.4, -0.01, 0.015, -0.008],
               [0.3, 0.9, -0.2, 0.005, 0.01, 0.02])
# phase 8c: the batch's launches against one subject's alone (one launch
# serves both subjects); phase 8d: subjects and iterations
BATCH_LAUNCH_RATIO = (0.9, 1.4)
BATCH4_SEEDS, BATCH4_ITERS = (0, 1, 2, 3), 4
# the quality floor at convergence (PERF.md, section 2): under the JAX
# package's own float32 converged run of this workload (25.773 dB, 0.4826;
# JAX_REFERENCE), which phase 9 also holds the card to within JAX_TOL
PSNR_FLOOR, RATIO_CEIL = 25.6, 0.50
# the JAX package's float32 run of the misaligned bench workload on the CPU
# (scripts/jax_bench_reference.py): phase 5 holds the card's inputs, init
# and first 8 objective values to it, phase 9 the same and the converged
# fit (jax_diffs; the names in JAX_REL relative to the reference). Each
# tolerance is at least twice the largest difference of 61 card runs of
# this tree from it, the workload as built and with its inputs multiplied
# by (1 + 1e-6 N(0, 1)) (NVIDIA H100 80GB HBM3, 700 W;
# scripts/cuda_bench_vs_jax.py, PERF.md section 6): tau relative (measured
# 8.7e-6); coreg translations (mm, 0.029) and rotation entries (2.7e-4);
# mse_trilinear relative (4.9e-4); the first 8 objective values relative
# (8.4e-4); PSNR (dB, 0.053) and sr_vs_trilinear (0.0057); the fitted
# rigid_q (translations mm 0.13, rotations rad 2.7e-3) and scales
# (1.3e-4); the objective before the first lambda step of either run
# (relative, 9.5e-3); the last objective relative (4.2e-3); n_iter
# (100-120 against the reference's 100) and the steps' iterations (up to
# 17 apart), which are chaotic in float32: a lambda step or the stop waits
# for six gains in a row under a gate. The inputs' sums and sums of
# squares (relative, 5.4e-8) tell the workload apart, another noise draw
# moving them by ~1e-4; the recon grid's dim is exact and its matrix
# (1.6e-8) is held to 1e-6. Both packages also reach a second end state
# in a few per cent of perturbed runs (PSNR +0.12 dB, a pose 0.23 mm and
# 0.014 rad away, the last objective +7.4 %), which these tolerances fail
JAX_REFERENCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "unires_torch", "data",
                             "jax_bench_reference.json")
JAX_TOL = dict(inputs=1e-5, tau=1e-4, coreg_mm=0.06, coreg_rot=6e-4,
               grid_dim=0, grid_mat=1e-6, mse_tri=1e-3, nll8=2e-3,
               n_iter=40, psnr=0.11, ratio=0.012, q_mm=0.3, q_rad=6e-3,
               scl=5e-4, trace=0.02, steps=35, last=1e-2)
JAX_REL = ("inputs", "tau", "mse_tri", "nll8", "trace", "last")
# the figures of the host-driven loop the fit chunk replaced, on an H100
# 80GB HBM3 at 700 W (PERF.md, section 6), printed beside this run's:
# converged n_iter, PSNR, sr_vs_trilinear; phase 5's init peak memory, host
# syncs per iteration and s/iter
HOST_LOOP = dict(n_iter=100, psnr=25.782, ratio=0.4817,
                 init_peak="5.33-5.42 GiB", syncs="21.4-22",
                 s_iter="0.0880-0.1023")
# the fit in chunks: init's peak memory (GiB) and host syncs per iteration
INIT_PEAK_GIB, SYNCS_PER_ITER = 3.5, 0.25
# a registration level on the card: the capture's wait and the level's read
SYNCS_PER_LEVEL = 2
# the figures of the host-driven NMI descent the level graphs replaced (one
# host read per evaluation; PERF.md section 5), printed beside this run's:
# phase 5's coreg seconds and host syncs, phase 6's atlas alignment
HOST_NMI = dict(coreg_s="3.3-5.8", coreg_syncs=">= 404", atlas_s="1.83-3.25",
                atlas_evals=250)
# the parallel steps against make_admm_step, as the CPU tests hold them: the
# sharded step (ys of its scale, z and w absolute, objective relative), and
# the slab steps, whose slab-local preconditioner stops CG elsewhere
SHARDED_TOL = dict(ys=2e-3, zw=1e-3, obj=2e-3)
SLAB_TOL = dict(ys=5e-3, zw=2e-2, obj=1e-2)
# FOV bounds of phase 3 in the fit's recon voxels: inside the volume on
# every axis, and beyond it (off the sample points' knife-edges)
# the denoising observations' rigid pose in phase 10: a shift and a small
# rotation (tests/test_spatial.py's shift)
DENOISE_POSE = [0.8, -0.5, 0.3, 0.01, -0.008, 0.006]
FOV_NARROW = np.array([[20.3, 160.7], [15.2, 200.4], [10.6, 170.3]],
                      np.float32)
FOV_WIDE = np.array([[-3.3, 183.6], [-2.7, 219.2], [-4.1, 184.4]],
                    np.float32)
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


_L2_FLUSH = []  # a float32 buffer of twice the card's L2, made on first use


def _flush_l2():
    """Read a buffer twice the size of L2: what the last call left there
    (its inputs, its dirty outputs) is evicted, the write-backs included."""
    if not _L2_FLUSH:
        l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                     50 << 20)
        _L2_FLUSH.append(torch.ones(2 * l2 // 4, device="cuda"))
    _L2_FLUSH[0].sum()


def _time_ms(fn, reps=7):
    """Device milliseconds per call of fn(): the median over ``reps`` calls
    (after one warm-up) of CUDA events around one call. Each call follows a
    flush of L2 outside its events, so it reads its inputs from device
    memory, as the bound assumes, however small they are. All is queued
    behind a device-side sleep so that the host's launch overhead leaves
    no gap (the flush buffer is made before it: an allocation would wait
    for the sleep)."""
    fn()
    _flush_l2()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in events:
        _flush_l2()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def _host_ms(fn, reps=7):
    """Host milliseconds per call of fn() as a caller sees it: the median
    of ``reps`` synchronised calls (launch overhead and device time)."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _max_err(got, want, scale, name, tol=0.0):
    err = float((got - want).abs().max())
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    require(err <= tol * scale, f"{name}: max abs err {err} > {tol} * {scale}")
    return err


def norm_grid(M, in_dim, out_dim, device, fov=None):
    """``grid_sample``'s grid (align_corners=True, axes reversed) of the
    sample points g = M (i, j, k, 1) of an ``out_dim`` grid in an ``in_dim``
    volume, and the points' FOV mask (``fov``: (3, 2) bounds, or the
    default [-0.5, n - 0.5])."""
    g = _sample_coords(_as_map(M), out_dim, device)
    grid = torch.stack([2.0 * g[d] / (in_dim[d] - 1) - 1.0 for d in (2, 1, 0)],
                       dim=-1)[None]
    return grid, _fov_mask(g, in_dim, fov)


def yardstick(name, inp, M, out_dim, fov=None, order=1):
    """The one PyTorch call that computes kernel ``name``'s function on the
    same inputs: its library yardstick, which the port never calls. Order 0
    (pull, push) samples the nearest voxel, as the port does away from
    half-voxel ties (PyTorch rounds a tie to even, the port up). Everything but that call is built here, outside the timed window.
    A batch, ``inp`` (B, X, Y, Z) with a list of B maps ``M``, is one call
    with N = B. Returns (call, to_plain, label): ``to_plain(call())`` is the
    result in the plain version's layout."""
    dev = inp.device
    one = inp.dim() == 3
    vols, Ms = (inp[None], [M]) if one else (inp, list(M))
    in_dim = tuple(vols.shape[1:])
    B = len(Ms)
    unbatch = (lambda r: r[0]) if one else (lambda r: r)  # noqa: E731
    grids = ([norm_grid(Mb, out_dim, in_dim, dev, fov) for Mb in Ms]
             if name == "push" else
             [norm_grid(Mb, in_dim, out_dim, dev, fov) for Mb in Ms])
    grid = torch.cat([g for g, _ in grids])
    fov = torch.stack([m for _, m in grids])
    mode = ("bilinear", "nearest")[order == 0]
    if name == "push":  # pull^T: scatter the FOV-masked values (atomicAdd)
        gout = (vols * fov)[:, None]
        like = torch.zeros((B, 1) + tuple(out_dim), device=dev)
        return (lambda: torch.ops.aten.grid_sampler_3d_backward(
                    gout, like, grid, int(order == 0), 0, True,
                    [True, False])[0],
                lambda r: unbatch(r[:, 0]),
                f"grid_sampler_3d_backward (input grad, {mode})")
    if name == "pull":
        return (lambda: F.grid_sample(vols[:, None], grid, mode=mode,
                                      padding_mode="zeros",
                                      align_corners=True),
                lambda r: unbatch(r[:, 0] * fov), f"grid_sample ({mode})")
    ones = torch.ones((B, 1) + tuple(out_dim), device=dev)
    scale = torch.tensor([2.0 / (n - 1) for n in in_dim], device=dev)
    return (lambda: torch.ops.aten.grid_sampler_3d_backward(
                ones, vols[:, None], grid, 0, 0, True, [False, True])[1],
            lambda r: unbatch(r.flip(-1) * scale * fov[..., None]),
            "grid_sampler_3d_backward (grid grad)")


def off_knots(M, out_dim, device, eps=KNOT_EPS):
    """Sample points at least ``eps`` from every integer knot on all three
    axes, where the trilinear gradient is continuous."""
    g = _sample_coords(_as_map(M), out_dim, device)
    ok = None
    for gd in g:
        okd = (gd - torch.round(gd)).abs() >= eps
        ok = okd if ok is None else ok & okd
    return ok


def off_ties(M, out_dim, device, eps=KNOT_EPS):
    """Sample points at least ``eps`` from every half-voxel tie (k + 1/2)
    on all three axes, where any two roundings to the nearest voxel
    agree."""
    g = _sample_coords(_as_map(M), out_dim, device)
    ok = None
    for gd in g:
        okd = (gd - torch.floor(gd) - 0.5).abs() >= eps
        ok = okd if ok is None else ok & okd
    return ok


def bound_ms(name, inp, out_dim, order=1):
    """The least time of the work on an H100 SXM: each input read once and
    each output written once at 3.35 TB/s, or its float32 operations at
    67 TFLOP/s, whichever is longer. Returns (ms, "bytes" / "operations")."""
    n_out = int(np.prod(out_dim))
    n_pts = inp.numel() if name == "push" else n_out  # sample points
    nbytes = 4.0 * (inp.numel() + n_out * (3 if name == "pull_grad" else 1))
    ops = n_pts * (OPS_NEAREST if order == 0 else OPS_PER_POINT[name])
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def centred_map(lin, in_dim, out_dim, offset=0.0):
    """4x4 affine with linear part ``lin`` taking the centre of an
    ``out_dim`` grid to the centre of an ``in_dim`` one, shifted by
    ``offset`` voxels on every axis (an offset moves points off the
    knots)."""
    mat = np.eye(4)
    mat[:3, :3] = lin
    mat[:3, 3] = ((np.asarray(in_dim) - 1) / 2
                  - lin @ ((np.asarray(out_dim) - 1) / 2) + offset)
    return mat


def fit_case():
    """The fit's resampling at bench size: one 4 mm observation (thick along
    z) of the 181x217x181 recon grid at a ~1 degree / 1 mm pose. Returns its
    proj_info and the maps (M, Minv) its pull and push take."""
    dim_x = (DIM_Y[0], DIM_Y[1], int(np.ceil(DIM_Y[2] / 4.0)))
    rigid = affine_matrix_classic([1.0, -0.7, 0.6, 0.017, -0.012, 0.01])
    po = proj_info(DIM_Y, np.eye(4), dim_x, affine_diag([1.0, 1.0, 4.0]),
                   rigid=rigid, prof_ip=2, prof_tp=0)
    return (po,) + tuple(obs_dyn_args(po, "super-resolution"))


def kernel_cases(device="cuda"):
    """The kernel cases of phase 3, at the main path's shapes: a list of
    (kernel, case, input, map, output grid, keywords) with seeded random
    inputs on ``device``."""
    rng = np.random.default_rng(0)
    po, M, Minv = fit_case()
    dim_x = po.dim_x
    # the init reslice map: recon voxel -> observation voxel
    M_init = affine_to_M(np.linalg.solve(po.mat_x, po.mat_y))
    # a co-registration map between two 1 mm iso levels of the bench images
    M_coreg = affine_to_M(affine_matrix_classic(
        [0.8, -1.1, 0.5, 0.012, -0.015, 0.009]))
    # a large map: 45 degrees about each axis, every output voxel 3 input
    # voxels wide (pull's corners spread out, push's reach below 1)
    dim_l = tuple(int(np.ceil(n / 3)) for n in DIM_Y)
    M_large = affine_to_M(centred_map(3.0 * affine_matrix_classic(
        [0, 0, 0, np.pi / 4, np.pi / 4, np.pi / 4])[:3, :3], DIM_Y, dim_l))
    vol_y = torch.from_numpy(rng.random(DIM_Y, dtype=np.float32)).to(device)
    vol_x = torch.from_numpy(rng.random(dim_x, dtype=np.float32)).to(device)
    vals = torch.from_numpy(rng.random(po.dim_yx, dtype=np.float32)).to(device)
    vals_l = torch.from_numpy(rng.random(dim_l, dtype=np.float32)).to(device)
    # the 2 mm level of an atlas alignment: the image's level (the mover,
    # 91 x 109 x 91) sampled on the bundled template's grid (91 x 109 x 109)
    # at a rigid + 3 % scale transform about the template's centre
    dim_a, dim_m = (91, 109, 109), (91, 109, 91)
    mat_a, mat_m = affine_diag([2.0] * 3), affine_diag([2.0] * 3)
    mat_a[:3, 3], mat_m[:3, 3] = [-90.0, -126.0, -90.0], MAT_MNI[:3, 3]
    lin = 1.03 * affine_matrix_classic([0, 0, 0, 0.03, -0.02, 0.025])[:3, :3]
    wc = (mat_a @ np.r_[(np.asarray(dim_a) - 1) / 2.0, 1.0])[:3]
    A = np.eye(4)
    A[:3, :3], A[:3, 3] = lin, wc - lin @ wc + [3.0, -2.0, 1.5]
    M_atlas = affine_to_M(np.linalg.solve(mat_m, A @ mat_a))
    vol_m = torch.from_numpy(rng.random(dim_m, dtype=np.float32)).to(device)
    return [
        ("pull", "fit", vol_y, M, po.dim_yx, {}),
        ("pull", "init", vol_x, M_init, DIM_Y, {}),
        ("pull", "order0", vol_y, M, po.dim_yx, dict(order=0)),
        ("pull", "large", vol_y, M_large, dim_l, {}),
        ("pull", "coreg", vol_y, M_coreg, DIM_Y, {}),
        ("push", "fit", vals, M, DIM_Y, dict(Minv=Minv)),
        ("push", "order0", vals, M, DIM_Y, dict(order=0, Minv=Minv)),
        ("push", "large", vals_l, M_large, DIM_Y, {}),
        ("pull_grad", "fit", vol_y, M, po.dim_yx, {}),
        ("pull_grad", "coreg", vol_y, M_coreg, DIM_Y, {}),
        ("pull_grad", "large", vol_y, M_large, dim_l, {}),
        ("pull_grad", "atlas", vol_m, M_atlas, dim_a, {}),
    ]


def fov_kernel_cases(device="cuda"):
    """The FOV = true cases of phase 3, as ``kernel_cases``: pull and push
    at the fit's map with ``fov`` narrower and wider than the volume, and
    at the maps and bounds of the one-slab spatial steps of phase 10 (the
    denoising step on a recon-grid observation at the fit's pose, and the
    super-resolution step), whose inputs carry the slab's halo of zero rows
    at each end."""
    rng = np.random.default_rng(3)
    po, M, Minv = fit_case()

    def rand(dim):
        return torch.from_numpy(rng.random(dim, dtype=np.float32)).to(device)

    def halo(v, h):
        pad = v.new_zeros((h,) + tuple(v.shape[1:]))
        return torch.cat([pad, v, pad])

    vol_y, vals, vol_x = rand(DIM_Y), rand(po.dim_yx), rand(DIM_Y)
    po_d = proj_info(DIM_Y, np.eye(4), DIM_Y, np.eye(4), rigid=po.rigid)
    M_d, Minv_d = obs_dyn_args(po_d, "denoising")
    H = spatial_halo_bound(po_d, "denoising")
    den = slab_maps(M_d, Minv_d, DIM_Y, 0, -H, -H, 0)
    Hp, Hq = sr_halo_bounds(po, 1)
    sr = slab_maps(M, Minv, DIM_Y, 0, -Hp, -Hq, 0)
    return [
        ("pull", "fov_narrow", vol_y, M, po.dim_yx, dict(fov=FOV_NARROW)),
        ("pull", "fov_wide", vol_y, M, po.dim_yx, dict(fov=FOV_WIDE)),
        ("pull", "slab_den", halo(vol_y, H), den["Ml"], DIM_Y,
         dict(fov=den["fov_pull"])),
        ("pull", "slab_sr", halo(vol_y, Hp), sr["Ml"], po.dim_yx,
         dict(fov=sr["fov_pull"])),
        ("push", "fov_narrow", vals, M, DIM_Y,
         dict(Minv=Minv, fov=FOV_NARROW)),
        ("push", "fov_wide", vals, M, DIM_Y, dict(Minv=Minv, fov=FOV_WIDE)),
        ("push", "slab_den", halo(vol_x, H), den["Mp"], DIM_Y,
         dict(Minv=den["Mpi"], window=push_window(M_d),
              fov=den["fov_push"])),
        ("push", "slab_sr", halo(vals, Hq), sr["Mp"], DIM_Y,
         dict(Minv=sr["Mpi"], window=push_window(M), fov=sr["fov_push"])),
    ]


FUNCS = {"pull": (pull, pull_plain), "push": (push, push_plain),
         "pull_grad": (pull_grad, pull_grad_plain)}


def _measure(name, case, inp, Mc, out_dim, kw):
    """One case of phase 3: the kernel against its plain version (exact),
    its times, its bound and its library yardstick. Prints a line and
    returns the record."""
    kern_fn, plain_fn = FUNCS[name]
    # the map in device memory, push's plan computed there, as the fit
    # chunk launches them
    Md = torch.from_numpy(_as_map(Mc)).to(inp.device)
    kwd = dict(kw)
    if name == "push":
        Minv = kw.get("Minv")
        kwd["Minv"] = push_plan(Md, None if Minv is None else torch.from_numpy(
            _as_map(Minv)).to(inp.device), kw.get("order", 1),
            tuple(inp.shape), out_dim)
    kern = lambda: kern_fn(inp, Md, out_dim, **kwd)  # noqa: E731
    plain = lambda: plain_fn(inp, Mc, out_dim, **kw)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    label = f"{name}/{case}"
    # every kernel repeats its plain version's roundings: exact
    err = _max_err(got, want, float(inp.abs().max()), label)
    require(float(want.abs().max()) > 0.0, f"{label}: plain result is 0")
    ms, plain_ms, host_ms = _time_ms(kern), _time_ms(plain), _host_ms(kern)
    order = kw.get("order", 1)
    bnd, bound_by = bound_ms(name, inp, out_dim, order)
    # bytes: the input volume once and the output once (bench.py:169)
    gbps = 4.0 * (inp.numel() + np.prod(got.shape)) / (ms * 1e-3) / 1e9
    line = (f"[kernels] {label}: max_abs_err {err:.3e} | kernel "
            f"{ms:.4f} ms (host {host_ms:.4f} ms) | plain {plain_ms:.4f} "
            f"ms | {gbps:.1f} GB/s | "
            f"bound {bnd:.4f} ms ({bound_by}) | share {bnd / ms:.1%}")
    call, to_plain, lib_call = yardstick(name, inp, Mc, out_dim,
                                         kw.get("fov"), order)
    lib, ref = to_plain(call()), want
    sel = torch.ones_like(got, dtype=bool)
    if name == "pull_grad":
        sel = off_knots(Mc, out_dim, inp.device)[..., None]
    elif order == 0 and name == "pull":
        sel = off_ties(Mc, out_dim, inp.device)
    elif order == 0:  # push: the sources near a tie left out of both
        keep = off_ties(Mc, tuple(inp.shape), inp.device).to(inp.dtype)
        chk, chk_plain, _ = yardstick(name, inp * keep, Mc, out_dim,
                                      kw.get("fov"), order)
        lib, ref = chk_plain(chk()), plain_fn(inp * keep, Mc, out_dim, **kw)
    lib_err = float(((lib - ref) * sel).abs().max())
    lib_tol = YARDSTICK_TOL * float(ref.abs().max())
    require(lib_err <= lib_tol, f"{label}: yardstick {lib_call} err "
            f"{lib_err} > {lib_tol}")
    lib_ms = _time_ms(call)
    line += (f" | {lib_call} {lib_ms:.4f} ms (err {lib_err:.3e}) | "
             f"kernel/library {ms / lib_ms:.3f}")
    print(line)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                bound_by=bound_by, library_ms=lib_ms, library_call=lib_call)


def batch_case(name, device="cuda"):
    """Phase 3's batched case of ``name``: KERNEL_BATCH volumes at the fit's
    shapes, each at its own pose. Returns (inp, Ms, kw, out_dim, plain):
    the stacked input, the (B, 3, 4) host maps, the batched launch's
    keywords (push: its plans on the device as ``Minv``, one per volume),
    the output grid, and ``plain(b)``, volume b's plain result."""
    rng = np.random.default_rng(7)
    B = KERNEL_BATCH
    pos = []
    for p in BATCH_POSES[:B]:
        po = proj_info(DIM_Y, np.eye(4), fit_case()[0].dim_x,
                       affine_diag([1.0, 1.0, 4.0]),
                       rigid=affine_matrix_classic(p), prof_ip=2, prof_tp=0)
        pos.append(obs_dyn_args(po, "super-resolution"))
    Ms = np.stack([M for M, _ in pos])
    dim_yx = tuple(po.dim_yx)
    if name == "push":
        Minvs = np.stack([Mi for _, Mi in pos])
        inp = torch.from_numpy(rng.random((B,) + dim_yx,
                                          dtype=np.float32)).to(device)
        plans = push_plan(torch.from_numpy(Ms).to(device),
                          torch.from_numpy(Minvs).to(device), 1, dim_yx,
                          DIM_Y)
        return (inp, Ms, dict(Minv=plans), DIM_Y,
                lambda b: push_plain(inp[b], Ms[b], DIM_Y, Minv=Minvs[b]))
    fn_plain = FUNCS[name][1]
    inp = torch.from_numpy(rng.random((B,) + DIM_Y,
                                      dtype=np.float32)).to(device)
    return (inp, Ms, {}, dim_yx,
            lambda b: fn_plain(inp[b], Ms[b], dim_yx))


def bench_pull_cases(device="cuda"):
    """The forward pull of each channel of the misaligned bench fit after
    its init (``_bench_init``, as phase 5 runs it), as ``kernel_cases``
    lists a case: the channel's recon sampled on its observation's
    ``dim_yx`` at ``obs_dyn_args(po, "super-resolution")``. Every sample
    point lies inside the volume, unlike those of the ``fit`` case, whose
    output grid overhangs the volume along z."""
    x, y, _ = _bench_init(device, DIM_Y, 8)
    return [("pull", f"bench{c}", yc.dat,
             obs_dyn_args(xc[0].po, "super-resolution")[0],
             tuple(xc[0].po.dim_yx), {})
            for c, (xc, yc) in enumerate(zip(x, y))]


def _measure_batch(name, device="cuda"):
    """Phase 3's batched launch of ``name`` (``batch_case``) in one launch,
    against the unbatched launches and the plain version (bitwise); its
    device ms beside that of the unbatched launches. Prints a line and
    returns the record."""
    B = KERNEL_BATCH
    inp, Ms, kw, out_dim, plain = batch_case(name, device)
    Md = torch.from_numpy(Ms).to(device)
    fn = FUNCS[name][0]
    batched = lambda: fn(inp, Md, out_dim, **kw)  # noqa: E731
    one = lambda b: fn(inp[b], Md[b], out_dim,  # noqa: E731
                       **{k: v[b] for k, v in kw.items()})
    unbatched = lambda: [one(b) for b in range(B)]  # noqa: E731
    got = batched()
    want = torch.stack(unbatched())
    ref = torch.stack([plain(b) for b in range(B)])
    torch.cuda.synchronize()
    label = f"{name}/batch{B}"
    scale = float(inp.abs().max())
    err = max(_max_err(got, want, scale, f"{label} vs unbatched"),
              _max_err(got, ref, scale, f"{label} vs plain"))
    require(float(want.abs().max()) > 0.0, f"{label}: result is 0")
    ms_b, ms_u = _time_ms(batched), _time_ms(unbatched)
    # the bound of B volumes: B times one volume's (bytes and operations)
    bnd, bound_by = bound_ms(name, inp[0], out_dim)
    bnd *= B
    # the library call with N = B, held against the plain version
    call, to_plain, lib_call = yardstick(name, inp, list(Ms), out_dim)
    lib = to_plain(call())
    sel = (torch.stack([off_knots(Mb, out_dim, inp.device) for Mb in Ms])
           [..., None] if name == "pull_grad"
           else torch.ones_like(got, dtype=bool))
    lib_err = float(((lib - ref) * sel).abs().max())
    lib_tol = YARDSTICK_TOL * float(ref.abs().max())
    require(lib_err <= lib_tol, f"{label}: yardstick {lib_call} err "
            f"{lib_err} > {lib_tol}")
    lib_ms = _time_ms(call)
    print(f"[kernels] {label} {tuple(inp.shape)} -> {tuple(got.shape)}: "
          f"max_abs_err {err:.3e} vs {B} unbatched launches and vs plain | "
          f"batched {ms_b:.4f} ms, {B} unbatched {ms_u:.4f} ms "
          f"({ms_b / ms_u:.3f}) | bound {bnd:.4f} ms ({bound_by}) | share "
          f"{bnd / ms_b:.1%} | {lib_call} N = {B} {lib_ms:.4f} ms (err "
          f"{lib_err:.3e}) | batched/library {ms_b / lib_ms:.3f}")
    return dict(batch_ms=ms_b, unbatched_x3_ms=ms_u, batch_bound_ms=bnd,
                batch_library_ms=lib_ms)


def _adjoint(cases, tag, **fov):
    """<pull u, v> = <u, push v> through the kernels at the fit's map."""
    by_case = {(c[0], c[1]): c[2:] for c in cases}
    vol_y, M, dim_yx, _ = by_case["pull", tag]
    vals, _, _, push_kw = by_case["push", tag]
    lhs = float((pull(vol_y, M, dim_yx, **fov).double() * vals.double())
                .sum())
    rhs = float((vol_y.double() * push(vals, M, DIM_Y, **push_kw).double())
                .sum())
    rel = abs(lhs - rhs) / abs(lhs)
    print(f"[kernels] adjoint ({tag}) <pull u, v> {lhs:.10e} <u, push v> "
          f"{rhs:.10e} rel {rel:.3e}")
    require(rel <= ADJOINT_TOL, f"adjointness rel {rel} > {ADJOINT_TOL}")


def phase_kernels(device="cuda"):
    """Each kernel against its plain version at the main path's shapes, with
    its bound and its library yardstick; then pull and push with the fov
    override."""
    cases = kernel_cases(device)
    print("[kernels] " + " | ".join(
        f"{name}/{case} {tuple(inp.shape)} -> {tuple(out_dim)}"
        for name, case, inp, _, out_dim, _ in cases))
    rec = {}
    for c in cases:
        r = _measure(*c)
        if c[1] == "fit":
            rec[c[0]] = r
        elif c[1] == "order0":  # after the kernel's fit case
            rec[c[0]]["order0"] = r
    _adjoint(cases, "fit")

    cases = fov_kernel_cases(device)
    print("[kernels] fov: " + " | ".join(
        f"{name}/{case} {tuple(inp.shape)} -> {tuple(out_dim)} fov "
        f"{kw['fov'].tolist()}" for name, case, inp, _, out_dim, kw in cases))
    for c in cases:
        rec[c[0]].setdefault("fov", {})[c[1]] = _measure(*c)
    _adjoint(cases, "fov_narrow", fov=FOV_NARROW)
    for name in ("pull", "push", "pull_grad"):
        rec[name].update(_measure_batch(name, device))
    rec["stencils"] = {f"{e}/{c}": _measure_stencil(e, c, k, p, n)
                       for e, c, k, p, n in stencil_cases(device)}
    rec["blurs"] = {f"{c[0]}/{c[1]}": _measure_blur(*c)
                    for c in blur_cases(device)}
    rec["gn_stats"] = {c[0]: _measure_gn(*c) for c in gn_cases(device)}
    return rec


# the fit's recon grids of the benchmark's configurations, and the batch
# of two subjects (a channel of each) at the first
STENCIL_CASES = (("sr3", (190, 232, 189), 0), ("common", (192, 256, 192), 0),
                 ("batch2", (190, 232, 189), 2))
STENCIL_VX = (1.0, 1.0, 1.0)
# bytes a voxel: the input read once and the output written once (float32)
STENCIL_BYTES = {"gradient": 16, "divergence": 16, "membrane": 8}


def stencil_cases(device="cuda"):
    """The stencil cases of phase 3: (entry, case, kernel call, plain call,
    voxels), the kernels called as the ADMM body calls them (a channel view
    of a stacked state, the scale a device tensor: float64 0-d for one
    volume, float32 per volume for a batch), the plain chain the same
    arithmetic in PyTorch's zero-fill ops."""
    rng = np.random.default_rng(5)
    out = []
    for case, dim, B in STENCIL_CASES:
        lead = (max(B, 1), 3)
        V = torch.from_numpy(rng.standard_normal(lead + dim, dtype=np.float32)
                             ).to(device)
        P = torch.from_numpy(rng.standard_normal(lead + (3,) + dim,
                                                 dtype=np.float32)).to(device)
        v, p = (V[0, 1], P[0, 1]) if B == 0 else (V[:, 1], P[:, 1])
        s = (torch.tensor(0.37, dtype=torch.float64, device=device) if B == 0
             else torch.tensor([0.37, 1.9], device=device).reshape(B, 1, 1, 1))
        s5 = s if B == 0 else s[..., None]
        vx = STENCIL_VX
        n = max(B, 1) * int(np.prod(dim))
        out += [
            ("gradient", case, lambda v=v, s=s5: fd.im_gradient(v, vx, scale=s),
             lambda v=v, s=s5: s * fd.gradient_plain(v, vx), n),
            ("divergence", case,
             lambda p=p, s=s: fd.im_divergence(p, vx, scale=s),
             lambda p=p, s=s: s * fd.divergence_plain(p, vx), n),
            ("membrane", case, lambda v=v, s=s: fd.DtD(v, vx, scale=s),
             lambda v=v, s=s: s * fd.divergence_plain(
                 fd.gradient_plain(v, vx), vx), n),
        ]
    return out


def _measure_stencil(entry, case, kern, plain, n):
    """One stencil case of phase 3: bitwise against the plain chain, its
    device ms beside the plain chain's and its bound. Prints a line and
    returns the record."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    label = f"{entry}/{case}"
    require(got.shape == want.shape and torch.equal(
        got.view(torch.int32), want.view(torch.int32)),
        f"{label}: not bitwise the plain chain (max abs err "
        f"{float((got - want).abs().max())})")
    require(float(want.abs().max()) > 0.0, f"{label}: plain result is 0")
    ms, plain_ms = _time_ms(kern), _time_ms(plain)
    bnd = 1e3 * STENCIL_BYTES[entry] * n / HBM_BYTES_PER_S
    print(f"[kernels] stencil {label} ({n} voxels): bitwise | kernel "
          f"{ms:.4f} ms | plain {plain_ms:.4f} ms ({plain_ms / ms:.2f}x) | "
          f"{STENCIL_BYTES[entry] * n / (ms * 1e-3) / 1e9:.1f} GB/s | bound "
          f"{bnd:.4f} ms (bytes) | share {bnd / ms:.1%}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd)


# the blur's geometries: (case, profiles, ratio, the upsampled grid dim_yx,
# volumes) of brainweb_sr3's observations and of brainweb_common's after
# the atlas alignment (tests/test_torch_blur.py pins both)
BLUR_CASES = (("sr3", (-1, -1, 0), (1, 1, 4), (181, 217, 185), 1),
              ("common_thick2", (2, 2, 0), (2, 2, 5), (369, 441, 230), 1),
              ("common_thick1", (2, 0, 2), (2, 5, 2), (369, 275, 369), 1),
              ("common_thick0", (0, 2, 2), (5, 2, 2), (230, 441, 369), 1),
              ("batch2", (-1, -1, 0), (1, 1, 4), (181, 217, 185), 2))


def _blur_shapes(kers, ratio, dim, up):
    """Each pass's (input, output) voxels of one volume, axis by axis, as
    the kernels run them (a dirac axis: no pass)."""
    out, dim = [], list(dim)
    for axis, (k, r) in enumerate(zip(kers, ratio)):
        if k.shape[0] == 1 and r == 1 and k[0] == 1.0:
            continue
        n_in = int(np.prod(dim))
        n = dim[axis]
        K = k.shape[0]
        dim[axis] = (n - 1) * r + K if up else (n - K) // r + 1
        out.append((n_in, int(np.prod(dim))))
    return out


def _blur_library(dat, kers, ratio, up):
    """One blur direction as PyTorch's library calls, one call a pass that
    is not a dirac axis: ``conv3d`` with a (K, 1, 1) kernel at stride (r, 1,
    1) down, ``conv_transpose3d`` up, along each axis in turn. Returns the
    call; the weights are on the device before it."""
    lead, passes = tuple(dat.shape[:-3]), []
    for axis, (k, r) in enumerate(zip(kers, ratio)):
        if k.shape[0] == 1 and r == 1 and k[0] == 1.0:
            continue
        shape, stride = [1] * 5, [1] * 3
        shape[2 + axis], stride[axis] = k.shape[0], int(r)
        passes.append((torch.from_numpy(k.reshape(shape)).to(dat.device),
                       tuple(stride)))
    fn = F.conv_transpose3d if up else F.conv3d

    def call():
        x = dat.reshape((-1, 1) + tuple(dat.shape[-3:]))
        for w, stride in passes:
            x = fn(x, w, stride=stride)
        return x.reshape(lead + tuple(x.shape[2:]))
    return call


def blur_cases(device="cuda"):
    """The blur cases of phase 3: (direction, case, kernel call, plain
    call, passes' (input, output) voxels, volumes, library call); the down
    pass from the upsampled grid, the up pass back to it, the plain call the
    per-axis chain of ``ops/conv.py`` in PyTorch's ops, the library call
    :func:`_blur_library`'s."""
    rng = np.random.default_rng(6)
    out = []
    for case, prof, ratio, dim, B in BLUR_CASES:
        kers = tuple(kernel_1d(p, float(r)).astype(np.float32)
                     for p, r in zip(prof, ratio))
        n_out = tuple((n - k.shape[0]) // r + 1
                      for n, k, r in zip(dim, kers, ratio))
        lead = (B,) if B > 1 else ()
        u = torch.from_numpy(rng.standard_normal(lead + dim,
                                                 dtype=np.float32)).to(device)
        v = torch.from_numpy(rng.standard_normal(lead + n_out,
                                                 dtype=np.float32)).to(device)
        out += [("down", case,
                 lambda u=u, k=kers, r=ratio: conv.blur_down_sep(u, k, r),
                 lambda u=u, k=kers, r=ratio: conv.blur_down_plain(u, k, r),
                 _blur_shapes(kers, ratio, dim, False), B,
                 _blur_library(u, kers, ratio, False)),
                ("up", case,
                 lambda v=v, k=kers, r=ratio: conv.blur_up_sep(v, k, r),
                 lambda v=v, k=kers, r=ratio: conv.blur_up_plain(v, k, r),
                 _blur_shapes(kers, ratio, n_out, True), B,
                 _blur_library(v, kers, ratio, True))]
    return out


def _measure_blur(direction, case, kern, plain, passes, B, library):
    """One blur case of phase 3: bitwise against the plain chain, its
    launches, its device ms beside the plain chain's, the library call's
    (in float32: cuDNN's TF32 off, as ``pipeline.run.get_device`` sets it;
    held to the plain chain to 1e-5 of its largest value) and its bound.
    Prints a line and returns the record (``passes``: the case's launches,
    one a pass)."""
    torch.backends.cudnn.allow_tf32 = False
    n0 = [f.launches for f in conv.BLURS]
    got = kern()
    torch.cuda.synchronize()
    launches = sum(f.launches - n for f, n in zip(conv.BLURS, n0))
    want = plain()
    torch.cuda.synchronize()
    label = f"{direction}/{case}"
    require(got.shape == want.shape and torch.equal(
        got.view(torch.int32), want.view(torch.int32)),
        f"blur {label}: not bitwise the plain chain (max abs err "
        f"{float((got - want).abs().max())})")
    require(float(want.abs().max()) > 0.0, f"blur {label}: plain result is 0")
    require(launches == len(passes), f"blur {label}: {launches} launches, "
            f"{len(passes)} passes")
    lib = library()
    lib_err = float((lib - want).abs().max() / want.abs().max())
    require(lib.shape == want.shape and lib_err <= 1e-5,
            f"blur {label}: the library call is not the blur ({lib_err:.3e} "
            f"of scale)")
    ms, plain_ms, lib_ms = _time_ms(kern), _time_ms(plain), _time_ms(library)
    nbytes = 4 * B * sum(a + b for a, b in passes)
    bnd = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[kernels] blur {label} ({B} x {len(passes)} passes, "
          f"{nbytes / 1e6:.1f} MB): bitwise | kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms ({plain_ms / ms:.2f}x) | library "
          f"{lib_ms:.4f} ms (kernel / library {ms / lib_ms:.3f}, error "
          f"{lib_err:.2e} of scale) | {nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
          f"| bound {bnd:.4f} ms (bytes) | share {bnd / ms:.1%}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
                passes=launches)


# the rigid GN statistics' grids: (case, grid, with C^T C, volumes) of
# brainweb_sr3's observations (dim_yx), brainweb_common's after the atlas
# alignment (each thick axis, as BLUR_CASES), brainweb_denoise3's (dim_x,
# no C^T C) and a batch of two subjects at the first
GN_CASES = (("sr3", (181, 217, 185), True, 1),
            ("common_thick2", (369, 441, 230), True, 1),
            ("common_thick1", (369, 275, 369), True, 1),
            ("common_thick0", (230, 441, 369), True, 1),
            ("denoise3", (181, 217, 181), False, 1),
            ("batch2", (181, 217, 185), True, 2))
GN_TOL = 1e-12  # of each moment's sum of |terms|: the float64 sums' order


def gn_cases(device="cuda"):
    """The rigid GN statistics' cases of phase 3: (case, kernel call, plain
    call, call on absolute values (each moment's sum of |terms|), bytes the
    call must read): normal gradients, a residual with a tenth of zeros, a
    positive C^T C (or 1.0), as ``match_stats_device`` passes them."""
    from unires_torch.solvers.rigid import _centred_coords

    out = []
    for case, dim, with_ctc, B in GN_CASES:
        g = torch.Generator(device=device).manual_seed(7)
        lead = (B,) if B > 1 else ()
        gr = torch.randn(lead + dim + (3,), generator=g, device=device)
        diff = torch.randn(lead + dim, generator=g, device=device)
        diff[diff.abs() < 0.125] = 0.0
        ctc = (torch.rand(dim, generator=g, device=device) + 0.25
               if with_ctc else 1.0)
        coords = _centred_coords(dim, tuple((n - 1) / 2 for n in dim),
                                 device)
        args = (gr, diff, ctc, coords)
        absolute = (gr.abs(), diff.abs(), ctc.abs() if with_ctc else 1.0,
                    tuple(c.abs() for c in coords))
        nbytes = 4 * (gr.numel() + diff.numel()
                      + (B * ctc.numel() if with_ctc else 0))
        out.append((case, lambda a=args: gn_stats.gn_moments(*a),
                    lambda a=args: gn_stats.gn_moments_plain(*a),
                    lambda a=absolute: gn_stats.gn_moments_plain(*a),
                    nbytes))
    return out


def _measure_gn(case, kern, plain, absolute, nbytes):
    """One case of the rigid GN statistics: every moment within ``GN_TOL``
    of the plain chain's, relative to its sum of |terms|, a rerun equal to
    the bit, two launches; its device ms beside the plain chain's and its
    bound (each input read once at 3.35 TB/s). Prints a line and returns
    the record."""
    n0 = gn_stats.gn_moments.launches
    got = kern()
    torch.cuda.synchronize()
    launches = gn_stats.gn_moments.launches - n0
    want, scale = plain(), absolute()
    again = kern()
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / scale).max())
    require(float(scale.min()) > 0 and rel <= GN_TOL,
            f"gn_stats {case}: {rel:.3e} of the sum of |terms| > {GN_TOL}")
    require(torch.equal(got.view(torch.int64), again.view(torch.int64)),
            f"gn_stats {case}: a rerun differs")
    require(launches == 2, f"gn_stats {case}: {launches} launches, not 2")
    ms, plain_ms = _time_ms(kern), _time_ms(plain)
    bnd = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[kernels] gn_stats {case} ({nbytes / 1e6:.1f} MB): {rel:.2e} of "
          f"the sum of |terms|, rerun bitwise | kernel {ms:.4f} ms | plain "
          f"{plain_ms:.4f} ms ({plain_ms / ms:.2f}x) | "
          f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s | bound {bnd:.4f} ms "
          f"(bytes) | share {bnd / ms:.1%}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bnd, rel_err=rel)


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
    """PSNR and sr_vs_trilinear of channel 0 (bench.py:102-110, 175-193),
    and the trilinear reslice's MSE."""
    M = affine_to_M(np.linalg.solve(np.eye(4), y[0].mat))
    gt_on_y = pull(torch.from_numpy(gt).to(device), M, y[0].dim)
    msk = gt_on_y > 0
    mse_t = float(((tri - gt_on_y)[msk] ** 2).mean())
    mse = float(((y[0].dat - gt_on_y)[msk] ** 2).mean())
    psnr = 10.0 * np.log10(float(gt_on_y.max()) ** 2 / max(mse, 1e-12))
    return psnr, mse / mse_t, mse_t


def _sched_steps(nll):
    """Iterations where the objective falls by more than a fifth after the
    first 17 (a step needs 17 at one schedule position): the lambda
    schedule's steps (the prior's weight halves)."""
    return [k for k in range(17, len(nll)) if nll[k] < 0.8 * nll[k - 1]]


@functools.lru_cache(maxsize=None)
def _jax_reference():
    with open(JAX_REFERENCE) as f:
        return json.load(f)


def _moments(a):
    a = np.asarray(a, np.float64)
    return [float(a.sum()), float((a * a).sum())]


def _figures(inputs, x, y, sett, obj, n_iter, gt, tri, device):
    """A fit's figures that the JAX package's reference holds: the inputs'
    moments (``inputs``, taken before init), init's tau, coreg matrices,
    recon grid and trilinear MSE, then the fit's."""
    psnr, ratio, mse_t = _quality(y, gt, tri, device)
    return dict(inputs=inputs, tau=[o.tau for xc in x for o in xc],
                mat_coreg=np.asarray(sett.mat_coreg), dim=list(y[0].dim),
                mat=np.asarray(y[0].mat), mse_trilinear=mse_t,
                nll=np.asarray(obj)[:, 0], n_iter=int(n_iter), psnr=psnr,
                sr_vs_trilinear=ratio, rigid_q=_poses(x),
                scl=[o.po.scl for xc in x for o in xc])


def _jax_figures(ref):
    """The figures of an output of scripts/jax_bench_reference.py, as
    ``_figures`` gives a run's."""
    ri = ref["init"]
    return dict(inputs=[i["moments"] for i in ref["inputs"]], tau=ri["tau"],
                mat_coreg=ri["mat_coreg"], dim=ri["dim"], mat=ri["mat"],
                mse_trilinear=ri["mse_trilinear"], nll=ref["nll"],
                n_iter=ref["n_iter"], psnr=ref["psnr"],
                sr_vs_trilinear=ref["sr_vs_trilinear"],
                rigid_q=ref["rigid_q"], scl=ref["scl"])


def jax_diffs(fig, converged):
    """A run's figures (``_figures``) against the JAX package's reference,
    by the names of JAX_TOL: the largest difference of each (relative to
    |reference| for the names in JAX_REL), signed where the figure is one
    number. The inputs, init and the first 8 objective values always; the
    converged fit's figures when the run ``converged``."""
    ref, out = _jax_reference(), {}

    def put(key, got, want):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        require(got.shape == want.shape,
                f"{key}: the card's {got.shape} against JAX's {want.shape}")
        d = (got - want) / (np.abs(want) if key in JAX_REL else 1.0)
        out[key] = float(d) if d.ndim == 0 else float(np.abs(d).max())

    ri = ref["init"]
    mc, mj = np.asarray(fig["mat_coreg"]), np.asarray(ri["mat_coreg"])
    put("inputs", fig["inputs"], [i["moments"] for i in ref["inputs"]])
    put("tau", fig["tau"], ri["tau"])
    put("coreg_mm", mc[:, :3, 3], mj[:, :3, 3])
    put("coreg_rot", mc[:, :3, :3], mj[:, :3, :3])
    put("grid_dim", fig["dim"], ri["dim"])
    put("grid_mat", fig["mat"], ri["mat"])
    put("mse_tri", fig["mse_trilinear"], ri["mse_trilinear"])
    nll, nj = np.asarray(fig["nll"]), np.asarray(ref["nll"])
    put("nll8", nll[:8], nj[:len(nll[:8])])
    if converged:
        q, qj = np.asarray(fig["rigid_q"]), np.asarray(ref["rigid_q"])
        steps, steps_j = _sched_steps(nll), _sched_steps(nj)
        put("n_iter", fig["n_iter"], ref["n_iter"])
        put("psnr", fig["psnr"], ref["psnr"])
        put("ratio", fig["sr_vs_trilinear"], ref["sr_vs_trilinear"])
        put("q_mm", q[:, :3], qj[:, :3])
        put("q_rad", q[:, 3:], qj[:, 3:])
        put("scl", fig["scl"], ref["scl"])
        put("steps", steps, steps_j)
        n = min(steps[0], steps_j[0])
        put("trace", nll[:n], nj[:n])
        put("last", nll[-1], nj[-1])
    return out


def _check_vs_jax(tag, fig, converged):
    """Each of ``jax_diffs`` on a line of its own; fails beyond JAX_TOL."""
    for key, d in jax_diffs(fig, converged).items():
        tol = JAX_TOL[key]
        print(f"[{tag}] vs JAX {key}: {'rel ' if key in JAX_REL else ''}"
              f"diff {d:+.3e} (tol {tol:g})")
        require(abs(d) <= tol, f"{key}: the card differs from the JAX "
                f"package's reference by {d} > {tol}")


def _check_fit(dat_y, y, obj, jtv, n_iter, max_iter):
    require(dat_y.shape == tuple(y[0].dim) + (3,), f"output {dat_y.shape}")
    require(bool(np.isfinite(dat_y).all() and np.isfinite(obj).all()
                 and torch.isfinite(jtv).all()), "non-finite output")
    require(n_iter == max_iter, f"n_iter {n_iter} != {max_iter}")
    require(obj[-1, 0] < obj[0, 0],
            f"objective did not fall: {obj[0, 0]} -> {obj[-1, 0]}")


@functools.lru_cache(maxsize=None)
def _full_phantom(contrast):
    """The bench's 181x217x181 brain phantom. Cached: callers only read it."""
    return brain_phantom(dim=DIM_Y, contrast=contrast, amplitude=2000.0,
                         seed=0)


def _phantom(contrast, dim):
    """The bench's brain phantom, or its centre crop of ``dim`` (the phantom
    lives in an MNI-like frame: a smaller grid of its own would hold only a
    corner of the head)."""
    vol = _full_phantom(contrast)
    lo = [(n - d) // 2 for n, d in zip(DIM_Y, dim)]
    return np.ascontiguousarray(
        vol[tuple(slice(a, a + d) for a, d in zip(lo, dim))])


def _bench_workload(device, dim, misaligned, seed=0):
    """The 3-channel brain phantom of bench.py:40-91 (rigids and scaling
    only when ``misaligned``), with its ground truths and rigids; ``seed``
    draws the poses and the noise (bench.py's is 0)."""
    rng = np.random.default_rng(seed)
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
    psnr, ratio, _ = _quality(y, gts[0], tri, device)
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


def _timed(name, record, keep_args=False):
    """Wrap ``run_mod.<name>`` (a registration entry ``init`` calls) so that
    its seconds, its launches of each kernel (one pull and one pull_grad per
    NMI evaluation), its host syncs, its levels' figures (:func:`_levels`)
    and its result land in ``record``, with copies of its arguments when
    ``keep_args``. Returns the original, to be put back."""
    fn = getattr(run_mod, name)

    def timed(*args, **kw):
        if keep_args:
            record["args"] = ([(d.clone(), np.array(m)) for d, m in args[0]],
                              *args[1:])
            record["kw"] = dict(kw)
        n0 = _counts()
        since = trace.serial()
        s0, c0 = to_host.syncs, time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        n1 = _counts()
        record.update(s=time.perf_counter() - c0, syncs=to_host.syncs - s0,
                      launches={k: n1[k] - n0[k] for k in n1},
                      levels=_levels(since), out=out)
        return out

    setattr(run_mod, name, timed)
    return fn


def _levels(since):
    """The figures of the registration levels that ran since ``since``
    (``utils.trace.serial``): each ``registration.level`` span's counts,
    with its seconds ``s``, its warm-up + capture ``setup_s`` and its
    replay + read ``run_s`` (its children's)."""
    spans = trace.spans(since=since)
    out = []
    for lv in (s for s in spans if s.name == "registration.level"):
        kids = {s.name: s.s for s in spans if s.parent == lv.serial}
        out.append(dict(lv.attrs, s=lv.s, run_s=kids["registration.level.run"],
                        setup_s=kids.get("registration.level.capture", 0.0)))
    return out


def _print_levels(tag, levels):
    """One line per registration level: voxel size, grid, movers,
    evaluations per mover, WHILE turns, seconds (warm-up + capture, then
    replay + read), graph nodes and host syncs."""
    for lv in levels:
        nodes = "uncaptured" if lv["nodes"] is None else f"{lv['nodes']} nodes"
        print(f"[{tag}] level {lv['mm']:g} mm {lv['group']} grid "
              f"{tuple(lv['grid'])} | movers {lv['movers']} | evaluations "
              f"per mover {lv['evals']} | WHILE turns {lv['turns']} | "
              f"{lv['s']:.3f} s (warm-up + capture {lv['setup_s']:.3f}, "
              f"{nodes}; replay + read {lv['run_s']:.3f}) | host syncs "
              f"{lv['syncs']}")


def _check_level_syncs(tag, rec):
    n_lv = len(rec["levels"])
    require(n_lv > 0 and rec["syncs"] <= SYNCS_PER_LEVEL * n_lv,
            f"{tag}: {rec['syncs']} host syncs over {n_lv} levels > "
            f"{SYNCS_PER_LEVEL} per level")
    require(all(lv["nodes"] is not None for lv in rec["levels"]),
            f"{tag}: a level ran uncaptured")


def _timed_captures(record):
    """Wrap ``FitChunk._capture`` (the warm-up of every branch and the
    capture of one iteration) so that its seconds, the device's included,
    add up in ``record['s']``, its calls in ``record['n']`` and the last
    graph's node count lands in ``record['nodes']``. Returns the original,
    to be put back."""
    fn = fitloop.FitChunk._capture

    def timed(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(self, *args)
        torch.cuda.synchronize()
        record["s"] = record.get("s", 0.0) + time.perf_counter() - t0
        record["n"] = record.get("n", 0) + 1
        record["nodes"] = self.graph.nodes

    fitloop.FitChunk._capture = timed
    return fn


def phase_misaligned(device="cuda", dim=DIM_Y, max_iter=8):
    """The bench.py workload: coreg + unified rigid + scaling at full width;
    then (5b) the same fit uncaptured from a copy of the same init, and (5c)
    the same coreg uncaptured. Returns the kernels' launches and those of
    coreg."""
    t0 = time.perf_counter()
    gts, rigids, chans = _bench_workload(device, dim, misaligned=True)
    inputs = [_moments(c[0]) for c in chans]
    print(f"[bench] phantom + degrade {time.perf_counter() - t0:.2f} s")

    coreg = {}
    affine_align = _timed("affine_align", coreg, keep_args=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    x, y, sett = unires_torch.init(chans, unires_torch.Settings(
        device=device, vx=1.0, do_print=1, write_out=False, tolerance=0,
        max_iter=max_iter, sched_num=3, reg_scl=4.0, do_coreg=True,
        unified_rigid=True, scaling=True))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    run_mod.affine_align = affine_align
    peak_init = torch.cuda.max_memory_allocated()
    init_copy = copy.deepcopy((x, y, sett))  # for the uncaptured run (5b)
    tri = y[0].dat.clone()
    mat_a = np.asarray(sett.mat_coreg)
    n_grad0, syncs0 = pull_grad.launches, to_host.syncs
    cap = {}
    capture = _timed_captures(cap)
    t0 = time.perf_counter()
    y, R, jtv, obj, n_iter = fit_solver(x, y, sett)
    dat_y, _, _, _ = write_data(x, y, sett, jtv=jtv)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    fitloop.FitChunk._capture = capture
    syncs = (to_host.syncs - syncs0) / max(n_iter, 1)
    launches, stencils = _counts(), _stencil_counts()
    blurs, gn = _blur_counts(), gn_stats.gn_moments.launches
    peak = torch.cuda.max_memory_allocated()

    n_coreg = coreg["launches"]
    require(n_coreg["pull_grad"] > 0 and n_coreg["pull"] > 0,
            "coreg launched no pull or pull_grad")
    _print_levels("coreg", coreg["levels"])
    print(f"[coreg] {coreg['s']:.3f} s in {len(coreg['levels'])} levels "
          f"(host loop: {HOST_NMI['coreg_s']} s) | host syncs "
          f"{coreg['syncs']} (host loop: {HOST_NMI['coreg_syncs']}) | "
          f"launches {n_coreg} | "
          f"init {t_init:.3f} s, peak {peak_init / 2 ** 30:.3f} GiB")
    _check_level_syncs("coreg", coreg)
    require(launches["pull_grad"] - n_grad0 > 0,
            "the rigid update launched no pull_grad")
    require(launches["pull"] > 0 and launches["push"] > 0,
            f"a kernel of the path never launched: {launches}")
    require(all(n > 0 for n in stencils.values()),
            f"a stencil of the path never launched: {stencils}")
    require(all(n > 0 for n in blurs.values()),
            f"a blur pass of the path never launched: {blurs}")
    require(gn > 0, "the rigid GN statistics never launched their kernel")
    _check_fit(dat_y, y, obj, jtv, n_iter, max_iter)
    fig = _figures(inputs, x, y, sett, obj, n_iter, gts[0], tri, device)
    _check_vs_jax("bench", fig, converged=False)
    psnr, ratio = fig["psnr"], fig["sr_vs_trilinear"]
    scl = [o.po.scl for xc in x for o in xc]
    require(all(np.isfinite(R).ravel()) and all(np.isfinite(scl)),
            "non-finite pose or scale")
    print(f"[bench] dims {tuple(y[0].dim)} x 3 | init {t_init:.3f} s "
          f"(coreg {coreg['s']:.3f} s, {n_coreg['pull_grad']} pull_grad) | "
          f"fit {t_fit:.3f} s, {t_fit / n_iter:.4f} s/iter (host loop: "
          f"{HOST_LOOP['s_iter']}), of it {cap['n']} warm-up and capture "
          f"{cap['s']:.3f} s, {(t_fit - cap['s']) / n_iter:.4f} s/iter "
          f"without, n_iter {n_iter} | nll {obj[:, 0].tolist()} | "
          f"psnr {psnr:.3f} dB | sr_vs_trilinear {ratio:.4f} | peak mem init "
          f"{peak_init / 2 ** 30:.3f} GiB (host loop: "
          f"{HOST_LOOP['init_peak']}), all {peak / 2 ** 30:.3f} GiB | host "
          f"syncs/iter {syncs:.3f} (host loop: {HOST_LOOP['syncs']}) | "
          f"launches {launches}, stencils {stencils}, blurs {blurs}, "
          f"gn_stats {gn}")
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
    require(peak_init <= INIT_PEAK_GIB * 2 ** 30,
            f"init's peak memory {peak_init / 2 ** 30:.3f} GiB > "
            f"{INIT_PEAK_GIB} GiB")
    require(syncs <= SYNCS_PER_ITER,
            f"{syncs} host syncs per iteration > {SYNCS_PER_ITER}")

    # 5b: the same iterations uncaptured, every decision read on the host
    syncs0 = to_host.syncs
    xu, _, _, obj_u, n_u, s_u = _fit_copy(init_copy, capture=False)
    syncs_u = (to_host.syncs - syncs0) / max(n_u, 1)
    dq = float(np.abs(_poses(xu) - _poses(x)).max())
    print(f"[graph] {max_iter} iterations captured (chunks of "
          f"{min(sett.chunk_iters, max_iter)}) vs uncaptured, from one init: "
          f"traces equal {np.array_equal(obj, obj_u)}, max |dq| {dq:.3e} | "
          f"host syncs/iter captured {syncs:.3f}, uncaptured {syncs_u:.3f} | "
          f"s/iter captured {t_fit / n_iter:.4f} (write_data included), "
          f"uncaptured {s_u / n_u:.4f}")
    require(n_u == n_iter and np.array_equal(obj, obj_u),
            "the captured trace differs from the uncaptured one")
    require(dq == 0.0, f"the captured poses differ from the uncaptured: {dq}")

    # 5c: the same coreg uncaptured, every decision read on the host
    torch.cuda.synchronize()
    syncs0, t0, since = to_host.syncs, time.perf_counter(), trace.serial()
    mat_u = run_mod.affine_align(*coreg["args"], capture=False,
                                 **coreg["kw"])
    torch.cuda.synchronize()
    t_u, syncs_u = time.perf_counter() - t0, to_host.syncs - syncs0
    levels_u = _levels(since)
    _print_levels("coreg-uncaptured", levels_u)
    same = np.array_equal(np.asarray(coreg["out"]), np.asarray(mat_u))
    print(f"[coreg] captured vs uncaptured, from the same inputs: mat_a "
          f"equal {same}, max |d| "
          f"{float(np.abs(np.asarray(coreg['out']) - mat_u).max()):.3e} | "
          f"seconds captured {coreg['s']:.3f}, uncaptured {t_u:.3f} | host "
          f"syncs captured {coreg['syncs']}, uncaptured {syncs_u}")
    require(same, "the captured coreg's mat_a differs from the uncaptured")
    return launches, n_coreg, stencils, blurs, gn


def _residual(mat, true):
    """(|t| mm, angle rad, isotropic scale) of the world transform taking
    the true placement ``true`` of a volume to its recovered one ``mat``."""
    err = mat @ np.linalg.inv(true)
    scale = float(np.cbrt(np.linalg.det(err[:3, :3])))
    ang = float(np.arccos(np.clip((np.trace(err[:3, :3] / scale) - 1.0) / 2.0,
                                  -1, 1)))
    return float(np.linalg.norm(err[:3, 3])), ang, scale


def _atlas_grid(vx):
    """(mat, dim) of the common output grid at voxel size ``vx``: the atlas
    'brain' box, padded to the smaller of 2 * 2^k and 3 * 2^k up to 256 and
    centred (tests/test_atlas_geometry.py:56-83)."""
    mat_mu, dim_mm = bb_atlas(fov="brain")
    dim = np.floor(dim_mm / vx)
    ndim = np.minimum(ceil_pow(dim, p=2.0, l=2.0, mx=256),
                      ceil_pow(dim, p=2.0, l=3.0, mx=256))
    mat = mat_mu @ affine_diag(vx) @ affine_matrix_classic(
        -np.round((ndim - dim) / 2.0))
    return mat, tuple(int(d) for d in ndim)


def _label_of(x):
    """A label volume of an observation: 0 for the background, 1 to 4 for
    the intensity quartiles of the foreground."""
    edges = np.quantile(x[x > 150.0], [0.25, 0.5, 0.75])
    return np.digitize(x, np.r_[150.0, edges]).astype(np.float32)


def phase_atlas(tmp, device="cuda", dim=DIM_Y, max_iter=4, vx=1.0):
    """common_output + a label at full width: coreg, atlas alignment, crop,
    pow 256, then ``max_iter`` iterations with rigid and scaling."""
    gts, rigids, chans = _bench_workload(device, dim, misaligned=True)
    # headers: the phantom's atlas-frame placement, displaced by T_SYNTH
    for ch in chans:
        ch[1] = T_SYNTH @ MAT_MNI @ ch[1]
    lab = _label_of(chans[0][0])
    pth = os.path.join(tmp, "label.nii.gz")
    nifti_save(lab, pth, affine=chans[0][1])

    rec = {}
    atlas_align = _timed("atlas_align", rec)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pull.launches = push.launches = pull_grad.launches = 0
    t0 = time.perf_counter()
    x, y, sett = unires_torch.init(chans, unires_torch.Settings(
        device=device, vx=vx, do_print=1, write_out=False, tolerance=0,
        max_iter=max_iter, sched_num=3, reg_scl=4.0, do_coreg=True,
        unified_rigid=True, scaling=True, common_output=True,
        label=(pth, (0, 0))))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    run_mod.atlas_align = atlas_align
    n_init = (pull.launches, pull_grad.launches)
    y, R, jtv, obj, n_iter = fit_solver(x, y, sett)
    dat_y, _, _, _ = write_data(x, y, sett, jtv=jtv)
    torch.cuda.synchronize()
    launches = {"pull": pull.launches, "push": push.launches,
                "pull_grad": pull_grad.launches}
    peak = torch.cuda.max_memory_allocated()

    require(rec["launches"]["pull_grad"] > 0,
            "atlas alignment launched no pull_grad")
    _print_levels("atlas", rec["levels"])
    print(f"[atlas] alignment {rec['s']:.3f} s in {len(rec['levels'])} "
          f"levels (host loop: {HOST_NMI['atlas_s']} s for "
          f"{HOST_NMI['atlas_evals']} evaluations) | host syncs "
          f"{rec['syncs']} | launches {rec['launches']}")
    _check_level_syncs("atlas", rec)
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the path never launched: {launches}")
    _check_fit(dat_y, y, obj, jtv, n_iter, max_iter)
    want_mat, want_dim = _atlas_grid(voxel_size(y[0].mat))
    require(tuple(y[0].dim) == want_dim, f"grid {y[0].dim} != {want_dim}")
    require(np.allclose(y[0].mat, want_mat, atol=1e-6),
            f"output affine {y[0].mat} != {want_mat}")
    label = y[0].label
    require(tuple(label.shape) == want_dim, f"label shape {label.shape}")
    vals = set(torch.unique(label).tolist())
    require(vals <= set(np.unique(lab).tolist()) and len(vals) > 1,
            f"label values {vals}")
    print(f"[atlas] dims {tuple(y[0].dim)} x 3 | init {t_init:.3f} s (atlas "
          f"align {rec['s']:.3f} s, {rec['launches']['pull_grad']} NMI "
          f"evaluations) | "
          f"launches in init: pull {n_init[0]}, pull_grad {n_init[1]}; all: "
          f"{launches} | nll {obj[:, 0].tolist()} | label values "
          f"{sorted(vals)} | peak mem {peak / 2 ** 30:.3f} GiB")
    # each channel's recovered placement against its true one
    for c, o in enumerate(xc[0] for xc in x):
        true = MAT_MNI @ rigids[c] @ np.linalg.solve(T_SYNTH @ MAT_MNI,
                                                     chans[c][1])
        t_mm, ang, scale = _residual(o.mat, true)
        before = _residual(chans[c][1], true)
        print(f"[atlas] channel {c} placement residual (mm, rad): header "
              f"{before[0]:.3f}, {before[1]:.5f} | after init {t_mm:.3f}, "
              f"{ang:.5f}, scale {scale:.4f} | |t| + 90 mm * angle "
              f"{t_mm + 90.0 * ang:.3f}")
        require(t_mm + 90.0 * ang < ATLAS_TOL_MM,
                f"channel {c}: atlas placement off by {t_mm} mm, {ang} rad")
    return launches


def phase_ct_inplane(tmp, devices=("cuda", "cpu")):
    """do_res_origin on a CT-flagged observation and force_inplane_res, with
    a label, on the card against the CPU."""
    rng = np.random.default_rng(5)
    vol = _phantom("t1", (96, 112, 96))[::1, ::1, ::3] - 500.0
    vol = np.ascontiguousarray(vol + 20.0 * rng.standard_normal(
        vol.shape).astype(np.float32))
    mat = affine_matrix_classic([40.0, -25.0, 10.0, 0.06, -0.04, 0.05]) \
        @ affine_diag([0.5, 0.5, 3.0])
    pth = os.path.join(tmp, "ct_label.nii.gz")
    nifti_save(_label_of(vol + 500.0), pth, affine=mat)
    out = {}
    for dev in devices:
        n0 = pull.launches
        x, y, sett = unires_torch.init([[vol, mat]], unires_torch.Settings(
            device=dev, vx=1.0, ct=True, do_res_origin=True,
            force_inplane_res=True, label=(pth, (0, 0)), do_print=0,
            write_out=False, max_iter=1))
        out[dev] = (x[0][0], y[0], pull.launches - n0)
    (xg, yg, ng), (xc, yc, nc) = out[devices[0]], out[devices[1]]
    require(ng > 0 and nc == 0, f"pull launches card {ng}, cpu {nc}")
    require(xg.dim == xc.dim and tuple(yg.dim) == tuple(yc.dim)
            and xg.dim != vol.shape, f"dims {xg.dim} {xc.dim}")
    require(np.array_equal(xg.mat, xc.mat) and np.array_equal(yg.mat, yc.mat),
            "card and CPU affines differ")
    scale = float(np.abs(vol).max())
    errs = [_max_err(a.cpu(), b, scale, "ct/inplane", INIT_TOL)
            for a, b in ((xg.dat, xc.dat), (yg.dat, yc.dat))]
    lab_diff = [float((a.cpu() != b).float().mean())
                for a, b in ((xg.label[0], xc.label[0]), (yg.label, yc.label))]
    # a label may flip where two pulled indicators tie to float32 rounding
    require(max(lab_diff) < 1e-3, f"labels differ: {lab_diff}")
    print(f"[ct] {vol.shape} -> reset origin + in-plane {xg.dim} -> y "
          f"{tuple(yg.dim)} | card vs cpu max abs err x {errs[0]:.3e}, y "
          f"{errs[1]:.3e} (scale {scale:.0f}) | label mismatch share "
          f"{lab_diff} | pull launches {ng}")


def _cli_inputs(tmp, name, seed, shift=None):
    """Two 2 mm channels (t1, t2) of the phantom with noise from ``seed``,
    displaced in the atlas frame by T_SYNTH (and ``shift``), as NIfTI files
    ``<name>_t1.nii.gz`` / ``<name>_t2.nii.gz`` under ``tmp``."""
    rng = np.random.default_rng(seed)
    mat = T_SYNTH @ MAT_MNI @ affine_diag([2.0, 2.0, 2.0])
    if shift is not None:
        mat = affine_matrix_classic(shift) @ mat
    paths = []
    for c in ("t1", "t2"):
        vol = _full_phantom(c)[::2, ::2, ::2]
        vol = vol + 40.0 * rng.standard_normal(vol.shape).astype(np.float32)
        paths.append(os.path.join(tmp, f"{name}_{c}.nii.gz"))
        nifti_save(vol.astype(np.float32), paths[-1], affine=mat)
    return paths


def phase_cli(tmp, device=None):
    """The command line on the card (its default device): two 2 mm channels,
    displaced, through ``--common_output``; outputs read back."""
    paths = _cli_inputs(tmp, "sub", 6)
    out = os.path.join(tmp, "out")
    pull.launches = pull_grad.launches = 0
    t0 = time.perf_counter()
    cli_run([*paths, "--vx", "2.0", "--common_output", "--dir_out", out,
             "--print_info", "0", "--tolerance", "1e-2", "--sched", "0",
             *(["--device", device] if device else [])])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    require(pull.launches > 0 and pull_grad.launches > 0,
            "the command line launched no kernel")
    want_mat, want_dim = _atlas_grid(np.array([2.0, 2.0, 2.0]))
    names = sorted(os.listdir(out))
    require(names == ["u_sub_t1.nii.gz", "u_sub_t2.nii.gz"], f"wrote {names}")
    for nam in names:
        dat, hdr = nifti_load(os.path.join(out, nam))
        require(dat.shape == want_dim, f"{nam}: shape {dat.shape}")
        require(np.allclose(hdr.affine, want_mat, atol=1e-4),
                f"{nam}: affine {hdr.affine}")
        require(bool(np.isfinite(dat).all()) and float(dat.max()) > 0,
                f"{nam}: empty or non-finite")
    print(f"[cli] unires-torch {len(paths)} x (91, 109, 91) --common_output "
          f"--vx 2: {secs:.2f} s | outputs {names} {want_dim} | launches "
          f"pull {pull.launches}, pull_grad {pull_grad.launches}")


def _counts():
    return {"pull": pull.launches, "push": push.launches,
            "pull_grad": pull_grad.launches}


def _fov_counts():
    return {"pull": pull.fov_launches, "push": push.fov_launches}


def _stencil_counts():
    """The finite-difference stencils' launches, by phase 3's entry names."""
    return {"gradient": fd.im_gradient.launches,
            "divergence": fd.im_divergence.launches,
            "membrane": fd.DtD.launches}


def _blur_counts():
    """The blur passes' launches, by phase 3's direction names."""
    return {"down": conv.blur_down_sep.launches,
            "up": conv.blur_up_sep.launches}


def _reset_counts():
    pull.launches = push.launches = pull_grad.launches = 0
    pull.fov_launches = push.fov_launches = 0
    for f in fd.STENCILS + conv.BLURS + (gn_stats.gn_moments,):
        f.launches = 0


def _bench_init(device, dim, max_iter, seed=0, **kw):
    """``init`` of the misaligned bench workload drawn from ``seed``."""
    _, _, chans = _bench_workload(device, dim, misaligned=True, seed=seed)
    return unires_torch.init(chans, unires_torch.Settings(
        device=device, vx=1.0, do_print=0, write_out=False, tolerance=0,
        max_iter=max_iter, sched_num=3, reg_scl=4.0, do_coreg=True,
        unified_rigid=True, scaling=True, **kw))


def _fit_copy(init, capture=None, **kw):
    """A fit from a deep copy of ``init`` = (x, y, sett) with settings
    ``kw`` (``capture=False``: uncaptured on the card); returns (x, y, R,
    obj, n_iter, seconds)."""
    x, y, sett = copy.deepcopy(init)
    for k, v in kw.items():
        setattr(sett, k, v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y, R, _, obj, n_iter = fit_solver(x, y, sett, capture=capture)
    torch.cuda.synchronize()
    return x, y, R, obj, n_iter, time.perf_counter() - t0


def _vol_diff(ya, yb):
    """Largest |a - b| over the channels, relative to the largest |b|."""
    return max(float((a.dat - b.dat).abs().max() / b.dat.abs().max())
               for a, b in zip(ya, yb))


def _poses(x):
    return np.stack([o.rigid_q for xc in x for o in xc])


def phase_resume(init, tmp, max_iter=8):
    """8a: uninterrupted, cut with checkpoints, resumed; from one init."""
    path = os.path.join(tmp, "ckpt", "state.npz")
    half = max_iter // 2
    # chunk_iters = half in all three runs: the uninterrupted run then
    # refreshes the CG preconditioner's data-term diagonals at the very
    # iteration where the resumed one must recompute them. At the default
    # cadence (16) it keeps those of iteration 0: that run is compared too,
    # and its difference printed, not required.
    xd, yd, _, obj_d, _, s_full = _fit_copy(init, max_iter=max_iter)
    xf, yf, _, obj_f, n_f, _ = _fit_copy(init, max_iter=max_iter,
                                         chunk_iters=half)
    writes = []
    save = fit_mod.save_checkpoint

    def timed_save(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(*a, **kw)
        writes.append(time.perf_counter() - t0)
        return out

    fit_mod.save_checkpoint = timed_save
    _, _, _, obj_c, n_c, _ = _fit_copy(
        init, max_iter=half, chunk_iters=half, checkpoint_every=2,
        checkpoint_path=path)
    fit_mod.save_checkpoint = save
    require(os.path.exists(path), "no checkpoint file was written")
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    with np.load(path, allow_pickle=False) as f:
        keys = {k: f[k].shape for k in f.files}
    t_load = time.perf_counter() - t0
    require(keys["obj_trace"] == (half, 3) and len(keys) == 14,
            f"checkpoint holds {keys}")
    xr, yr, _, obj_r, n_r, _ = _fit_copy(
        init, max_iter=max_iter, chunk_iters=half, checkpoint_path=path,
        resume=True)

    require(n_f == n_r == max_iter and n_c == half
            and obj_r.shape == (max_iter, 3),
            f"n_iter full {n_f} cut {n_c} resumed {n_r}, trace {obj_r.shape}")
    require(np.array_equal(obj_r[:half], obj_c),
            "the resumed trace does not begin with the interrupted run's")
    same_head = np.array_equal(obj_c, obj_f[:half])
    rel = _rel_trace(obj_r[half:, 0], obj_f[half:, 0])
    dvol = _vol_diff(yr, yf)
    dq = float(np.abs(_poses(xr) - _poses(xf)).max())
    print(f"[resume] nll uninterrupted {obj_f[:, 0].tolist()}")
    print(f"[resume] nll resumed       {obj_r[:, 0].tolist()}")
    print(f"[resume] rows 1-{half} of the cut run equal the uninterrupted "
          f"run's digit for digit: {same_head} | rows {half + 1}-{max_iter} "
          f"rel {rel:.3e} | volumes {dvol:.3e} of scale | poses max |dq| "
          f"{dq:.3e} | checkpoint {size / 1e6:.1f} MB, {len(writes)} writes "
          f"of {[round(w, 2) for w in writes]} s, load {t_load:.2f} s | "
          f"{max_iter} iterations uninterrupted {s_full:.3f} s")
    print(f"[resume] against the uninterrupted run at the default "
          f"chunk_iters (diagonals of iteration 0 throughout): rows "
          f"{half + 1}-{max_iter} rel "
          f"{_rel_trace(obj_r[half:, 0], obj_d[half:, 0]):.3e} | volumes "
          f"{_vol_diff(yr, yd):.3e} of scale | poses max |dq| "
          f"{float(np.abs(_poses(xr) - _poses(xd)).max()):.3e}")
    require(rel <= RESUME_TOL["trace"], f"resumed trace rel {rel}")
    require(dvol <= RESUME_TOL["vol"], f"resumed volumes differ by {dvol}")
    require(dq <= RESUME_TOL["pose"], f"resumed poses differ by {dq}")
    return xd, yd, obj_d, s_full


def phase_trace(init, tmp):
    """8b: 2 iterations under ``profile_dir``; the trace names the kernels,
    one kernel event per launch the kernels counted (the graph's replays
    included)."""
    d = os.path.join(tmp, "trace")
    _reset_counts()
    _, _, _, obj, n_iter, secs = _fit_copy(init, max_iter=2, profile_dir=d)
    launches = _counts()
    files = glob.glob(os.path.join(d, "*.pt.trace.json"))
    require(len(files) == 1, f"trace files: {files}")
    size = os.path.getsize(files[0])
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    named = {k: sum(1 for e in events if e.get("cat") == "kernel"
                    and f"::{k}<" in e.get("name", ""))
             for k in ("pull_kernel", "push_kernel", "pull_grad_kernel")}
    print(f"[trace] 2 iterations under profile_dir: {secs:.2f} s, "
          f"{os.path.basename(files[0])} {size / 1e6:.2f} MB | kernel "
          f"events {named} | launches counted {launches}")
    require(size > 0 and n_iter == 2, "empty trace")
    require(all(named[f"{k}_kernel"] == launches[k] > 0
                for k in ("pull", "push")),
            f"the trace does not hold every launch of the hand-written "
            f"kernels: events {named}, launches {launches}")


def _batch_fit(inits, **kw):
    """``fit_batch`` of deep copies of ``inits`` (subject 0's settings,
    ``kw`` set on them) with the counters set to 0 just before it and read
    just after: (xs, results, record) with the seconds, launches, host
    syncs, peak memory, warm-up + capture seconds and graph nodes."""
    from unires_torch.parallel.fit_batch import fit_batch

    capture = kw.pop("capture", None)
    xs, ys, setts = (list(t) for t in zip(*copy.deepcopy(inits)))
    for k, v in kw.items():
        setattr(setts[0], k, v)
    cap = {}
    wrapped = _timed_captures(cap)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    syncs0 = to_host.syncs
    t0 = time.perf_counter()
    res = fit_batch(xs, ys, setts[0], capture=capture)
    torch.cuda.synchronize()
    rec = dict(s=time.perf_counter() - t0, launches=_counts(),
               syncs=to_host.syncs - syncs0,
               peak=torch.cuda.max_memory_allocated(),
               setup_s=cap.get("s", 0.0), captures=cap.get("n", 0),
               nodes=cap.get("nodes"))
    fitloop.FitChunk._capture = wrapped
    return xs, res, rec


def _against_single(tag, b, xb, resb, xw, yw, objw, nw):
    """A subject of a batch against its single fit: n_iter equal, the trace
    and volumes within BATCH_TOL. Prints a line."""
    yb, _, jtvb, objb, nb = resb
    require(nb == nw, f"{tag} subject {b}: n_iter {nb} != {nw}")
    require(bool(torch.isfinite(jtvb).all()), f"{tag} subject {b}: jtv")
    rel = _rel_trace(objb[:, 0], objw[:, 0])
    dvol = _vol_diff(yb, yw)
    dq = float(np.abs(_poses(xb) - _poses(xw)).max())
    print(f"[{tag}] subject {b} in the batch vs alone: nll "
          f"{objb[:, 0].tolist()} | equal digit for digit "
          f"{np.array_equal(objb, objw)} | rel {rel:.3e} | volumes "
          f"{dvol:.3e} of scale | max |dq| {dq:.3e}")
    require(rel <= BATCH_TOL["trace"], f"{tag} subject {b}: trace rel {rel}")
    require(dvol <= BATCH_TOL["vol"], f"{tag} subject {b}: volumes {dvol}")


def phase_batch(init0, full0, tmp, device="cuda", dim=DIM_Y, max_iter=8):
    """8c: two subjects through ``fit_batch`` (one stacked chunk) against
    their single fits. Returns the batch's launches and subject 1's init."""
    t0 = time.perf_counter()
    y0 = init0[1]
    init1 = _bench_init(device, dim, max_iter, seed=1,
                        force_y_space=(y0[0].mat, y0[0].dim))
    torch.cuda.synchronize()
    print(f"[batch] subject 1 (seed 1) init on subject 0's grid "
          f"{time.perf_counter() - t0:.2f} s")
    xs, res, rec = _batch_fit((init0, init1), do_print=1)
    launches = rec["launches"]

    _reset_counts()
    x1, y1, _, obj1, n1, s_single = _fit_copy(init1, max_iter=max_iter)
    single = _counts()
    xf0, yf0, obj0, s_full0 = full0
    for b, (xw, yw, objw) in enumerate(((xf0, yf0, obj0), (x1, y1, obj1))):
        require(len(objw) == max_iter, f"subject {b}: single n_iter")
        _against_single("batch", b, xs[b], res[b], xw, yw, objw, max_iter)
    require(not np.array_equal(res[0][3], res[1][3]),
            "the two subjects gave one trace")
    ratio = {k: launches[k] / max(single[k], 1) for k in launches}
    chunks = -(-max_iter // min(max_iter, int(init0[2].chunk_iters)))
    print(f"[batch] 2 subjects x {max_iter} iterations {rec['s']:.3f} s | "
          f"subject 1 alone {s_single:.3f} s, subject 0 alone {s_full0:.3f} s"
          f" | batch / sum of singles "
          f"{rec['s'] / (s_single + s_full0):.3f} | warm-up + capture "
          f"{rec['setup_s']:.3f} s ({rec['captures']} captures, "
          f"{rec['nodes']} graph nodes) | host syncs {rec['syncs']} "
          f"({chunks} chunks, {rec['captures']} captures) | peak mem "
          f"{rec['peak'] / 2 ** 30:.3f} GiB | launches {launches}, subject "
          f"1 alone {single}, ratio "
          f"{ {k: round(v, 2) for k, v in ratio.items()} }")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the batch never launched: {launches}")
    require(rec["captures"] == 1, f"{rec['captures']} captures for one batch")
    require(rec["syncs"] <= chunks + rec["captures"],
            f"{rec['syncs']} host syncs for {chunks} chunks")
    lo, hi = BATCH_LAUNCH_RATIO
    require(all(lo <= v <= hi for v in ratio.values()),
            f"batch launches are not {lo}-{hi}x one subject's: {ratio}")
    return launches, init1


def phase_batch4(init0, init1, device="cuda", dim=DIM_Y):
    """8d: four subjects in one batch, uncaptured and captured, against
    each other and against their single fits."""
    iters = BATCH4_ITERS
    y0 = init0[1]
    t0 = time.perf_counter()
    inits = [init0, init1] + [
        _bench_init(device, dim, iters, seed=s,
                    force_y_space=(y0[0].mat, y0[0].dim))
        for s in BATCH4_SEEDS[2:]]
    torch.cuda.synchronize()
    print(f"[batch4] inits of subjects {BATCH4_SEEDS[2:]} on subject 0's "
          f"grid {time.perf_counter() - t0:.2f} s")
    B = len(inits)
    singles = [_fit_copy(i, max_iter=iters) for i in inits]
    _, res_u, rec_u = _batch_fit(inits, max_iter=iters, capture=False)
    xs, res, rec = _batch_fit(inits, max_iter=iters)
    same = [np.array_equal(r[3], u[3]) for r, u in zip(res, res_u)]
    print(f"[batch4] captured vs uncaptured traces equal digit for digit: "
          f"{same}")
    require(all(same), "a captured batch trace differs from the uncaptured")
    for b, (x1, y1, _, obj1, n1, _) in enumerate(singles):
        _against_single("batch4", b, xs[b], res[b], x1, y1, obj1, n1)
    s_sum = sum(r[-1] for r in singles)
    print(f"[batch4] {B} subjects x {iters} iterations {rec['s']:.3f} s "
          f"({rec['s'] / (B * iters):.4f} s per subject iteration) | "
          f"uncaptured {rec_u['s']:.3f} s | singles "
          f"{[round(r[-1], 3) for r in singles]} s, batch / sum "
          f"{rec['s'] / s_sum:.3f} | warm-up + capture "
          f"{rec['setup_s']:.3f} s ({rec['nodes']} graph nodes) | host "
          f"syncs {rec['syncs']} | peak mem {rec['peak'] / 2 ** 30:.3f} GiB "
          f"| launches {rec['launches']}")
    require(all(v > 0 for v in rec["launches"].values()),
            f"a kernel of the batch of 4 never launched: {rec['launches']}")


def phase_shard_cli(tmp):
    """8c, the command line: ``--shard`` with ``--common_output`` on two
    subjects of two 2 mm channels; a is phase 7's subject, b another noise
    seed lying 6 mm and 0.03 rad off."""

    groups = [",".join(_cli_inputs(tmp, "a", 6)),
              ",".join(_cli_inputs(tmp, "b", 7,
                                   shift=[6.0, -4.0, 3.0, 0.03, 0.0, -0.02]))]
    out = os.path.join(tmp, "out_shard")
    _reset_counts()
    t0 = time.perf_counter()
    cli_run([*groups, "--shard", "--vx", "2.0", "--common_output",
             "--dir_out", out, "--print_info", "0", "--tolerance", "1e-2",
             "--sched", "0"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    want_mat, want_dim = _atlas_grid(np.array([2.0, 2.0, 2.0]))
    names = sorted(os.listdir(out))
    require(names == ["u_a_t1.nii.gz", "u_a_t2.nii.gz", "u_b_t1.nii.gz",
                      "u_b_t2.nii.gz"], f"wrote {names}")
    vols = []
    for nam in names:
        dat, hdr = nifti_load(os.path.join(out, nam))
        require(dat.shape == want_dim, f"{nam}: shape {dat.shape}")
        require(np.allclose(hdr.affine, want_mat, atol=1e-4),
                f"{nam}: affine {hdr.affine}")
        require(bool(np.isfinite(dat).all()) and float(dat.max()) > 0,
                f"{nam}: empty or non-finite")
        vols.append(dat)
    require(not np.array_equal(vols[0], vols[2]), "subjects a and b coincide")
    print(f"[batch] unires-torch --shard a_t1,a_t2 b_t1,b_t2 --common_output "
          f"--vx 2: {secs:.2f} s | outputs {names} {want_dim} | launches "
          f"{_counts()}")


def phase_long_runs(tmp, device="cuda", dim=DIM_Y, max_iter=8):
    """Phase 8: resume, trace and batch from one init of the bench workload."""
    t0 = time.perf_counter()
    init0 = _bench_init(device, dim, max_iter)
    torch.cuda.synchronize()
    print(f"[resume] init of the misaligned workload "
          f"{time.perf_counter() - t0:.2f} s")
    full0 = phase_resume(init0, tmp, max_iter)
    phase_trace(init0, tmp)
    launches, init1 = phase_batch(init0, full0, tmp, device, dim, max_iter)
    phase_shard_cli(tmp)
    phase_batch4(init0, init1, device, dim)
    return launches


def phase_converged(smi, device="cuda", dim=DIM_Y):
    """Phase 9: the misaligned bench.py workload fitted to convergence."""
    gts, _, chans = _bench_workload(device, dim, misaligned=True)
    inputs = [_moments(c[0]) for c in chans]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    x, y, sett = unires_torch.init(chans, unires_torch.Settings(
        device=device, vx=1.0, do_print=0, write_out=False, tolerance=1e-4,
        sched_num=3, reg_scl=4.0, do_coreg=True, unified_rigid=True,
        scaling=True))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tri = y[0].dat.clone()
    syncs0 = to_host.syncs
    cap = {}
    capture = _timed_captures(cap)
    t0 = time.perf_counter()
    y, R, jtv, obj, n_iter = fit_solver(x, y, sett)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    fitloop.FitChunk._capture = capture
    syncs = (to_host.syncs - syncs0) / max(n_iter, 1)
    launches, stencils = _counts(), _stencil_counts()
    blurs, gn = _blur_counts(), gn_stats.gn_moments.launches
    peak = torch.cuda.max_memory_allocated()
    fig = _figures(inputs, x, y, sett, obj, n_iter, gts[0], tri, device)
    psnr, ratio = fig["psnr"], fig["sr_vs_trilinear"]
    print(f"[converged] {smi} | dims {tuple(y[0].dim)} x 3, tolerance 1e-4 "
          f"| init {t_init:.3f} s | fit {t_fit:.3f} s, n_iter {n_iter} (host "
          f"loop: {HOST_LOOP['n_iter']}), {t_fit / n_iter:.4f} s/iter, "
          f"{(t_fit - cap['s']) / n_iter:.4f} without the warm-up and "
          f"capture ({cap['s']:.3f} s), host syncs/iter {syncs:.3f} | nll "
          f"first {obj[0, 0]:.6e} last "
          f"{obj[-1, 0]:.6e} | psnr {psnr:.3f} dB (host loop: "
          f"{HOST_LOOP['psnr']}, {psnr - HOST_LOOP['psnr']:+.3f}) | "
          f"sr_vs_trilinear {ratio:.4f} (host loop: {HOST_LOOP['ratio']}, "
          f"{ratio - HOST_LOOP['ratio']:+.4f}) | peak mem "
          f"{peak / 2 ** 30:.3f} GiB | launches {launches}, stencils "
          f"{stencils}, blurs {blurs}, gn_stats {gn}")
    require(n_iter < sett.max_iter, f"no convergence in {n_iter} iterations")
    require(all(n > 0 for n in stencils.values()),
            f"a stencil of the converged fit never launched: {stencils}")
    require(all(n > 0 for n in blurs.values()),
            f"a blur pass of the converged fit never launched: {blurs}")
    require(gn > 0, "the converged fit's rigid GN statistics never launched "
            "their kernel")
    require(bool(torch.isfinite(jtv).all()) and np.isfinite(R).all(),
            "non-finite result")
    steps = _sched_steps(fig["nll"])
    steps_j = _sched_steps(_jax_reference()["nll"])
    print(f"[converged] lambda steps at iterations {steps} (JAX: {steps_j})")
    require(len(steps) == len(steps_j) == len(sett.reg_scl) - 1,
            f"lambda steps at {steps}, JAX's at {steps_j}")
    _check_vs_jax("converged", fig, converged=True)
    require(psnr >= PSNR_FLOOR and ratio <= RATIO_CEIL,
            f"quality floor missed: psnr {psnr} dB, sr_vs_trilinear {ratio}")
    return launches, stencils, blurs, gn


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _adiff(a, b):
    return float((a - b).abs().max())


def _step_diff(got, want, tol, label):
    """(ys of scale, max |dz|, max |dw|, objective rel) between a parallel
    step's (ys, z, w, obj) and make_admm_step's; raises past ``tol``."""
    ys, z, w, obj = got
    ys0, z0, w0, obj0 = want
    d = (_rel(ys, ys0), _adiff(z, z0), _adiff(w, w0),
         float(((obj - obj0).abs() / obj0.abs()).max()))
    print(f"[parallel] {label} vs make_admm_step: ys {d[0]:.3e} of scale | "
          f"z {d[1]:.3e} | w {d[2]:.3e} | obj rel {d[3]:.3e}")
    require(d[0] <= tol["ys"] and d[1] <= tol["zw"] and d[2] <= tol["zw"]
            and d[3] <= tol["obj"], f"{label} differs from make_admm_step")


def _run_steps(step, state, args, iters):
    """``iters`` steps from ``state`` = (ys, z, w) with the other operands
    ``args`` = (xdat, ...); returns the last (ys, z, w, obj) and s/iter."""
    ys, z, w = state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        ys, z, w, *rest = step(ys, z, w, *args)
    torch.cuda.synchronize()
    return (ys, z, w, rest[-1]), (time.perf_counter() - t0) / iters


def phase_parallel(tmp, smi, device="cuda", dim=DIM_Y, iters=3):
    """Phase 10: the sharded and spatial steps on one card (world 1)."""
    import torch.distributed as dist

    from unires_torch.models.forward import make_obs_ops
    from unires_torch.parallel.sharding import (build_mesh, init_multihost,
                                                make_sharded_admm_step,
                                                shard_state)
    from unires_torch.parallel.spatial import (build_spatial_mesh,
                                               make_spatial_admm_step,
                                               make_spatial_admm_step_sr,
                                               shard_spatial)
    from unires_torch.solvers.admm import (admm_aux, make_admm_step,
                                           step_size)

    print(f"[parallel] torch.distributed NCCL available: "
          f"{dist.is_nccl_available()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    init_multihost(f"file://{os.path.join(tmp, 'rendezvous')}", 1, 0,
                   device=device)
    try:
        rng = np.random.default_rng(4)
        gts = [_phantom(c, dim) for c in ("t1", "t2", "pd")]
        chans = [_degrade(g, 2, 75.0, rng, device) for g in gts]
        x, y, sett = unires_torch.init(chans, _settings(device, iters, 0))
        # CG to the spatial tests' depth: the slab preconditioner then
        # stops near the global one's iterate (tests/test_spatial.py)
        sett.cgs_max_iter, sett.cgs_tol = 60, 1e-6
        po = x[0][0].po
        require(all(np.array_equal(o.po.M_sr(), po.M_sr())
                    and o.po.dim_x == po.dim_x for xc in x for o in xc),
                "the channels' geometries differ")
        C, dim_y = len(y), tuple(y[0].dim)
        ys = torch.stack([yc.dat for yc in y])
        z, w = admm_aux(C, dim_y, device)
        xdat = torch.stack([xc[0].dat for xc in x])
        tau = [xc[0].tau for xc in x]
        lam = [yc.lam for yc in y]
        rho = step_size(x, y, sett)
        M, Minv = obs_dyn_args(po, "super-resolution")

        # the reference: make_admm_step, the unsharded solver
        ref = make_admm_step(x, y, sett)
        want, s_ref = _run_steps(ref, (ys, z, w), (
            [[xc[0].dat] for xc in x], [[M]] * C, [[Minv]] * C,
            [[0.0]] * C, [[t] for t in tau], lam, rho), iters)

        # (a) the (batch, channel) sharded step, B = 1 and C = 3
        mesh = build_mesh(1)
        step = make_sharded_admm_step(po, sett.method, sett, mesh)
        st = shard_state(mesh, ys[None], z[None], w[None], xdat[None])
        got, s_sh = _run_steps(step, st[:3], (
            st[3], M, Minv, np.zeros((1, C)), np.asarray([tau]),
            np.asarray([lam]), rho), iters)
        _step_diff((got[0][0], got[1][0], got[2][0], got[3]), want,
                   SHARDED_TOL, f"sharded (mesh {mesh.shape})")

        # (b) the one-slab spatial steps, each counted on its own: the
        # counters are set to 0 just before its steps and read just after
        smesh = build_spatial_mesh(1)
        step_sr = make_spatial_admm_step_sr(po, sett, smesh)
        st = shard_spatial(smesh, ys, z, w, xdat)[:3]
        _reset_counts()
        got, s_sr = _run_steps(step_sr, st, (xdat, M, Minv, [0.0] * C, tau,
                                             lam, rho), iters)
        launches = {"SR": (_counts(), _fov_counts())}
        blurs = {"SR": _blur_counts()}
        _step_diff(got, want, SLAB_TOL, "spatial SR (1 slab)")

        # the denoising chain: observations on the recon grid at a shift
        # and a small rotation. Its CG runs deeper: at 60 steps the
        # slab-local and the global preconditioners stop at different
        # iterates (printed, not required), at 200 / 1e-8 both reach the
        # solution
        po_d = proj_info(dim_y, y[0].mat, dim_y, y[0].mat,
                         rigid=affine_matrix_classic(DENOISE_POSE))
        M_d, Minv_d = obs_dyn_args(po_d, "denoising")
        A_d = make_obs_ops(po_d, "denoising")[0]
        xd = torch.stack([A_d(yc.dat, M_d, Minv_d, 0.0) for yc in y])
        x_d = [[copy.copy(xc[0])] for xc in x]
        for c, xc in enumerate(x_d):
            xc[0].po, xc[0].dat = po_d, xd[c]
        ref_args = ([[xd[c]] for c in range(C)], [[M_d]] * C, [[Minv_d]] * C,
                    [[0.0]] * C, [[t] for t in tau], lam, rho)
        slab_args = (xd, M_d, Minv_d, tau, lam, rho)
        sett_d = sett.copy()
        sett_d.method = "denoising"
        shallow = (
            _run_steps(make_admm_step(x_d, y, sett_d), (ys, z, w), ref_args,
                       iters)[0],
            _run_steps(make_spatial_admm_step(po_d, sett_d, smesh),
                       (ys, z, w), slab_args, iters)[0])
        print(f"[parallel] spatial denoising (1 slab) vs make_admm_step at "
              f"CG {sett_d.cgs_max_iter} / {sett_d.cgs_tol:g} (not "
              f"required): ys {_rel(shallow[1][0], shallow[0][0]):.3e} of "
              f"scale | z {_adiff(shallow[1][1], shallow[0][1]):.3e} | w "
              f"{_adiff(shallow[1][2], shallow[0][2]):.3e}")
        sett_d.cgs_max_iter, sett_d.cgs_tol = 200, 1e-8
        want_d, s_ref_d = _run_steps(make_admm_step(x_d, y, sett_d),
                                     (ys, z, w), ref_args, iters)
        step_den = make_spatial_admm_step(po_d, sett_d, smesh)
        _reset_counts()
        got, s_den = _run_steps(step_den, (ys, z, w), slab_args, iters)
        launches["denoising"] = (_counts(), _fov_counts())
        blurs["denoising"] = _blur_counts()
        _step_diff(got, want_d, SLAB_TOL,
                   f"spatial denoising (1 slab) at CG {sett_d.cgs_max_iter} "
                   f"/ {sett_d.cgs_tol:g}")
        for label, (n, n_fov) in launches.items():
            # every pull and push of a slab step carries the global FOV
            require(all(n[k] > 0 and n_fov[k] == n[k] for k in n_fov),
                    f"spatial {label}: pull and push must each launch, all "
                    f"through FOV = true: launches {n}, FOV = true {n_fov}")
        # the SR step blurs through the kernels; the denoising one has no blur
        require(all(n > 0 for n in blurs["SR"].values())
                and not any(blurs["denoising"].values()),
                f"spatial blur launches {blurs}: SR must launch both passes, "
                f"denoising none")
        peak = torch.cuda.max_memory_allocated()
        print(f"[parallel] {smi} | {C} x {dim_y}, {iters} iterations, s/iter: "
              f"make_admm_step SR {s_ref:.4f}, sharded {s_sh:.4f}, spatial "
              f"SR {s_sr:.4f} | make_admm_step denoising {s_ref_d:.4f}, "
              f"spatial denoising {s_den:.4f} | launches (all, FOV = true) "
              f"{launches}, blurs {blurs} | peak mem "
              f"{peak / 2 ** 30:.3f} GiB")
    finally:
        dist.destroy_process_group()
    return {k: (sum(n[k] for n, _ in launches.values()),
                sum(f.get(k, 0) for _, f in launches.values()))
            for k in ("pull", "push", "pull_grad")}


def main():
    smi = phase_device()
    phase_build()
    rec = phase_kernels()
    phase_small_slice()
    phase_small_misaligned()
    phase_slice()
    launches, launches_coreg, stencils, blurs, gn = phase_misaligned()
    with tempfile.TemporaryDirectory() as tmp:
        launches_atlas = phase_atlas(tmp)
        phase_ct_inplane(tmp)
        phase_cli(tmp)
        launches_batch = phase_long_runs(tmp)
        (launches_converged, stencils_converged, blurs_converged,
         gn_converged) = phase_converged(smi)
        launches_parallel = phase_parallel(tmp, smi)
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    launches_coreg=launches_coreg[name],
                    launches_atlas=launches_atlas[name],
                    launches_batch=launches_batch[name],
                    launches_converged=launches_converged[name],
                    launches_parallel=launches_parallel[name][0],
                    launches_parallel_fov=launches_parallel[name][1],
                    **rec[name])
               for name in ("pull", "push", "pull_grad")]
    for label, r in rec["stencils"].items():
        entry = label.split("/")[0]
        r.update(launches=stencils[entry],
                 launches_converged=stencils_converged[entry])
    for label, r in rec["blurs"].items():
        direction = label.split("/")[0]
        r.update(launches=blurs[direction],
                 launches_converged=blurs_converged[direction])
    for r in rec["gn_stats"].values():
        r.update(launches=gn, launches_converged=gn_converged)
    print(json.dumps({"kernels": kernels, "stencils": rec["stencils"],
                      "blurs": rec["blurs"], "gn_stats": rec["gn_stats"]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
