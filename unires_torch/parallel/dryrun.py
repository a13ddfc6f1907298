"""A dry run of the whole multi-device surface, and the rank workers it and
the multi-rank tests run.

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``: it spawns n ranks
(``parallel.launch.spawn``; gloo on the CPU, NCCL on n CUDA devices) and
runs, on small problems, the (batch, channel) sharded ADMM step on
``build_mesh(n)``, the same on a simulated two-host mesh
(``build_mesh(n, batch=2)``), and the slab-sharded super-resolution step
with its ``sr_halo_bounds``; then ``fit_batch`` on two tiny subjects over
two workers of the caller's device. Every result must be finite.

The ``*_rank`` functions run inside a spawned rank: each builds its mesh,
takes its part of the global inputs (numpy, the same on every rank), runs
the step and returns its part of the outputs as numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import affine_diag
from ..models.forward import obs_dyn_args, proj_apply
from ..models.proj_op import proj_info
from ..pipeline.run import init
from ..settings import Settings
from .fit_batch import fit_batch
from .launch import run_cases, spawn
from .sharding import build_mesh, make_sharded_admm_step, shard_state
from .spatial import (build_spatial_mesh, halo_divergence, halo_gradient,
                      make_spatial_admm_step, make_spatial_admm_step_sr,
                      shard_spatial, _make_slab_precond, _pcg, _psum)


def _np(t):
    return t.detach().cpu().numpy()


def sharded_step_rank(po, method, sett, ys, z, w, xdat, M, Minv, scl, tau,
                      lam, rho, batch=None) -> dict:
    """One sharded step on ``build_mesh(batch=batch)`` from the global
    stacked state; this rank's mesh coordinates and blocks."""
    mesh = build_mesh(batch=batch)
    step = make_sharded_admm_step(po, method, sett, mesh)
    ys, z, w, xd = shard_state(mesh, ys, z, w, xdat)
    ys, z, w, obj = step(ys, z, w, xd, M, Minv, scl, tau, lam, rho)
    return dict(shape=mesh.shape, coords=mesh.coords, ys=_np(ys), z=_np(z),
                w=_np(w), obj=_np(obj))


def spatial_step_rank(kind, po, sett, ys, z, w, xdat, M, Minv, scl, tau, lam,
                      rho) -> dict:
    """One slab step (``kind`` "denoising" or "super-resolution") from the
    global state; this rank's slabs."""
    mesh = build_spatial_mesh()
    ys, z, w, xd = shard_spatial(mesh, ys, z, w, xdat)
    if kind == "denoising":
        step = make_spatial_admm_step(po, sett, mesh)
        ys, z, w, obj = step(ys, z, w, xd, M, Minv, tau, lam, rho)
    else:
        step = make_spatial_admm_step_sr(po, sett, mesh)
        ys, z, w, obj = step(ys, z, w, xd, M, Minv, scl, tau, lam, rho)
    return dict(ys=_np(ys), z=_np(z), w=_np(w), obj=_np(obj))


def halo_stencils_rank(vol, p, vx, which) -> dict:
    """The halo gradient of this rank's slab of ``vol`` (X, Y, Z) and the
    halo divergence of its slab of ``p`` (3, X, Y, Z)."""
    mesh = build_spatial_mesh()
    Xl = vol.shape[0] // mesh.n
    sl = slice(mesh.rank * Xl, (mesh.rank + 1) * Xl)
    g = halo_gradient(torch.from_numpy(vol[sl].copy()), vx, which, mesh)
    d = halo_divergence(torch.from_numpy(p[:, sl].copy()), vx, which, mesh)
    return dict(grad=_np(g), div=_np(d))


def slab_pcg_rank(rhs, vx, tau, lam, rho, max_iter, tol) -> dict:
    """The slab y-solve (tau I + rho lam^2 D^T D) x = rhs by PCG with the
    slab-local DCT preconditioner and by plain CG: this rank's slabs of
    both solutions and both iteration counts."""
    mesh = build_spatial_mesh()
    Xl = rhs.shape[0] // mesh.n
    b = torch.from_numpy(rhs[mesh.rank * Xl:(mesh.rank + 1) * Xl].copy())
    factory = _make_slab_precond(Xl, rhs.shape, vx)
    psum = _psum(mesh)

    def lhs(v):
        return rho * lam * lam * halo_divergence(
            halo_gradient(v, vx, "forward", mesh), vx, "forward",
            mesh) + tau * v

    out = {}
    for name, P in (("pcg", factory(tau, rho * lam * lam)), ("cg", None)):
        x, it = _pcg(lhs, b, torch.zeros_like(b), P, psum, max_iter, tol,
                     return_iters=True)
        out[name] = (_np(x), it)
    return out


def tiny_problem(dim_y=(16, 16, 17), thick=4.0, seed=0):
    """A 4 mm (along z) observation of a random volume, as the JAX
    package's ``__graft_entry__._tiny_problem``: (po, gt, x, M, Minv) with
    gt and x numpy."""
    dim_x = (dim_y[0], dim_y[1], int(np.ceil(dim_y[2] / thick)))
    po = proj_info(dim_y, np.eye(4), dim_x, affine_diag([1.0, 1.0, thick]),
                   prof_ip=2, prof_tp=0)
    gt = np.random.default_rng(seed).random(dim_y, dtype=np.float32) * 100
    M, Minv = obs_dyn_args(po, "super-resolution")
    x = proj_apply("A", torch.from_numpy(gt), po, "super-resolution", M=M,
                   scl=0.0).numpy()
    return po, gt, x, M, Minv


def _sharded_case(po, gt, x, M, Minv, B, C, batch):
    dim_y = gt.shape
    sett = Settings(do_print=0, cgs_max_iter=3, cgs_tol=1e-6)
    return (sharded_step_rank, dict(
        po=po, method="super-resolution", sett=sett,
        ys=np.broadcast_to(gt, (B, C) + dim_y).copy(),
        z=np.zeros((B, C, 3) + dim_y, np.float32),
        w=np.zeros((B, C, 3) + dim_y, np.float32),
        xdat=np.broadcast_to(x, (B, C) + x.shape).copy(), M=M, Minv=Minv,
        scl=np.zeros((B, C)), tau=np.ones((B, C)), lam=np.full((B, C), 0.1),
        rho=1.0, batch=batch))


def dryrun_multichip(n: int, device: str = "cuda") -> None:
    """Run the multi-device surface on n ranks (see the module's
    docstring): on n CUDA devices over NCCL, or, with ``device="cpu"``, on
    n CPU processes over gloo. Raises if a rank fails or a result is not
    finite."""
    n = int(n)
    po, gt, x, M, Minv = tiny_problem(dim_y=(8, 8, 9))
    chan = next((c for c in (4, 3, 2) if n % c == 0), 1)
    cases = [_sharded_case(po, gt, x, M, Minv, n // chan, chan, None)]
    if n % 2 == 0:  # a simulated two-host mesh
        cases.append(_sharded_case(po, gt, x, M, Minv, 2, n // 2, 2))

    # the slab-sharded SR step, the full operator chain over n slabs
    dim_ys = (4 * n, 8, 9)
    po_s, gt_s, x_s, M_s, Minv_s = tiny_problem(dim_y=dim_ys, seed=1)
    sett_s = Settings(do_print=0, cgs_max_iter=3, cgs_tol=1e-6)
    sett_s.method, sett_s.do_proj = "super-resolution", True
    cases.append((spatial_step_rank, dict(
        kind="super-resolution", po=po_s, sett=sett_s, ys=gt_s[None] * 0.5,
        z=np.zeros((1, 3) + dim_ys, np.float32),
        w=np.zeros((1, 3) + dim_ys, np.float32), xdat=x_s[None], M=M_s,
        Minv=Minv_s, scl=[0.0], tau=[1.0], lam=[0.1], rho=1.0)))

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    outs = spawn(run_cases, n, backend, cases)
    for rank, res in enumerate(outs):
        for case in res:
            for key in ("ys", "z", "w", "obj"):
                if not np.isfinite(case[key]).all():
                    raise RuntimeError(f"dryrun: rank {rank}: {key} is not "
                                       "finite")

    # the batch-of-subjects fit: two tiny subjects over two workers
    subs = []
    for seed in (0, 1):
        po_b, _, x_b, _, _ = tiny_problem(dim_y=(12, 12, 13))
        x_b = x_b + 2.0 * np.random.default_rng(seed).standard_normal(
            x_b.shape).astype(np.float32)
        subs.append(init([[x_b, po_b.mat_x]], Settings(
            device=device, vx=1.0, do_coreg=False, do_print=0, max_iter=4,
            chunk_iters=2, sched_num=0, write_out=False, cgs_max_iter=3,
            scaling=True, unified_rigid=True, tolerance=1e-6)))
    res = fit_batch([s[0] for s in subs], [s[1] for s in subs], subs[0][2],
                    devices=[device, device])
    for yb, _, _, objb, nitb in res:
        if not (torch.isfinite(yb[0].dat).all() and np.isfinite(objb).all()
                and nitb >= 1):
            raise RuntimeError("dryrun: fit_batch gave a non-finite result")
