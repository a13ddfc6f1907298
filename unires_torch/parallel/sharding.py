"""Multi-device sharding of the ADMM solver over subjects and channels.

The counterpart of ``unires_tpu.parallel.sharding``. The scale-out story of
this model family:

  * **batch** (data parallel): independent subjects, no collective in the
    solve;
  * **channel**: the y-updates of different channels are independent given
    (z, w); the only cross-channel coupling of the whole algorithm is the
    joint-total-variation shrinkage, sum_c sum_d (w/rho + lam D y)^2
    (reference unires/_update.py:171), one all-reduce over the channel
    group per outer iteration.

One process per device, joined by ``torch.distributed`` (NCCL between CUDA
devices, gloo between CPU processes), takes the place of the JAX package's
device mesh: :func:`build_mesh` factors the world into (batch, channel) as
the JAX package does and creates one process group per batch row; each rank
holds its (B_loc, C_loc) block of the stacked state (:func:`shard_state`)
and runs :func:`make_sharded_admm_step` on it. The problem is
geometry-homogeneous: all observations share one ``ProjOp`` per repeat.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..models.forward import make_obs_ops
from ..models.proj_op import ProjOp
from ..ops.finite_diff import DtD, im_divergence, im_gradient
from ..solvers.admm import dct_apply, dct_matrices, dct_membrane_eigs
from ..solvers.cg import cg


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   device: str = "cuda") -> bool:
    """Join this process to the group of ``torch.distributed``.

    Driven by the arguments or the ``UNIRES_TORCH_COORDINATOR`` /
    ``UNIRES_TORCH_NUM_PROCS`` / ``UNIRES_TORCH_PROC_ID`` environment
    variables; returns False and does nothing when no coordinator is named
    (one process). The coordinator is a ``tcp://host:port`` or ``file://``
    rendezvous (``host:port`` alone means TCP). ``device`` picks the backend:
    NCCL for CUDA, with this process on CUDA device ``process_id`` modulo
    the count (raises when the installed torch has no NCCL); gloo for the
    CPU. Every process calls it once, before its first collective.
    """
    addr = coordinator_address or os.environ.get("UNIRES_TORCH_COORDINATOR")
    if not addr:
        return False
    nproc = num_processes if num_processes is not None else int(
        os.environ.get("UNIRES_TORCH_NUM_PROCS", "1"))
    pid = process_id if process_id is not None else int(
        os.environ.get("UNIRES_TORCH_PROC_ID", "0"))
    if "://" not in addr:
        addr = f"tcp://{addr}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("init_multihost: this torch has no NCCL, "
                               "which CUDA devices need")
        # NCCL binds a rank to the current device: set it before the group
        torch.cuda.set_device(dev.index if dev.index is not None
                              else pid % torch.cuda.device_count())
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_multihost: no backend for device {dev}")
    dist.init_process_group(backend, init_method=addr, world_size=nproc,
                            rank=pid)
    return True


def _rank_device() -> torch.device:
    """The device of this rank: its CUDA device under NCCL, else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@dataclasses.dataclass
class Mesh:
    """This rank's place in the (batch, channel) factorisation of the world.

    ``shape`` = {"batch": B, "channel": C}; ``coords`` = (b, c) of this rank
    (rank = b * C + c, channel the minor axis as in the JAX package);
    ``channel_group`` holds the C ranks of this rank's batch row (the JTV
    all-reduce), ``group`` the world; ``device`` is this rank's device.
    """

    shape: dict
    coords: tuple
    channel_group: object
    group: object
    device: torch.device


def build_mesh(world: int | None = None, batch: int | None = None) -> Mesh:
    """The ('batch', 'channel') mesh over the ranks of the world.

    Without ``batch`` the channel axis takes the first of 4, 3 and 2 that
    divides the world (1 if none does). Multi-host: ranks are numbered
    host-major, so the batch axis, which needs no collective in the solve,
    lands across hosts and every channel group stays within a host. Every
    rank must call it, in the same order as every other collective.
    """
    n = dist.get_world_size()
    if world is not None and int(world) != n:
        raise ValueError(f"build_mesh: world {world} != group size {n}")
    if batch is None:
        chan = next((c for c in (4, 3, 2) if n % c == 0), 1)
        batch = n // chan
    else:
        batch = int(batch)
        if n % batch:
            raise ValueError(f"build_mesh: batch {batch} does not divide {n}")
        chan = n // batch
    rank = dist.get_rank()
    # every rank creates every group, in the same order
    rows = [dist.new_group(list(range(b * chan, (b + 1) * chan)))
            for b in range(batch)]
    return Mesh(shape={"batch": batch, "channel": chan},
                coords=divmod(rank, chan), channel_group=rows[rank // chan],
                group=dist.group.WORLD, device=_rank_device())


def _vx(po: ProjOp) -> tuple:
    vx = np.sqrt((np.asarray(po.mat_y, np.float64)[:3, :3] ** 2).sum(0))
    return tuple(float(v) for v in vx.astype(np.float32))


def make_sharded_admm_step(po: ProjOp | list, method: str, sett,
                           mesh: Mesh) -> Callable:
    """One sharded ADMM iteration: the production solver (DCT-preconditioned,
    residual-stopped CG, the math of ``solvers.admm.make_admm_body``) on
    this rank's (B_loc, C_loc) block.

    ``po``: one ProjOp, or a list over repeats (homogeneous across channels
    and subjects). Signature:
        step(ys, z, w, xdat, M, Minv, scl, tau, lam, rho) -> (ys, z, w, obj)
    with this rank's blocks ys (B_loc, C_loc, *dim_y), z / w (B_loc, C_loc,
    3, *dim_y), xdat (R, B_loc, C_loc, *dim_x) (:func:`shard_state`); the
    small host operands are global: M / Minv (R, 3, 4) shared, scl / tau
    (R, B, C), lam (B, C), rho a scalar. The leading repeat axis may be left
    out with one repeat. ``obj`` (float64, the same on every rank) is the
    batch total of (nll_xy + nll_y, nll_xy, nll_y), as the JAX package's.
    """
    pos = list(po) if isinstance(po, (list, tuple)) else [po]
    R_n = len(pos)
    ops = [make_obs_ops(p, method) for p in pos]
    vx_y = _vx(pos[0])
    dim_y = tuple(int(d) for d in pos[0].dim_y)
    diff = sett.diff
    cg_iter = int(sett.cgs_max_iter)
    cg_tol = float(sett.cgs_tol)
    tiny = 1e-7
    dev = mesh.device
    n_chan = mesh.shape["channel"]
    Cx, Cy, Cz = dct_matrices(dim_y, dev)
    CxT, CyT, CzT = Cx.T, Cy.T, Cz.T
    lamD = dct_membrane_eigs(dim_y, vx_y, dev)
    ones_y = torch.ones(dim_y, dtype=torch.float32, device=dev)

    def y_update(yc, zc, wc, xc, M, Minv, sc, tc, lc, rho):
        rhs = torch.zeros_like(yc)
        cdiag = torch.zeros((), dtype=torch.float32, device=dev)
        for n in range(R_n):
            _, At, AtA = ops[n]
            rhs = rhs + tc[n] * At(xc[n], M[n], Minv[n], sc[n])
            cdiag = cdiag + tc[n] * torch.mean(
                AtA(ones_y, M[n], Minv[n], sc[n]))
        # the prior's factors on the device, as the kernels read them
        s_rhs, s_lhs = torch.tensor([lc, rho * lc * lc], dtype=torch.float32,
                                    device=dev)
        rhs = rhs - im_divergence(wc - rho * zc, vx_y, diff, scale=s_rhs)

        def lhs(v):
            out = DtD(v, vx_y, diff, scale=s_lhs)
            for n in range(R_n):
                out = out + tc[n] * ops[n][2](v, M[n], Minv[n], sc[n])
            return out

        # the DCT-diagonal preconditioner of solvers.admm
        denom = cdiag + rho * lc * lc * lamD

        def precond(v):
            t = dct_apply(v[None], CxT, CyT, CzT)
            return dct_apply(t / denom, Cx, Cy, Cz)[0]

        return cg(lhs, rhs, yc, max_iter=cg_iter, tol=3.0 * cg_tol,
                  precond=precond, stop="residual")

    def step(ys, z, w, xdat, M, Minv, scl, tau, lam, rho):
        if xdat.dim() == ys.dim():  # one repeat, without its axis
            xdat = xdat[None]
        M = np.asarray(M, np.float32)
        Minv = np.asarray(Minv, np.float32)
        if M.ndim == 2:
            M, Minv = M[None], Minv[None]
        scl = np.asarray(scl, np.float64)
        tau = np.asarray(tau, np.float64)
        if scl.ndim == 2:
            scl, tau = scl[None], tau[None]
        rho = float(rho)
        Bl, Cl = ys.shape[:2]
        b0, c0 = mesh.coords[0] * Bl, mesh.coords[1] * Cl
        blk = (slice(b0, b0 + Bl), slice(c0, c0 + Cl))
        scl = scl[(slice(None),) + blk]
        tau = tau[(slice(None),) + blk]
        lam = np.asarray(lam, np.float64)[blk]

        ys = torch.stack([torch.stack([
            y_update(ys[b, c], z[b, c], w[b, c], xdat[:, b, c], M, Minv,
                     [float(v) for v in scl[:, b, c]],
                     [float(v) for v in tau[:, b, c]], float(lam[b, c]), rho)
            for c in range(Cl)]) for b in range(Bl)])

        nll_xy = torch.zeros((), dtype=torch.float64, device=dev)
        for b in range(Bl):
            for c in range(Cl):
                for n in range(R_n):
                    Ay = ops[n][0](ys[b, c], M[n], Minv[n],
                                   float(scl[n, b, c]))
                    xc = xdat[n, b, c]
                    res = torch.where(xc != 0, xc - Ay, 0.0)
                    nll_xy = nll_xy + 0.5 * float(tau[n, b, c]) * (
                        res * res).sum(dtype=torch.float64)

        # the cross-channel JTV reduce: |u|^2 and |D y|^2 summed over the
        # channel group in ONE all-reduce
        Dys = torch.stack([torch.stack([
            float(lam[b, c]) * im_gradient(ys[b, c], vx_y, diff)
            for c in range(Cl)]) for b in range(Bl)])
        u = w / rho + Dys
        sq = torch.stack([torch.sum(u * u, dim=(1, 2)),
                          torch.sum(Dys * Dys, dim=(1, 2))])
        dist.all_reduce(sq, group=mesh.channel_group)
        mag = torch.sqrt(sq[0])
        shrink = torch.clamp(mag - 1.0 / rho, min=0.0) / (mag + tiny)
        z = shrink[:, None, None] * u
        w = w + rho * (Dys - z)

        # the objective: every rank of a batch row holds the same -ln p(y)
        nll = torch.stack([nll_xy,
                           torch.sqrt(sq[1]).sum(dtype=torch.float64)])
        dist.all_reduce(nll, group=mesh.group)
        nll_y = nll[1] / n_chan
        obj = torch.stack([nll[0] + nll_y, nll[0], nll_y])
        return ys, z, w, obj

    return step


def shard_state(mesh: Mesh, ys, z, w, xdat):
    """This rank's blocks of the stacked state, on its device: ys (B, C,
    ...), z / w (B, C, 3, ...) and xdat (B, C, ...) or, with a leading
    repeat axis, (R, B, C, ...), cut along (batch, channel)."""
    ys, z, w, xdat = (torch.as_tensor(t) for t in (ys, z, w, xdat))
    B, C = ys.shape[:2]
    nb, nc = mesh.shape["batch"], mesh.shape["channel"]
    if B % nb or C % nc:
        raise ValueError(f"shard_state: ({B}, {C}) does not split over "
                         f"the mesh {mesh.shape}")
    Bl, Cl = B // nb, C // nc
    b0, c0 = mesh.coords[0] * Bl, mesh.coords[1] * Cl
    blk = (slice(b0, b0 + Bl), slice(c0, c0 + Cl))

    def cut(t, lead=()):
        return t[lead + blk].to(mesh.device).contiguous()

    xlead = (slice(None),) if xdat.dim() == ys.dim() + 1 else ()
    return cut(ys), cut(z), cut(w), cut(xdat, xlead)
