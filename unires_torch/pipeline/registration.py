"""Registration by normalised mutual information: co-registration of the
inputs, alignment to an atlas, and the origin reset of CT volumes.

The behaviour of ``unires_tpu.pipeline.registration`` (the reference init's
nitorch ``affine_align`` / ``atlas_align`` / ``reset_origin``,
unires/_core.py:145-168, 310-368: NMI cost, fwhm 7, one fixed image; SE(3)
for co-registration, SE(3) or rigid + isotropic scale ("CSO") against the
atlas), without the JAX package's TPU remedies (separable-matmul reslice,
fused pyramid program, window plans, batched levels, AOT cache):

* every pyramid level lives on a world-axis-aligned isotropic grid: each
  image is resliced once through the pull kernel onto the finest level's
  grid (the movers onto their union FOV box), and coarser levels are
  smooth + stride decimations of it;
* the joint histogram uses soft (linear) binning, 64 bins, accumulated in
  chunks of 65,536 voxels as (64, chunk) x (chunk, 64) products, each
  chunk's bin weights made afresh and dropped, so that a level holds no
  more than one chunk's weights (the JAX optimiser's chunked accumulation,
  ``unires_tpu/pipeline/registration.py:340-421``);
* its gradient in the group's parameters has two halves: the histogram half,
  d NMI / d joint written out (:func:`_nmi_and_grad`), then each chunk's
  cotangent d NMI / d moved intensities from it, the chunk's fixed weights
  and the derivative of its moving weights; and the resampler half from the
  pull_grad kernel contracted to order-<=1 spatial moments (the map is
  affine in the voxel coordinate, as in ``solvers.rigid``);
* each level runs an adaptive-step preconditioned descent on the device
  (:class:`NMILevelOpt`, the JAX ``_nmi_opt_cached``): step 100, x1.4 on
  accept, x0.5 on reject, at most 150 evaluations, stopping at step <= 1e-7
  or after 12 evaluations without progress. All movers of a level descend
  together, each at its own pace (the JAX package's ``vmap``); on the card
  the level is one CUDA graph with a WHILE node, and the host reads it once.

The exponential acts about the fixed image's centre (:func:`_fix_centre`):
without that the CSO scale parameter couples with the translations and the
descent crawls.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data import default_atlas
from ..geometry import (affine_basis, affine_translation, expm, rigid_log,
                        voxel_size)
from ..ops.lie import compose_maps, group_dexpm, se3_dexpm
from ..ops.resample import affine_to_M, pull, pull_grad
from ..solvers.rigid import _centred_coords, _moments
from ..utils import trace
from ..utils.graph import capture as capture_graph
from ..utils.graph import cond, forced, while_loop
from ..utils.host import to_host
from .nifti import load as nifti_load

_BINS = 64
_CHUNK = 1 << 16


# ---------------------------------------------------------------------------
# Pyramid helpers
# ---------------------------------------------------------------------------

def _gauss_kernel1d(sd: float) -> np.ndarray:
    if sd < 1e-3:
        return np.ones(1, np.float32)
    r = max(1, int(np.ceil(3 * sd)))
    t = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (t / sd) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1(vol: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    """Same-size correlation with ``k`` along ``axis``, zero bound: shifted
    slices and weighted adds in float32 (no conv3d, hence no TF32)."""
    n = k.shape[0]
    if n == 1:
        return vol * float(k[0])
    h = n // 2
    pad = [0, 0] * 3
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = h
    vp = torch.nn.functional.pad(vol, pad)
    size = vol.shape[axis]
    out = None
    for t in range(n):
        term = float(k[t]) * vp.narrow(axis, t, size)
        out = term if out is None else out + term
    return out


def _smooth_sep(vol, kx, ky, kz):
    """Separable gaussian smoothing (same size, zero bound)."""
    return _conv1(_conv1(_conv1(vol, kx, 0), ky, 1), kz, 2)


def _fix_centre(fix_dim, fix_mat) -> np.ndarray:
    """World coordinate of the fixed image's centre: the exponential acts
    about this point, decoupling rotations from translations."""
    dim = np.asarray(fix_dim, np.float64)
    return (np.asarray(fix_mat, np.float64)
            @ np.concatenate([(dim - 1) / 2.0, [1.0]]))[:3]


def q_to_world(q, group: str, wc: np.ndarray) -> np.ndarray:
    """Host float64 world transform of the parameters: T(wc) exp(q.B) T(-wc)."""
    E = expm(np.asarray(q, np.float64), affine_basis(group))
    return affine_translation(wc) @ E @ affine_translation(-np.asarray(wc))


def _world_box(mats_dims):
    """World-space FOV bounding box (lo, hi) over (mat, dim) pairs."""
    los, his = [], []
    for mat, dim in mats_dims:
        dim = np.asarray(dim, np.float64)
        corners = np.array([[i, j, k, 1.0] for i in (0, dim[0] - 1)
                            for j in (0, dim[1] - 1) for k in (0, dim[2] - 1)])
        W = (np.asarray(mat, np.float64) @ corners.T)[:3]
        los.append(W.min(axis=1))
        his.append(W.max(axis=1))
    return np.min(los, axis=0), np.max(his, axis=0)


def _iso_pyramid(dat: torch.Tensor, mat, levels, fwhms, box=None):
    """Per-level (dat, mat) on world-aligned iso grids, coarse -> fine.

    The finest level is resliced once from the native grid by the pull
    kernel (after an anti-alias smoothing where the native grid is finer);
    coarser levels are smooth + stride decimations of it.
    """
    fine = float(levels[-1])
    mat = np.asarray(mat, np.float64)
    vx = voxel_size(mat)
    sds = [float(np.sqrt(max(0.42 * (max(fine / v, 1.0) ** 2 - 1), 0.0)))
           for v in vx]
    if max(sds) > 1e-3:
        dat = _smooth_sep(dat, *[_gauss_kernel1d(sd) for sd in sds])
    lo, hi = _world_box([(mat, dat.shape)]) if box is None else box
    dim_o = tuple(int(d) for d in np.maximum(np.floor((hi - lo) / fine) + 1,
                                             1))
    mat_o = np.eye(4)
    mat_o[:3, :3] = np.diag([fine] * 3)
    mat_o[:3, 3] = lo
    vol = pull(dat.contiguous(), affine_to_M(np.linalg.solve(mat, mat_o)),
               dim_o)
    vx_o = voxel_size(mat_o)
    out = []
    for lev, fw in zip(levels, fwhms):
        lsds = []
        for d in range(3):
            aa = max(float(lev) / vx_o[d], 1.0)
            lsds.append(float(np.sqrt((fw / 2.355) ** 2 + 0.42 * (aa ** 2 - 1))
                              / vx_o[d] if aa > 1 else fw / 2.355 / vx_o[d]))
        sm = _smooth_sep(vol, *[_gauss_kernel1d(sd) for sd in lsds])
        step = np.maximum(np.floor(float(lev) / vx_o + 0.5), 1.0)
        m = mat_o
        if (step > 1).any():
            sm = sm[tuple(slice(None, None, int(s)) for s in step)]
            m = mat_o @ np.diag(list(step) + [1.0])
        out.append((sm.contiguous(), np.asarray(m, np.float64)))
    return out


def _qscale(K: int) -> np.ndarray:
    """Translations are in mm, rotations (and the log-scale) in radians:
    the search directions are scaled per parameter kind."""
    s = np.full(K, 0.01)
    s[:3] = 1.0
    return s


# ---------------------------------------------------------------------------
# NMI and its gradient
# ---------------------------------------------------------------------------

def _soft_weights(t: torch.Tensor) -> torch.Tensor:
    """(n,) intensities in bin units -> (bins, n) linear bin weights."""
    centers = torch.arange(_BINS, dtype=torch.float32, device=t.device)
    return torch.clamp(1.0 - torch.abs(t[None, :] - centers[:, None]), min=0.0)


def _normalise(v: torch.Tensor, vmin, vmax) -> torch.Tensor:
    return (v - vmin) / torch.clamp(vmax - vmin, min=1e-12) * (_BINS - 1)


def _nmi_and_grad(joint: torch.Tensor):
    """(NMI, d NMI / d joint) of an unnormalised (bins, bins) histogram,
    NMI = -(H_f + H_m) / H_joint.

    A captured graph holds no autograd pass, so the derivative is written
    out: the operations ``torch.autograd.grad`` takes through these
    expressions, in its order (its sums of the four paths into P
    included), hence the same float32 roundings: bitwise equal to autograd
    on the CPU."""
    eps = 1e-12
    s = joint.sum()
    c = torch.clamp(s, min=eps)
    P = joint / c
    pf, pm = P.sum(dim=1), P.sum(dim=0)
    af, am, aj = pf + eps, pm + eps, P + eps
    lf, lm, lj = torch.log(af), torch.log(am), torch.log(aj)
    hf = -torch.sum(pf * lf)
    hm = -torch.sum(pm * lm)
    hj = -torch.sum(P * lj)
    num = -(hf + hm)
    H = torch.clamp(hj, min=eps)
    L = num / H
    # backward from dL = 1: the division, the clamp (passes where its
    # input is at least eps), the negations and the entropies' sums
    g_num = 1.0 / H
    g_hj = torch.where(hj >= eps, -((num / H) / H), 0.0)
    g_sf = g_num  # d L / d sum(pf log(pf + eps)), likewise for pm
    g_sj = -g_hj
    g_pf = g_sf * lf + (g_sf * pf) / af
    g_pm = g_sf * lm + (g_sf * pm) / am
    gP = (g_sj * lj + (g_sj * P) / aj) + g_pm[None, :] + g_pf[:, None]
    g_c = (-gP * ((joint / c) / c)).sum()
    return L, gP / c + torch.where(s >= eps, g_c, 0.0)


class _NMILevel:
    """Loss and gradient of one mover's NMI at one level, in the parameters
    of ``group`` (six for SE(3), seven for CSO), on the device: ``vg(q)``
    returns tensors and reads nothing back.

    The histogram and its gradient are taken chunk by chunk: a chunk's
    fixed and moving bin weights ((64, 65536) each) exist only while that
    chunk is summed, so the level's memory is its volumes plus one chunk's
    weights, whatever its size. The movers of a level share the fixed
    image's normalised chunks (``like``: another mover's level).
    """

    def __init__(self, fix, mov, pre4, post4, group: str = "SE",
                 like: Optional["_NMILevel"] = None):
        dev = mov.device

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   dtype=torch.float64, device=dev)

        self.fix_dim = tuple(fix.shape)
        self.mov = mov
        self.pre4, self.post4 = f64(pre4), f64(post4)
        self.basis = f64(affine_basis(group))
        self.dexpm = se3_dexpm if group == "SE" else group_dexpm
        if like is None:
            self.fn = torch.split(_normalise(fix.reshape(-1), fix.min(),
                                             fix.max()), _CHUNK)
            self.center = tuple((d - 1) / 2.0 for d in self.fix_dim)
            self.coords = _centred_coords(self.fix_dim, self.center, dev)
            self.center_t = f64(self.center)
        else:
            self.fn, self.center = like.fn, like.center
            self.coords, self.center_t = like.coords, like.center_t
        self.mmin, self.mmax = mov.min(), mov.max()

    def _loss_cotangent(self, movf):
        """(NMI, d NMI / d movf) of the moved intensities ``movf`` (n,)."""
        mn = torch.split(_normalise(movf, self.mmin, self.mmax), _CHUNK)
        joint = None
        for f, m in zip(self.fn, mn):
            part = _soft_weights(f) @ _soft_weights(m).T
            joint = part if joint is None else joint + part
        L, gJ = _nmi_and_grad(joint)
        centers = torch.arange(_BINS, dtype=torch.float32, device=movf.device)
        scale = torch.clamp(self.mmax - self.mmin, min=1e-12)
        ct = []
        for f, m in zip(self.fn, mn):
            # d soft_weights(m)[b, i] / d m_i as JAX differentiates the
            # JAX package's max(0, 1 - |m_i - b|): -sign(m_i - b), the
            # sign +1 at m_i = b, halved where the max ties (|m_i - b| =
            # 1), 0 beyond. Ties are common on a coarse level: at the
            # identity map every moved intensity is a voxel's, and the
            # mover's extremes normalise to the end bins exactly.
            d = m[None, :] - centers[:, None]
            dW = (torch.where(d >= 0.0, -0.5, 0.5)
                  * (torch.sign(1.0 - torch.abs(d)) + 1.0))
            g_mn = ((gJ.T @ _soft_weights(f)) * dW).sum(dim=0)
            ct.append(g_mn * (_BINS - 1) / scale)
        return L, torch.cat(ct)

    def vg(self, q: torch.Tensor):
        """(loss, gradient (K,)) at q (K,), float64 tensors on the device."""
        R, dR = self.dexpm(q, self.basis)
        M = compose_maps(self.pre4, R, self.post4)[0]
        movf = pull(self.mov, M, self.fix_dim).reshape(-1)
        L, ct = self._loss_cotangent(movf)
        pg = pull_grad(self.mov, M, self.fix_dim)
        W = ct.reshape(self.fix_dim)[None] * pg.permute(3, 0, 1, 2)
        mom = _moments(W, self.coords, order=1)  # (3, 4) float64
        # dL/dq_k = sum_v ct_v pg_v . (B_k v): B_k affine in the voxel
        # coordinate, so the order-<=1 moments suffice; the contractions
        # are broadcast products and sums (no matrix-vector product in a
        # conditional node's body)
        B = self.pre4 @ dR @ self.post4  # (K, 4, 4)
        lin = B[:, :3, :3]
        ccf = B[:, :3, 3] + (lin * self.center_t).sum(dim=-1)
        g = (ccf * mom[:, 0]).sum(dim=-1) + (lin * mom[:, 1:]).sum(dim=(1, 2))
        return L.double(), g


# ---------------------------------------------------------------------------
# The level's descent on the device
# ---------------------------------------------------------------------------

_STEP0 = 100.0  # first step of the descent
_MIN_STEP = 1e-7
_NO_PROG = 12  # evaluations without progress that end a mover's descent


@dataclasses.dataclass
class _LevelState:
    """The descent's state, per mover (n movers, K parameters), on the
    device: q, loss, g and step in float64, it and no_prog in int32, live;
    the candidate and its evaluation; q0 (set before a run) and the turns
    of the WHILE loop."""
    q0: torch.Tensor
    q: torch.Tensor
    loss: torch.Tensor
    g: torch.Tensor
    step: torch.Tensor
    it: torch.Tensor
    no_prog: torch.Tensor
    live: torch.Tensor
    cand: torch.Tensor
    new_loss: torch.Tensor
    new_g: torch.Tensor
    turns: torch.Tensor

    @classmethod
    def zeros(cls, n: int, K: int, device) -> "_LevelState":
        def z(shape, dtype=torch.float64):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(q0=z((n, K)), q=z((n, K)), loss=z(n), g=z((n, K)),
                   step=z(n), it=z(n, torch.int32),
                   no_prog=z(n, torch.int32), live=z(n, torch.bool),
                   cand=z((n, K)), new_loss=z(n), new_g=z((n, K)),
                   turns=z((), torch.int32))

    def clone(self) -> "_LevelState":
        return _LevelState(**{f.name: getattr(self, f.name).clone()
                              for f in dataclasses.fields(self)})


class NMILevelOpt:
    """One level's adaptive-step preconditioned descent for all its movers
    at once, on the device (the JAX optimiser ``_nmi_opt_cached``, vmapped
    over the movers): step 100, x1.4 on accept, x0.5 on reject; a mover
    stops after ``iters`` evaluations, at step <= 1e-7 or after 12
    evaluations without progress (an improvement of the loss by more than
    1e-5 relative), and keeps its state while the others go on.

    A run is the initial evaluation of every mover, then a
    ``utils.graph.while_loop`` on any mover being live, each turn one
    candidate per live mover (its evaluation a ``utils.graph.cond`` on its
    own flag), and one host read of q, the losses and the evaluations per
    mover. On a CUDA device (``capture`` None or True) every branch is
    warmed up on a copy of the state under ``utils.graph.forced``, then the
    run is captured as one CUDA graph, its loop a WHILE node and each
    evaluation an IF node in its body, and replayed once; a failed capture
    raises. ``capture=False`` runs the same code uncaptured, every decision
    read on the host (on the CPU always; on the card for the tests and
    ``chip_smoke.py``).

    Each call is a ``registration.level`` span (``utils.trace``) whose
    counts are the level's figures, ``mm`` and ``group`` as given here;
    :attr:`stats` is that dict. Its children: ``registration.level.capture``
    (the warm-up and the capture, on the card) and
    ``registration.level.run`` (the run or the replay, and the read).
    """

    def __init__(self, levels, iters: int = 150,
                 capture: Optional[bool] = None, group: str = "SE",
                 mm: Optional[float] = None):
        self.levels = list(levels)
        self.dev = dev = self.levels[0].mov.device
        if capture is None:
            capture = dev.type == "cuda"
        if capture and dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        self.capture = bool(capture)
        self.iters = int(iters)
        K = self.levels[0].basis.shape[0]
        self.scale = torch.as_tensor(_qscale(K), dtype=torch.float64,
                                     device=dev)
        self.st = _LevelState.zeros(len(self.levels), K, dev)
        self.group, self.mm = group, mm
        self.stats = {}

    def _eval(self, i: int, q, loss_out, g_out) -> None:
        L, g = self.levels[i].vg(q)
        loss_out.copy_(L)
        g_out.copy_(g)

    def _live(self, st: _LevelState) -> torch.Tensor:
        return ((st.it < self.iters) & (st.step > _MIN_STEP)
                & (st.no_prog < _NO_PROG))

    def turn(self, st: _LevelState) -> None:
        """One turn of the descent: the JAX optimiser's loop body, per
        mover."""
        st.cand.copy_(st.q - st.step[:, None] * self.scale * self.scale
                      * st.g)
        for i in range(len(self.levels)):
            cond(st.live[i], functools.partial(
                self._eval, i, st.cand[i], st.new_loss[i], st.new_g[i]))
        live = st.live
        acc = live & (st.new_loss < st.loss)
        prog = acc & (st.loss - st.new_loss > 1e-5 * st.loss.abs())
        st.no_prog.copy_(torch.where(
            live, torch.where(prog, 0, st.no_prog + 1), st.no_prog))
        st.q.copy_(torch.where(acc[:, None], st.cand, st.q))
        st.loss.copy_(torch.where(acc, st.new_loss, st.loss))
        st.g.copy_(torch.where(acc[:, None], st.new_g, st.g))
        st.step.copy_(torch.where(
            live, torch.where(acc, st.step * 1.4, st.step * 0.5), st.step))
        st.it.add_(live.to(torch.int32))
        st.turns.add_(1)
        st.live.copy_(self._live(st))

    def run(self, st: _LevelState) -> None:
        """The level from ``st.q0``: the initial evaluations, then the
        descent while any mover is live."""
        st.q.copy_(st.q0)
        st.step.fill_(_STEP0)
        st.it.zero_()
        st.no_prog.zero_()
        st.turns.zero_()
        for i in range(len(self.levels)):
            self._eval(i, st.q[i], st.loss[i], st.g[i])
        st.live.copy_(self._live(st))
        while_loop(lambda: st.live.any(), lambda: self.turn(st))

    def __call__(self, q0):
        """Run the level from q0 (n, K); returns (q (n, K), loss (n,),
        evaluations per mover (n,)) as host arrays: the level's one read.
        ``stats`` holds its figures: ``mm``, ``group``, ``grid``,
        ``movers``, ``evals`` (per mover), ``turns`` (of the WHILE loop),
        ``captured``, ``nodes`` (the graph's, None uncaptured) and
        ``syncs`` (host syncs, the capture's wait included)."""
        st = self.st
        n, K = st.q.shape
        with trace.span("registration.level", mm=self.mm, group=self.group,
                        grid=self.levels[0].fix_dim, movers=n,
                        captured=self.capture) as span:
            self.stats = figures = span.attrs
            syncs0 = to_host.syncs
            st.q0.copy_(torch.as_tensor(np.asarray(q0, np.float64)))
            graph = None
            if self.capture:
                with trace.span("registration.level.capture"):
                    scratch = st.clone()
                    with torch.cuda.device(self.dev), forced():
                        self.run(scratch)
                    del scratch
                    with torch.cuda.device(self.dev):
                        graph = capture_graph(lambda: self.run(st))
            with trace.span("registration.level.run"):
                if graph is not None:
                    graph.replay()
                else:
                    self.run(st)
                v = to_host(torch.cat([st.q.reshape(-1), st.loss,
                                       st.it.to(torch.float64),
                                       st.turns.to(torch.float64).reshape(1)]))
            q = v[:n * K].reshape(n, K)
            loss = v[n * K:n * K + n]
            evals = v[n * K + n:n * K + 2 * n].astype(np.int64) + 1
            figures.update(evals=evals.tolist(), turns=int(v[-1]),
                           nodes=None if graph is None else graph.nodes,
                           syncs=to_host.syncs - syncs0)
        return q, loss, evals


def make_nmi_level(fix, movers, post4, group: str = "SE", iters: int = 150,
                   capture: Optional[bool] = None,
                   mm: Optional[float] = None) -> NMILevelOpt:
    """The level optimiser of ``movers`` [(volume, pre4), ...] against
    ``fix`` on its grid: :class:`NMILevelOpt` over one :class:`_NMILevel`
    per mover, sharing the fixed image's chunks; ``mm``: the level's voxel
    size, for its span."""
    levels = []
    for mov, pre4 in movers:
        levels.append(_NMILevel(fix, mov, pre4, post4, group,
                                like=levels[0] if levels else None))
    return NMILevelOpt(levels, iters, capture, group, mm)


def _opt_level(fd, fm, movers, qs, wc, group: str = "SE", iters: int = 150,
               capture: Optional[bool] = None, mm: Optional[float] = None):
    """One level's optimisation of all ``movers`` [(md, mat), ...] against
    (fd, fm) from their parameters ``qs`` (n, K); returns the new qs. Its
    figures are its ``registration.level`` span's (``utils.trace``)."""
    post4 = affine_translation(-wc) @ np.asarray(fm, np.float64)
    opt = make_nmi_level(
        fd, [(md, np.linalg.inv(np.asarray(mat, np.float64))
              @ affine_translation(wc)) for md, mat in movers],
        post4, group, iters, capture, mm)
    q, _, _ = opt(qs)
    return q


def _as_volume(dat, device=None) -> torch.Tensor:
    """Any array -> float32 tensor (on ``device`` when given)."""
    if not isinstance(dat, torch.Tensor):
        dat = torch.from_numpy(np.asarray(dat, np.float32))
    return dat.to(device=device, dtype=torch.float32)


def _register_pair(fix_dat, fix_mat, mov_dat, mov_mat, q0, levels, fwhm,
                   maxiter: int = 150, group: str = "SE"):
    """Multi-resolution NMI registration of one pair. Returns (q, wc):
    the parameters of the centred exponential and its centre; the world
    transform is :func:`q_to_world` (q, group, wc). Spans: one
    ``registration.pyramid``, then a ``registration.level`` per level."""
    wc = _fix_centre(fix_dat.shape, fix_mat)
    q = np.asarray(q0, np.float64)[None]
    fwhms = ([float(fwhm)] * len(levels) if np.isscalar(fwhm)
             else [float(f) for f in fwhm])
    with trace.span("registration.pyramid", mm=tuple(levels)):
        fix_pyr = _iso_pyramid(fix_dat, fix_mat, levels, fwhms)
        mov_pyr = _iso_pyramid(mov_dat, mov_mat, levels, fwhms)
    for lv, (fd, fm), mov in zip(levels, fix_pyr, mov_pyr):
        q = _opt_level(fd, fm, [mov], q, wc, group, maxiter, mm=lv)
    return q[0], wc


def affine_align(imgs: Sequence[Tuple[torch.Tensor, np.ndarray]], fix: int = 0,
                 cost_fun: str = "nmi", group: str = "SE", samp=1,
                 fwhm: float = 7.0, mean_space: bool = False,
                 levels: Sequence[float] = (8.0, 4.0, 2.0),
                 gauge: str = "fix", capture: Optional[bool] = None
                 ) -> np.ndarray:
    """Pairwise rigid alignment of all images to imgs[fix].

    Returns mat_a (N, 4, 4): world-space transforms; ``mat <- solve(mat_a[i],
    mat)`` aligns the images (the reference applies exactly this at
    unires/_core.py:336). ``gauge='fix'`` leaves imgs[fix] untouched
    (mat_a[fix] = I); ``'mean'`` right-multiplies every mat_a by
    expm(-mean(log mat_a)), so the common frame is the Lie-mean of the
    input frames. The schedule always finishes with a ``samp``-mm level.
    All movers of a level run in one :class:`NMILevelOpt` (on the card one
    captured graph per level; ``capture=False`` runs it uncaptured), each
    level a ``registration.level`` span after one ``registration.pyramid``
    (``utils.trace``). ``mean_space`` is accepted for the reference's
    signature and unused.
    """
    if cost_fun != "nmi":
        raise NotImplementedError(f"cost_fun={cost_fun!r} (only 'nmi')")
    if group != "SE":
        raise NotImplementedError(f"group={group!r} (only 'SE')")
    if gauge not in ("fix", "mean"):
        raise ValueError(f"gauge={gauge!r} (use 'fix'|'mean')")
    N = len(imgs)
    mat_a = np.stack([np.eye(4)] * N)
    if N < 2:
        return mat_a
    levels = tuple([float(lv) for lv in levels if lv > samp] + [float(samp)])
    fwhms = ([float(fwhm)] * len(levels) if np.isscalar(fwhm)
             else [float(f) for f in fwhm])
    dats = [_as_volume(d) for d, _ in imgs]
    fix_mat = imgs[fix][1]
    wc = _fix_centre(dats[fix].shape, fix_mat)
    movers = [i for i in range(N) if i != fix]
    with trace.span("registration.pyramid", mm=levels):
        fix_pyr = _iso_pyramid(dats[fix], fix_mat, levels, fwhms)
        box = _world_box([(imgs[i][1], dats[i].shape) for i in movers])
        mov_pyrs = [_iso_pyramid(dats[i], imgs[i][1], levels, fwhms,
                                 box=box) for i in movers]
    qs = np.zeros((len(movers), 6))
    for li, lv in enumerate(levels):
        fd, fm = fix_pyr[li]
        qs = _opt_level(fd, fm, [p[li] for p in mov_pyrs], qs, wc, "SE", 150,
                        capture, mm=lv)
    for k, i in enumerate(movers):
        mat_a[i] = q_to_world(qs[k], "SE", wc)
    if gauge == "mean":
        basis = affine_basis("SE")
        qbar = np.mean([rigid_log(mat_a[i], basis) for i in range(N)], axis=0)
        Gm = expm(-qbar, basis)
        for i in range(N):
            mat_a[i] = mat_a[i] @ Gm
    return mat_a


# ---------------------------------------------------------------------------
# Atlas alignment / origin reset
# ---------------------------------------------------------------------------

_ATLAS_PATH_ENV = "UNIRES_ATLAS"


def atlas_align(img: Tuple[torch.Tensor, np.ndarray], rigid: bool = True,
                atlas_path: Optional[str] = None) -> np.ndarray:
    """Align one image to a T1 atlas (reference _core.py:340-353); returns
    the world transform mat_a, applied as ``mat <- solve(mat_a, mat)``.

    The atlas volume: the ``atlas_path`` argument, else the UNIRES_ATLAS
    environment variable (any NIfTI in MNI-like space), else the bundled
    procedural MNI-space template (``unires_torch.data.default_atlas``). It
    is the fixed image, on the image's device; ``rigid`` picks SE(3), else
    CSO = rigid + isotropic scale (the reference's ``atlas_rigid=False``).
    Every NMI evaluation is one pull and one pull_grad of the image's level;
    each level is one :class:`NMILevelOpt`, on the card one captured
    graph, and one ``registration.level`` span (``utils.trace``).
    """
    dat, mat = img
    dat = _as_volume(dat)
    atlas_path = atlas_path or os.environ.get(_ATLAS_PATH_ENV)
    if atlas_path:
        adat, ahdr = nifti_load(atlas_path)
        amat = ahdr.affine
    else:
        adat, amat = default_atlas()
    group = "SE" if rigid else "CSO"
    K = affine_basis(group).shape[0]
    # finish at the coarser of the two native resolutions (the bundled
    # template is 2 mm; a 1 mm atlas/image pair refines down to 1 mm)
    fine = max(float(np.min(voxel_size(amat))),
               float(np.min(voxel_size(np.asarray(mat, np.float64)))), 1.0)
    levels = [8.0, 4.0] + [float(lv) for lv in (2.0, fine) if lv > fine] + [fine]
    fwhms = [7.0] * (len(levels) - 2) + [4.0, 4.0]
    q, wc = _register_pair(_as_volume(adat, dat.device), amat, dat, mat,
                           np.zeros(K), levels=tuple(levels),
                           fwhm=tuple(fwhms), group=group)
    return q_to_world(q, group, wc)


def reset_origin(dat, mat: np.ndarray, interpolation: int = 1):
    """World-reslice + origin reset (reference: nitorch reset_origin for CT,
    unires/_core.py:145-168).

    The volume is resliced through the pull kernel onto an axis-aligned grid
    (the same voxel size per world axis, covering the input FOV) whose
    origin sits at the FOV centre. Returns the new data and affine.
    """
    dat = _as_volume(dat)
    mat = np.asarray(mat, np.float64)
    dim = np.asarray(dat.shape, np.float64)
    A = mat[:3, :3]
    vx = np.sqrt((A ** 2).sum(axis=0))
    # input axis most aligned with each world axis -> its voxel size
    perm = np.argmax(np.abs(A), axis=1)
    vx_world = vx[perm]
    lo, hi = _world_box([(mat, dim)])
    dim_o = np.maximum(np.floor((hi - lo) / vx_world + 0.5) + 1, 1)
    mat_o = np.eye(4)
    mat_o[:3, :3] = np.diag(vx_world)
    mat_o[:3, 3] = -(vx_world * (dim_o - 1) / 2.0)  # origin = FOV centre
    out = pull(dat.contiguous(), affine_to_M(np.linalg.solve(mat, mat_o)),
               tuple(int(d) for d in dim_o), order=interpolation)
    return out, mat_o
