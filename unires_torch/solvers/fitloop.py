"""The fit chunk: K outer iterations on the device, read by the host once.

The counterpart of ``unires_tpu.solvers.fitloop.make_fit_chunk``. One outer
iteration (``live_iter`` there, fitloop.py:605-762):

  1. lam from the coarse-to-fine schedule position, rho refreshed from it;
     the CG data-term diagonals refreshed every ``Settings.chunk_iters``
     iterations; one ADMM iteration (``solvers.admm``) at the current poses
     and scales;
  2. the gain over the posterior trace (nitorch get_gain) and the
     convergence countdown ``countdown0`` (reference run.py:100-110);
  3. unless converged: the scaling Gauss-Newton step of every non-CT
     observation (reference unires/_update.py:270-393);
  4. every ``rigid_mod`` iterations (not the first): the rigid GN deltas of
     every observation, the pose-gauge common mode projected out of them
     when ``rigid_gauge_anchor`` is on and N > 1, a halving line search per
     observation, and a re-centre of q when its mean drifts beyond 0.25
     (mm, 10 mrad units);
  5. the schedule step with ``countdown1`` (reference run.py:140-155) and
     the dual-consistency rescale of z at a lambda step.

Everything the loop carries (:class:`FitState`) is a tensor on the device,
updated in place; the poses q (Nobs x 6) and scales are float64, and the
float32 (3, 4) maps and push plans are rebuilt from them on the device
every iteration (``ops.lie``, ``ops.resample.push_plan``). Every decision
(a CG step, a line-search candidate, a frozen iteration after convergence)
is a ``utils.graph.cond``, so the iteration reads nothing back. On the card
the chunk captures one iteration as a CUDA graph, its decisions as
conditional IF nodes, and replays it; the host reads the objective trace,
the gains, ``valid``, the poses, the scales and the counters once per chunk
(:meth:`FitChunk.read`). On the CPU the same code runs uncaptured, each
decision read on the host (the tests hold it against the JAX chunk).

A batch of subjects on one device is one chunk (:func:`make_batch_chunk`,
the counterpart of ``unires_tpu.parallel.fit_batch.make_batch_chunk``): the
state, data, taus, lam0 and geometry stacked on a leading subject axis,
every decision taken where some subject needs it, and per-subject masks
keeping the others' state bitwise as it was (``vmap`` of the JAX loop). On
the card it is one captured graph for all the subjects.

The JAX loop's window-plan capacity checks have no counterpart: the CUDA
kernels take any affine, so every check there is true, its pre-scale loop
exits at step 1 and its veto never fires.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..geometry import affine_basis, affine_translation, fov_centre
from ..models.forward import make_obs_suite
from ..models.proj_op import proj_info
from ..ops.lie import compose_maps, se3_dexpm, se3_expm
from ..ops.resample import PLAN_SIZE, push_plan
from ..utils import trace
from ..utils.batch import any_of, each
from ..utils.graph import capture, cond, forced
from ..utils.host import to_host
from .admm import make_admm_body, make_cdiag_fn
from .rigid import (_LKP, _assemble, _centred_coords, ctc_volume, gn_delta,
                    match_ll_device, match_stats_device)
from .scaling_gn import scaling_gn

# units of the gauge-drift threshold: 1 mm of translation ~ 10 mrad of
# rotation (comparable displacement at ~100 mm from the centre)
_Q_GAUGE_SCALE = (1.0, 1.0, 1.0, 0.01, 0.01, 0.01)
_NUM_LS = 6  # line-search budget (reference run.py:119,131)

# the state's scalars, as the host reads them (packed after q and scl)
_INTS = ("n_iter", "cnt_scl", "cnt_scl_iter", "countdown0", "countdown1")
_FLAGS = ("done", "has_prev", "has_cdiags")
_FLOATS = ("prev_obj", "obj_max", "obj_min")
SCALARS = _INTS + _FLAGS + _FLOATS
_START = dict(n_iter=0, cnt_scl=0, cnt_scl_iter=0, countdown0=6,
              countdown1=6, done=False, has_prev=False, has_cdiags=False,
              prev_obj=0.0, obj_max=-np.inf, obj_min=np.inf)


@dataclasses.dataclass
class FitState:
    """Everything the loop carries between outer iterations: tensors on
    the fit's device, updated in place by :meth:`FitChunk.iterate`.

    ``host`` holds the host's copy of q, scl and the scalars as last read
    (:meth:`FitChunk.read`) or as the state was made; the stepper
    (``pipeline.fit.FitStepper``) decides from it and never reads the device
    state again in between. A batch's state (:func:`stack_states`) has
    every field stacked on a leading subject axis."""

    ys: torch.Tensor  # (C, *dim_y)
    z: torch.Tensor  # (C, 3, *dim_y)
    w: torch.Tensor  # (C, 3, *dim_y)
    jtv: torch.Tensor  # (*dim_y) latest shrinkage field
    q: torch.Tensor  # (Nobs, 6) float64 rigid parameters
    scl: torch.Tensor  # (Nobs,) float64 even/odd scaling
    cdiags: torch.Tensor  # (C,) float32 preconditioner data-term diagonals
    n_iter: torch.Tensor  # int64 0-d, outer iterations done
    cnt_scl: torch.Tensor  # schedule position
    cnt_scl_iter: torch.Tensor
    countdown0: torch.Tensor  # convergence countdown (6 -> 0)
    countdown1: torch.Tensor  # schedule countdown
    done: torch.Tensor  # bool 0-d
    has_prev: torch.Tensor
    has_cdiags: torch.Tensor  # cdiags hold this fit's values
    prev_obj: torch.Tensor  # float64 0-d
    obj_max: torch.Tensor
    obj_min: torch.Tensor
    host: dict = dataclasses.field(default_factory=dict)

    def clone(self) -> "FitState":
        fields = {f.name: getattr(self, f.name) for f in
                  dataclasses.fields(self)}
        return FitState(**{k: v.clone() if isinstance(v, torch.Tensor)
                           else dict(v) for k, v in fields.items()})


def init_state(x, y, sett, z=None, w=None, **scalars) -> FitState:
    """Loop state on ``sett.device`` from the pipeline structs (ys from
    ``y``, q and scl from the observations), z = w = 0 unless given, and
    the scalars of a fresh fit unless given (a resume, a JAX state)."""
    dev = torch.device(sett.device)
    dim_y = tuple(int(d) for d in y[0].dim)
    ys = torch.stack([yc.dat.to(dev, torch.float32) for yc in y])
    shape = (len(x), 3) + dim_y
    z = torch.zeros(shape, dtype=torch.float32, device=dev) if z is None \
        else z.to(dev, torch.float32)
    w = torch.zeros(shape, dtype=torch.float32, device=dev) if w is None \
        else w.to(dev, torch.float32)
    q = np.stack([np.zeros(6) if o.rigid_q is None
                  else np.asarray(o.rigid_q, np.float64)
                  for xc in x for o in xc])
    scl = np.array([float(o.po.scl) for xc in x for o in xc])
    host = dict(_START, **scalars)
    # one copy to the device for all the small values
    packed = torch.tensor(np.concatenate(
        [q.ravel(), scl, [float(host[k]) for k in SCALARS]]),
        dtype=torch.float64, device=dev)
    n_q = q.size
    tail = packed[n_q + scl.size:]
    vals = {}
    for j, k in enumerate(SCALARS):
        dtype = (torch.int64 if k in _INTS else
                 torch.bool if k in _FLAGS else torch.float64)
        vals[k] = tail[j].to(dtype).clone()
    host.update(q=q.copy(), scl=scl.copy())
    return FitState(
        ys=ys, z=z, w=w, jtv=torch.zeros(dim_y, dtype=torch.float32,
                                         device=dev),
        q=packed[:n_q].reshape(q.shape).clone(),
        scl=packed[n_q:n_q + scl.size].clone(),
        cdiags=torch.zeros(len(x), dtype=torch.float32, device=dev),
        host=host, **vals)


def chunk_len(sett) -> int:
    """Iterations per chunk: ``chunk_iters``, at most ``max_iter`` (at least
    one); also the cadence of the CG diagonals' refresh."""
    return max(1, min(int(getattr(sett, "chunk_iters", 16)),
                      int(sett.max_iter)))


def chunk_geom(x, y, sett):
    """Per-observation geometry of the fit: ``(pres, posts, subs)``.

    pres/posts are the float64 4x4 factors of the centre-conjugated maps.
    ``subs[i]`` is None without unified rigid, else a dict describing the
    rigid-subsample grid: ``po`` (the operator on it), ``post`` (its post
    factor), ``dim``, ``center`` and ``sub_is_main`` (the grids coincide,
    the ``rigid_samp=1`` default on >= 1 mm data). This is the one place
    that decides the grid: ``pipeline.fit.gather_subdats`` reads it.
    """
    method = sett.method
    dim_y = tuple(int(d) for d in y[0].dim)
    c_world = fov_centre(y[0].mat, dim_y)
    Tc, Tc_inv = affine_translation(c_world), affine_translation(-c_world)
    pres, posts, subs = [], [], []
    for xc in x:
        for o in xc:
            po = o.po
            sr = method == "super-resolution"
            pres.append(np.linalg.inv(np.asarray(po.mat_y, np.float64)) @ Tc)
            posts.append(Tc_inv @ np.asarray(po.mat_yx if sr else po.mat_x,
                                             np.float64))
            if not sett.unified_rigid:
                subs.append(None)
                continue
            po_sub = proj_info(po.dim_y, po.mat_y, o.dim, o.mat,
                               rigid=po.rigid, prof_ip=sett.profile_ip,
                               prof_tp=sett.profile_tp, gap=sett.gap,
                               scl=po.scl, samp=sett.rigid_samp)
            main = po_sub.dim_x == po.dim_x and po_sub.dim_yx == po.dim_yx
            po_use = po if main else po_sub
            dim_m = po_use.dim_yx if sr else po_use.dim_x
            subs.append(dict(
                po=po_use, dim=dim_m, sub_is_main=main,
                center=tuple((d - 1) / 2.0 for d in dim_m),
                post=Tc_inv @ np.asarray(po_use.mat_yx if sr
                                         else po_use.mat_x, np.float64)))
    return pres, posts, subs


def stack_states(states) -> FitState:
    """The subjects' loop states stacked on a leading subject axis (the
    state of a batched chunk, :func:`make_batch_chunk`): every tensor
    field gains it, and ``host`` holds arrays with it."""
    tensors = {f.name: torch.stack([getattr(st, f.name) for st in states])
               for f in dataclasses.fields(FitState) if f.name != "host"}
    host = {k: np.stack([np.asarray(st.host[k]) for st in states])
            for k in ("q", "scl") + SCALARS}
    return FitState(host=host, **tensors)


def _host_scalar(k, v):
    return int(v) if k in _INTS else bool(v) if k in _FLAGS else float(v)


def subject_state(st: FitState, b: int) -> FitState:
    """Subject ``b`` of a stacked state: views of its tensors, and its host
    values as a single fit's state holds them."""
    tensors = {f.name: getattr(st, f.name)[b]
               for f in dataclasses.fields(FitState) if f.name != "host"}
    host = {k: (np.array(st.host[k][b]) if k in ("q", "scl")
                else _host_scalar(k, st.host[k][b]))
            for k in ("q", "scl") + SCALARS}
    return FitState(host=host, **tensors)


class FitChunk:
    """``chunk(state, xdats, subdats, n) -> (state, objs (n, 3), gains (n,),
    valid (n,))``: ``n`` (at most K) outer iterations of this problem from
    ``state``, updated in place; objs / gains / valid are device tensors of
    the chunk, overwritten by its next call (as the JAX chunk returns,
    ``unires_tpu/pipeline/fit.py:202``; a frozen iteration, after
    convergence or ``max_iter``, leaves the state unchanged and is not
    valid).

    ``capture`` (default: on a CUDA device): the first call captures one
    iteration as a CUDA graph, after an uncaptured warm-up of every branch
    on a copy of the state, and every call replays it; the graph is bound
    to the state and data of that call (another state captures anew). A
    failed capture raises. ``capture=False`` runs the iterations uncaptured
    (on the CPU, always), each decision read on the host: the tests and
    ``chip_smoke.py`` hold the captured chunk against it.

    ``xdats`` is nested as the observations (``[[o.dat for o in xc] for xc
    in x]``), ``subdats`` the flat per-observation list of rigid-subsample
    volumes (``pipeline.fit.gather_subdats`` of :attr:`subs`; None where
    the grids coincide). The per-observation updates ``maps``,
    ``scaling_obs``, ``rigid_stats`` and ``rigid_ls`` are methods, as the
    JAX chunk's ``_debug``.

    ``batch=(xs, ys)`` makes the chunk of a geometry-homogeneous batch
    (:func:`make_batch_chunk`; ``x``, ``y`` are then subject 0's): its state
    is :func:`stack_states`'s, its data stacked likewise ((B, ...) per
    observation), its outputs (B, n, ...). Every iteration is written for
    a leading subject axis of B entries, one for a single fit: the
    resampling kernels take the B volumes in one launch, every elementwise
    step runs on the stack, and what reduces a volume or multiplies small
    matrices (the poses, the 6x6 solves) runs per subject on a single
    fit's shapes. A decision is taken where some subject needs it, and a
    per-subject mask keeps every other subject's state as it was (what
    ``vmap`` makes of a ``lax.cond``); with one subject the masks fall
    away and the iteration is the single fit's, operation for operation.
    """

    def __init__(self, x, y, sett, K: int, capture: Optional[bool] = None,
                 batch=None):
        self.batched = batch is not None
        xs, ys = batch if self.batched else ([x], [y])
        self.B = B = len(xs)
        C = len(x)
        self.C = C
        self.method = method = sett.method
        self.sr = method == "super-resolution"
        self.dev = dev = torch.device(sett.device)
        if capture is None:
            capture = dev.type == "cuda"
        if capture and dev.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not {dev}")
        self.capture = bool(capture)
        self.K = K = int(K)
        if K < 1:
            raise ValueError(f"K = {K}: a chunk runs at least one iteration")
        self.x = x
        self.obs = obs = [(c, n) for c in range(C) for n in range(len(x[c]))]
        self.Nobs = Nobs = len(obs)
        self.dim_y = tuple(int(d) for d in y[0].dim)
        self.admm_body = make_admm_body(x, y, sett)
        self.cdiag_fn = make_cdiag_fn(x, sett)
        basis = (np.asarray(sett.rigid_basis, np.float64)
                 if sett.rigid_basis is not None else affine_basis("SE"))

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64),
                                   dtype=torch.float64, device=dev)

        self.basis = f64(basis)
        # per-subject geometry, (B, Nobs, 4, 4): the JAX chunk's geoms
        geoms = [chunk_geom(xb, yb, sett) for xb, yb in zip(xs, ys)]
        self.subs_of = [g[2] for g in geoms]
        self.subs = self.subs_of[0]
        self.pre = f64(np.stack([np.stack(g[0]) for g in geoms]))
        self.post = f64(np.stack([np.stack(g[1]) for g in geoms]))
        self.suites = [make_obs_suite(x[c][n].po, method) for (c, n) in obs]
        self.src_dims = [tuple(x[c][n].po.dim_yx if self.sr
                               else x[c][n].po.dim_x) for (c, n) in obs]
        # tau of every observation of every subject, (Nobs, B): float32
        # values, as a device operand (the JAX chunk's taus)
        taus = np.array([[float(np.float32(xb[c][n].tau)) for xb in xs]
                         for (c, n) in obs])
        self.tau32 = torch.as_tensor(taus, dtype=torch.float32, device=dev)
        self.tau64 = f64(taus)

        # the schedule holds float32 values, as the JAX loop's device table
        reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float32))
        self.n_sched = int(reg.size)
        self.reg_scl = f64(reg.astype(np.float64))
        self.lam0 = f64([[float(yc.lam0) for yc in yb] for yb in ys])
        has_ct = any(o.ct for xc in x for o in xc)
        rho_fixed = (1.0 if has_ct else
                     (float(sett.rho) if sett.rho is not None else None))
        # rho = rho_scl sqrt(mean tau) / mean lam, the first factor fixed
        self.rho_fixed = (None if rho_fixed is None
                          else f64(np.full(B, rho_fixed)))
        self.rho_num = f64([float(sett.rho_scl) * float(np.sqrt(np.mean(t)))
                            for t in taus.T])
        self.tol = float(sett.tolerance)
        self.max_iter = int(sett.max_iter)
        self.cadence = chunk_len(sett)
        self.do_scaling = bool(sett.scaling)
        self.do_rigid = bool(sett.unified_rigid)
        self.gauge_anchor = bool(getattr(sett, "rigid_gauge_anchor", True))
        self.rigid_mod = max(int(sett.rigid_mod), 1)
        self.ct = [x[c][n].ct for (c, n) in obs]

        if self.do_rigid:
            self.sub_post = f64(np.stack([np.stack([s["post"] for s in subs])
                                          for subs in self.subs_of]))
            self.sub_suites = [
                self.suites[i] if s["sub_is_main"]
                else make_obs_suite(s["po"], method)
                for i, s in enumerate(self.subs)]
            self.coords = [_centred_coords(s["dim"], s["center"], dev)
                           for s in self.subs]
            self.centers = [f64(s["center"]) for s in self.subs]
            self.ctcs = [ctc_volume(s["po"], s["dim"], dev) if self.sr
                         else 1.0 for s in self.subs]
            self.lkp = torch.as_tensor(_LKP, device=dev)
            self.gauge_scale = f64(_Q_GAUGE_SCALE)
            self.steps = f64([0.5 ** k for k in range(_NUM_LS)])

        # the chunk's own buffers: the maps and push plans of the current
        # poses (observation-major, so that one observation's B maps are
        # contiguous), the outputs, and the index of the next output row
        self.M = torch.zeros((Nobs, B, 3, 4), dtype=torch.float32, device=dev)
        self.plan = torch.zeros((Nobs, B, PLAN_SIZE), dtype=torch.float32,
                                device=dev)
        self.objs = torch.zeros((B, K, 3), dtype=torch.float64, device=dev)
        self.gains = torch.zeros((B, K), dtype=torch.float64, device=dev)
        self.valid = torch.zeros((B, K), dtype=torch.bool, device=dev)
        self.kidx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.graph = None
        self._bound = None

    # -- helpers -------------------------------------------------------------

    def nested(self, flat):
        out, i = [], 0
        for c in range(self.C):
            out.append(list(flat[i:i + len(self.x[c])]))
            i += len(self.x[c])
        return out

    def _f64(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float64, device=self.dev)

    def _set(self, dst: torch.Tensor, new, mask: torch.Tensor) -> None:
        """``dst`` <- ``new`` for the subjects of ``mask`` (B,); the others
        keep their values bitwise. One subject: a plain copy (the branch
        that calls this runs only where the subject needs it)."""
        if self.B > 1:
            shape = mask.shape + (1,) * (dst.dim() - 1)
            new = torch.where(mask.reshape(shape), new, dst)
        dst.copy_(new)

    def _stacked(self, st: FitState, xdats, subdats):
        """The state and data with the leading subject axis: a single fit's
        as views with one subject."""
        if self.batched:
            return st, xdats, subdats
        fields = {f.name: getattr(st, f.name) for f in
                  dataclasses.fields(st)}
        v = FitState(**{k: t[None] if isinstance(t, torch.Tensor) else t
                        for k, t in fields.items()})
        return (v, [[d[None] for d in xc] for xc in xdats],
                [None if d is None else d[None] for d in subdats])

    def rho_of(self, lams: torch.Tensor) -> torch.Tensor:
        if self.rho_fixed is not None:
            return self.rho_fixed
        mean = lams[:, 0]
        for c in range(1, self.C):
            mean = mean + lams[:, c]
        return (mean / self.C).reciprocal() * self.rho_num

    def _maps(self, q, b):
        """(M, Minv) of subject b's main operators at poses q (Nobs, 6)."""
        return compose_maps(self.pre[b], se3_expm(self._f64(q), self.basis),
                            self.post[b])

    def maps(self, q):
        """Nested (Ms, Minvs) of the main operators at poses q (Nobs, 6),
        (3, 4) float32 tensors on the fit's device (subject 0)."""
        M, Minv = self._maps(q, 0)
        return self.nested(list(M)), self.nested(list(Minv))

    # -- the per-observation updates ------------------------------------------
    # The hooks take one subject's host values (subject 0), as the tests call
    # them; the iteration calls the stacked forms.

    def scaling_obs(self, ys_c, dat_x, M, s0, i):
        """Scaling GN step of observation i at map M from scale s0 (rounded
        to float32 first): the new scale, a 0-d float64 tensor."""
        return self._scaling(ys_c[None], dat_x[None], M[None],
                             self._f64(s0).reshape(1), i)[0]

    def rigid_stats(self, ys_c, dat_x, q_i, s_i, i, debug=False):
        """GN delta (6,) and data term (0-d) of observation i at pose q_i,
        float64 tensors (and the gradient and Hessian when ``debug``)."""
        out = self._rigid_stats(ys_c[None], dat_x[None],
                                self._f64(q_i)[None],
                                self._f64(s_i).reshape(1), i, debug)
        return (out[0][0], out[1][0]) + tuple(out[2:])

    def rigid_ls(self, ys_c, dat_x, q_i, s_i, i, delta, ll):
        """Halving line search along -delta from step 1: the first candidate
        that lowers the data term ``ll``, later ones not evaluated; q_i if
        none does. Returns a (6,) float64 tensor."""
        return self._rigid_ls(ys_c[None], dat_x[None], self._f64(q_i)[None],
                              self._f64(s_i).reshape(1), i, delta[None],
                              ll.reshape(1))[0]

    def _scaling(self, ys_c, dat_x, M, s0, i, live=None):
        """The scaling GN step of observation i for every subject: (B,)."""
        s0 = s0.to(torch.float32).to(torch.float64)
        y0 = self.suites[i]["project"](ys_c, M)  # pull + blur, no scaling
        c, n = self.obs[i]
        return scaling_gn(y0, dat_x, s0, self.tau64[i],
                          self.x[c][n].po.dim_thick, _NUM_LS, live)[0]

    def _rigid_stats(self, ys_c, dat_x, q_i, s_i, i, debug=False):
        """GN deltas (B, 6) and data terms (B,) of observation i."""
        sub = self.subs[i]
        Ms, dRqs = [], []
        for b in range(self.B):
            pre, post = self.pre[b, i], self.sub_post[b, i]
            R, dR = se3_dexpm(q_i[b], self.basis)
            Ms.append(compose_maps(pre, R, post)[0])
            dRqs.append(pre @ dR @ post)
        v = match_stats_device(
            dat_x, ys_c, torch.stack(Ms), s_i.to(torch.float32),
            self.tau64[i], self.sub_suites[i], sub["po"], self.sr,
            self.coords[i], self.ctcs[i])
        deltas, extra = [], None
        for b in range(self.B):
            G, W = v[b, 1:13].reshape(3, 4), v[b, 13:].reshape(6, 10)
            g, H = _assemble(G[:, 0], G[:, 1:4], W[:, 0], W[:, 1:4],
                             W[:, 4:], dRqs[b], self.centers[i], self.lkp)
            deltas.append(gn_delta(g, H))
            extra = extra or dict(g=g, H=H)  # subject 0's
        if debug:
            return torch.stack(deltas), v[:, 0], extra
        return torch.stack(deltas), v[:, 0]

    def _rigid_ls(self, ys_c, dat_x, q_i, s_i, i, delta, ll, live=None):
        """The line searches of observation i for every subject: (B, 6)."""
        sub = self.subs[i]
        cands = [q_i[b] - self.steps[:, None] * delta[b]
                 for b in range(self.B)]
        Mc = torch.stack([compose_maps(self.pre[b, i],
                                       se3_expm(cands[b], self.basis),
                                       self.sub_post[b, i])[0]
                          for b in range(self.B)], dim=1)  # (NUM_LS, B, ...)
        cands = torch.stack(cands, dim=1)  # (NUM_LS, B, 6)
        s32 = s_i.to(torch.float32)
        q_out = q_i.clone()
        acc = (torch.zeros(self.B, dtype=torch.bool, device=self.dev)
               if live is None else ~live)
        for k in range(_NUM_LS):
            def candidate(k=k):
                llc = match_ll_device(dat_x, ys_c, Mc[k], s32, self.tau64[i],
                                      self.sub_suites[i], sub["po"], self.sr)
                ok = llc < ll
                if self.B > 1:  # one subject runs this only while ~acc
                    ok = ok & ~acc
                q_out.copy_(torch.where(ok[:, None], cands[k], q_out))
                acc.copy_(acc | ok)
            cond(any_of(~acc), candidate)
        return q_out

    def _rigid_round(self, v, xdats, subdats, mask):
        """One rigid round over every observation of the subjects of
        ``mask``: q updated in place."""
        dats, deltas, lls = [], [], []
        for i, (c, n) in enumerate(self.obs):
            dat_i = xdats[c][n] if self.subs[i]["sub_is_main"] else subdats[i]
            dats.append(dat_i)
            d_i, ll_i = self._rigid_stats(v.ys[:, c], dat_i, v.q[:, i],
                                          v.scl[:, i], i)
            deltas.append(d_i)
            lls.append(ll_i)
        deltas = torch.stack(deltas, dim=1)  # (B, Nobs, 6)
        gauge = self.gauge_anchor and self.Nobs > 1
        if gauge:
            # project the pose-gauge common mode out of the GN steps before
            # the line searches (the joint model is gauge-free)
            deltas = each(lambda d: d - d.mean(dim=0, keepdim=True), deltas,
                          2)
        live = None if self.B == 1 else mask
        qn = torch.stack([self._rigid_ls(v.ys[:, c], dats[i], v.q[:, i],
                                         v.scl[:, i], i, deltas[:, i],
                                         lls[i], live)
                          for i, (c, n) in enumerate(self.obs)], dim=1)
        if gauge:
            # the line searches may re-introduce a small common mode:
            # re-centre only when it drifts beyond 0.25 (mm / 10 mrad)
            def recentre(q):
                mq = q.mean(dim=0)
                drift = (mq.abs() / self.gauge_scale).max()
                return torch.where(drift > 0.25, q - mq[None], q)

            qn = each(recentre, qn, 2)
        self._set(v.q, qn, mask)

    # -- one outer iteration ------------------------------------------------

    def iterate(self, st: FitState, xdats, subdats=None) -> None:
        """One outer iteration of ``st``, in place, its objective and gain
        in the next output row; frozen (nothing changes, the row is not
        valid) once done or at ``max_iter``, as the JAX loop's
        ``lax.cond(frozen, ...)``: per subject in a batch."""
        if subdats is None:
            subdats = [None] * self.Nobs
        v, xdats, subdats = self._stacked(st, xdats, subdats)
        alive = ~(v.done | (v.n_iter >= self.max_iter))
        cond(any_of(alive), lambda: self._live(v, xdats, subdats, alive))
        self.kidx.add_(1)

    def _live(self, v, xdats, subdats, alive):
        B = self.B
        for b in range(B):
            M, Minv = self._maps(v.q[b], b)
            self.M[:, b].copy_(M)
            for i in range(self.Nobs):
                self.plan[i, b].copy_(push_plan(self.M[i, b], Minv[i], 1,
                                                self.src_dims[i], self.dim_y))
        Ms = self.nested(list(self.M))
        plans = self.nested(list(self.plan))
        scls = self.nested(list(v.scl.to(torch.float32).T))
        taus = self.nested(list(self.tau32))

        mc = alive & (~v.has_cdiags | (v.n_iter % self.cadence == 0))

        def refresh_cdiags():
            self._set(v.cdiags, self.cdiag_fn(Ms, plans, scls, taus), mc)
            v.has_cdiags.copy_(v.has_cdiags | mc)

        cond(any_of(mc), refresh_cdiags)
        lams = (self.reg_scl.index_select(0, v.cnt_scl)[:, None]
                * self.lam0)
        ys, z, w, jtv, obj = self.admm_body(
            v.ys, v.z, v.w, xdats, Ms, plans, scls, taus, lams,
            self.rho_of(lams), v.cdiags, None if B == 1 else alive)
        self._set(v.ys, ys, alive)
        self._set(v.z, z, alive)
        self._set(v.w, w, alive)
        self._set(v.jtv, jtv, alive)
        del ys, z, w, jtv

        # gain over the posterior trace (nitorch get_gain)
        o0 = obj[:, 0]
        omax = torch.maximum(v.obj_max, o0)
        omin = torch.minimum(v.obj_min, o0)
        denom = omax - omin
        gain = torch.where(v.has_prev,
                           torch.where(denom > 0, (v.prev_obj - o0) / denom,
                                       0.0), float("inf"))
        # convergence countdown (reference run.py:103-110)
        conv_ok = ((v.cnt_scl >= self.n_sched - 1) & (v.cnt_scl_iter > 20)
                   & ((gain.abs() < self.tol)
                      | (v.n_iter >= self.max_iter - 1)))
        cd0 = torch.where(conv_ok, v.countdown0 - 1, 6)
        done_now = conv_ok & (cd0 == 0)
        m = alive & ~done_now
        cond(any_of(m), lambda: self._tail(v, xdats, subdats, Ms, gain, m))

        self._set(v.cnt_scl_iter, v.cnt_scl_iter + 1, alive)
        self._set(v.countdown0, cd0, alive)
        self._set(v.n_iter, v.n_iter + 1, alive)
        self._set(v.done, v.done | done_now, alive)
        self._set(v.prev_obj, o0, alive)
        self._set(v.obj_max, omax, alive)
        self._set(v.obj_min, omin, alive)
        v.has_prev.copy_(v.has_prev | alive)
        if B > 1:  # a frozen subject's row stays empty
            obj = torch.where(alive[:, None], obj, 0.0)
            gain = torch.where(alive, gain, 0.0)
        self.objs.index_copy_(1, self.kidx, obj.view(B, 1, 3))
        self.gains.index_copy_(1, self.kidx, gain.view(B, 1))
        self.valid.index_copy_(1, self.kidx, alive.view(B, 1))

    def _tail(self, v, xdats, subdats, Ms, gain, m):
        """Scaling, rigid and the schedule step of a live iteration that
        has not converged, for the subjects of ``m``."""
        live = None if self.B == 1 else m
        if self.do_scaling:
            for i, (c, n) in enumerate(self.obs):
                if not self.ct[i]:
                    self._set(v.scl[:, i], self._scaling(
                        v.ys[:, c], xdats[c][n], Ms[c][n], v.scl[:, i], i,
                        live), m)
        if self.do_rigid:
            mr = m & (v.n_iter > 0) & (v.n_iter % self.rigid_mod == 0)
            cond(any_of(mr),
                 lambda: self._rigid_round(v, xdats, subdats, mr))
        # schedule step (reference run.py:140-155)
        sch_ok = ((v.cnt_scl + 1 < self.n_sched) & (v.cnt_scl_iter > 16)
                  & (gain.abs() < 1e-3))
        cd1 = torch.where(sch_ok, v.countdown1 - 1, 6)
        stepped = sch_ok & (cd1 == 0) & m
        self._set(v.countdown1, torch.where(stepped, 6, cd1), m)

        def step_schedule():
            # z approximates lam D y: rescale it by lam'/lam at the step
            # (w by (lam'/lam)(rho'/rho) = 1), as the JAX loop does; a
            # subject that does not step is multiplied by 1
            nxt = torch.clamp(v.cnt_scl + 1, max=self.n_sched - 1)
            fac = (self.reg_scl.index_select(0, nxt)
                   / self.reg_scl.index_select(0, v.cnt_scl))
            if self.B > 1:
                fac = torch.where(stepped, fac, 1.0)
            v.z.mul_(fac.to(torch.float32).reshape((-1,) + (1,) * 5))
            self._set(v.cnt_scl, v.cnt_scl + 1, stepped)
            self._set(v.cnt_scl_iter, torch.zeros_like(v.cnt_scl_iter),
                      stepped)

        cond(any_of(stepped), step_schedule)

    # -- the chunk ----------------------------------------------------------

    def __call__(self, st: FitState, xdats, subdats=None, n=None):
        n = self.K if n is None else int(n)
        if not 1 <= n <= self.K:
            raise ValueError(f"a chunk runs 1 to {self.K} iterations, not {n}")
        if subdats is None:
            subdats = [None] * self.Nobs
        if self.capture:
            key = (id(st), tuple(d.data_ptr() for xc in xdats for d in xc),
                   tuple(0 if d is None else d.data_ptr() for d in subdats))
            if self.graph is None or self._bound != key:
                self._capture(st, xdats, subdats)
                self._bound = key
        for t in (self.objs, self.gains, self.valid, self.kidx):
            t.zero_()
        for _ in range(n):
            if self.capture:
                self.graph.replay()
            else:
                self.iterate(st, xdats, subdats)
        if self.batched:
            return st, self.objs[:, :n], self.gains[:, :n], self.valid[:, :n]
        return st, self.objs[0, :n], self.gains[0, :n], self.valid[0, :n]

    def _capture(self, st, xdats, subdats):
        """Warm every branch up on a copy of the state (every kernel, every
        library handle and workspace exists before the capture starts),
        then capture one iteration of ``st``: a ``fit.capture`` span
        (``utils.trace``) with the graph's ``nodes``."""
        self.graph = None
        with trace.span("fit.capture") as span:
            scratch = st.clone()
            with torch.cuda.device(self.dev), forced():
                self.iterate(scratch, xdats, subdats)
            del scratch
            with torch.cuda.device(self.dev):
                self.graph = capture(lambda: self.iterate(st, xdats, subdats))
            span.attrs["nodes"] = self.graph.nodes

    def read(self, st: FitState, n: int) -> dict:
        """The host's one read of a chunk of ``n`` iterations: objs (n, 3),
        gains (n,), valid (n,), q, scl and the state's scalars, packed into
        one float64 vector; also written into ``st.host``. A batched chunk
        reads every subject at once: objs (B, n, 3), gains and valid (B,
        n), q (B, Nobs, 6), scl (B, Nobs) and each scalar (B,) arrays."""
        B = self.B
        parts = [self.objs[:, :n].reshape(-1), self.gains[:, :n].reshape(-1),
                 self.valid[:, :n].to(torch.float64).reshape(-1),
                 st.q.reshape(-1), st.scl.reshape(-1)]
        parts += [getattr(st, k).to(torch.float64).reshape(-1)
                  for k in SCALARS]
        v = to_host(torch.cat(parts))
        lead = (B,) if self.batched else ()
        out, j = {}, 0
        for name, shape in (("objs", lead + (n, 3)), ("gains", lead + (n,)),
                            ("valid", lead + (n,)), ("q", tuple(st.q.shape)),
                            ("scl", tuple(st.scl.shape))):
            size = int(np.prod(shape))
            out[name] = v[j:j + size].reshape(shape)
            j += size
        out["valid"] = out["valid"] != 0
        for i, k in enumerate(SCALARS):
            val = v[j + i * B:j + (i + 1) * B]
            dtype = np.int64 if k in _INTS else bool if k in _FLAGS else None
            out[k] = (val.astype(dtype) if dtype else val) if self.batched \
                else _host_scalar(k, val[0])
        st.host.update({k: out[k] for k in ("q", "scl") + SCALARS})
        return out


def make_fit_chunk(x, y, sett, K: int, capture: Optional[bool] = None
                   ) -> FitChunk:
    """The K-iteration fit chunk of this problem (:class:`FitChunk`): the
    counterpart of ``unires_tpu.solvers.fitloop.make_fit_chunk``.
    ``capture=False`` runs it uncaptured on the card (tests and
    ``chip_smoke.py`` only; the fit captures on a CUDA device)."""
    return FitChunk(x, y, sett, K, capture)


def make_batch_chunk(xs, ys, sett, K: int, capture: Optional[bool] = None
                     ) -> FitChunk:
    """The K-iteration chunk of a geometry-homogeneous batch (``xs``,
    ``ys``: the subjects' structs on one device; ``sett`` subject 0's):
    one chunk, built from subject 0, every subject's state, data, taus,
    lam0 and geometry stacked on a leading subject axis
    (:func:`stack_states`), the counterpart of ``unires_tpu.parallel.
    fit_batch.make_batch_chunk`` on one device (its ``vmap``). On the card
    it is one captured graph for all the subjects, read once per chunk.
    With one subject the iteration is the single fit's."""
    return FitChunk(xs[0], ys[0], sett, K, capture, batch=(xs, ys))
