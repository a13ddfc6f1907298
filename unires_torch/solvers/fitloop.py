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
    (``pipeline.fit.FitRun``) decides from it and never reads the device
    state again in between."""

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


def chunk_geom(x, y, sett):
    """Per-observation geometry of the fit: ``(pres, posts, subs)``.

    pres/posts are the float64 4x4 factors of the centre-conjugated maps.
    ``subs[i]`` is None without unified rigid, else a dict describing the
    rigid-subsample grid: ``po`` (the operator on it), ``post`` (its post
    factor), ``dim``, ``center`` and ``sub_is_main`` (the grids coincide,
    the ``rigid_samp=1`` default on >= 1 mm data). This is the one place
    that decides the grid: ``pipeline.fit._gather_subdats`` reads it.
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
    volumes (``pipeline.fit._gather_subdats`` of :attr:`subs`; None where
    the grids coincide). The per-observation updates ``maps``,
    ``scaling_obs``, ``rigid_stats`` and ``rigid_ls`` are methods, as the
    JAX chunk's ``_debug``.
    """

    def __init__(self, x, y, sett, K: int, capture: Optional[bool] = None):
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
        pres, posts, self.subs = chunk_geom(x, y, sett)
        self.pre, self.post = f64(np.stack(pres)), f64(np.stack(posts))
        self.suites = [make_obs_suite(x[c][n].po, method) for (c, n) in obs]
        self.src_dims = [tuple(x[c][n].po.dim_yx if self.sr
                               else x[c][n].po.dim_x) for (c, n) in obs]
        self.taus = [[float(np.float32(o.tau)) for o in x[c]]
                     for c in range(C)]

        # the schedule holds float32 values, as the JAX loop's device table
        reg = np.atleast_1d(np.asarray(sett.reg_scl, np.float32))
        self.n_sched = int(reg.size)
        self.reg_scl = f64(reg.astype(np.float64))
        self.lam0 = f64([float(yc.lam0) for yc in y])
        has_ct = any(o.ct for xc in x for o in xc)
        rho_fixed = (1.0 if has_ct else
                     (float(sett.rho) if sett.rho is not None else None))
        tau_all = [self.taus[c][n] for (c, n) in obs]
        # rho = rho_scl sqrt(mean tau) / mean lam, the first factor fixed
        self.rho_fixed = None if rho_fixed is None else f64(rho_fixed)
        self.rho_num = float(sett.rho_scl) * float(np.sqrt(np.mean(tau_all)))
        self.tol = float(sett.tolerance)
        self.max_iter = int(sett.max_iter)
        self.cadence = max(1, min(int(getattr(sett, "chunk_iters", 16)),
                                  self.max_iter))
        self.do_scaling = bool(sett.scaling)
        self.do_rigid = bool(sett.unified_rigid)
        self.gauge_anchor = bool(getattr(sett, "rigid_gauge_anchor", True))
        self.rigid_mod = max(int(sett.rigid_mod), 1)
        self.ct = [x[c][n].ct for (c, n) in obs]

        if self.do_rigid:
            self.sub_post = f64(np.stack([s["post"] for s in self.subs]))
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
        # poses, the outputs, and the index of the next output row
        self.M = torch.zeros((Nobs, 3, 4), dtype=torch.float32, device=dev)
        self.plan = torch.zeros((Nobs, PLAN_SIZE), dtype=torch.float32,
                                device=dev)
        self.objs = torch.zeros((K, 3), dtype=torch.float64, device=dev)
        self.gains = torch.zeros(K, dtype=torch.float64, device=dev)
        self.valid = torch.zeros(K, dtype=torch.bool, device=dev)
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

    def rho_of(self, lams: torch.Tensor) -> torch.Tensor:
        if self.rho_fixed is not None:
            return self.rho_fixed
        mean = lams[0]
        for c in range(1, self.C):
            mean = mean + lams[c]
        return self.rho_num / (mean / self.C)

    def maps(self, q):
        """Nested (Ms, Minvs) of the main operators at poses q (Nobs, 6),
        (3, 4) float32 tensors on the fit's device."""
        M, Minv = compose_maps(self.pre, se3_expm(self._f64(q), self.basis),
                               self.post)
        return self.nested(list(M)), self.nested(list(Minv))

    # -- the per-observation updates ------------------------------------------

    def scaling_obs(self, ys_c, dat_x, M, s0, i):
        """Scaling GN step of observation i at map M from scale s0 (rounded
        to float32 first): the new scale, a 0-d float64 tensor."""
        c, n = self.obs[i]
        s0 = self._f64(s0).to(torch.float32).to(torch.float64)
        y0 = self.suites[i]["project"](ys_c, M)  # pull + blur, no scaling
        return scaling_gn(y0, dat_x, s0, self.taus[c][n],
                          self.x[c][n].po.dim_thick, _NUM_LS)[0]

    def rigid_stats(self, ys_c, dat_x, q_i, s_i, i, debug=False):
        """GN delta (6,) and data term (0-d) of observation i at pose q_i,
        float64 tensors (and the gradient and Hessian when ``debug``)."""
        c, n = self.obs[i]
        sub = self.subs[i]
        pre, post = self.pre[i], self.sub_post[i]
        R, dR = se3_dexpm(self._f64(q_i), self.basis)
        M = compose_maps(pre, R, post)[0]
        dRq = pre @ dR @ post
        v = match_stats_device(
            dat_x, ys_c, M, self._f64(s_i).to(torch.float32),
            self.taus[c][n], self.sub_suites[i], sub["po"], self.sr,
            self.coords[i], self.ctcs[i])
        G, W = v[1:13].reshape(3, 4), v[13:].reshape(6, 10)
        g, H = _assemble(G[:, 0], G[:, 1:4], W[:, 0], W[:, 1:4], W[:, 4:],
                         dRq, self.centers[i], self.lkp)
        delta = gn_delta(g, H)
        if debug:
            return delta, v[0], dict(g=g, H=H)
        return delta, v[0]

    def rigid_ls(self, ys_c, dat_x, q_i, s_i, i, delta, ll):
        """Halving line search along -delta from step 1: the first candidate
        that lowers the data term ``ll``, later ones not evaluated; q_i if
        none does. Returns a (6,) float64 tensor."""
        c, n = self.obs[i]
        sub = self.subs[i]
        q_i = self._f64(q_i)
        cands = q_i - self.steps[:, None] * delta
        Mc = compose_maps(self.pre[i], se3_expm(cands, self.basis),
                          self.sub_post[i])[0]
        s32 = self._f64(s_i).to(torch.float32)
        q_out = q_i.clone()
        acc = torch.zeros((), dtype=torch.bool, device=self.dev)
        for k in range(_NUM_LS):
            def candidate(k=k):
                llc = match_ll_device(dat_x, ys_c, Mc[k], s32,
                                      self.taus[c][n], self.sub_suites[i],
                                      sub["po"], self.sr)
                ok = llc < ll
                q_out.copy_(torch.where(ok, cands[k], q_out))
                acc.copy_(acc | ok)
            cond(~acc, candidate)
        return q_out

    def _rigid_round(self, st, xdats, subdats):
        """One rigid round over every observation: q updated in place."""
        dats, deltas, lls = [], [], []
        for i, (c, n) in enumerate(self.obs):
            dat_i = xdats[c][n] if self.subs[i]["sub_is_main"] else subdats[i]
            dats.append(dat_i)
            d_i, ll_i = self.rigid_stats(st.ys[c], dat_i, st.q[i], st.scl[i],
                                         i)
            deltas.append(d_i)
            lls.append(ll_i)
        deltas = torch.stack(deltas)
        gauge = self.gauge_anchor and self.Nobs > 1
        if gauge:
            # project the pose-gauge common mode out of the GN steps before
            # the line searches (the joint model is gauge-free)
            deltas = deltas - deltas.mean(dim=0, keepdim=True)
        qn = torch.stack([self.rigid_ls(st.ys[c], dats[i], st.q[i], st.scl[i],
                                        i, deltas[i], lls[i])
                          for i, (c, n) in enumerate(self.obs)])
        if gauge:
            # the line searches may re-introduce a small common mode:
            # re-centre only when it drifts beyond 0.25 (mm / 10 mrad)
            mq = qn.mean(dim=0)
            drift = (mq.abs() / self.gauge_scale).max()
            qn = torch.where(drift > 0.25, qn - mq[None], qn)
        st.q.copy_(qn)

    # -- one outer iteration ------------------------------------------------

    def iterate(self, st: FitState, xdats, subdats=None) -> None:
        """One outer iteration of ``st``, in place, its objective and gain
        in the next output row; frozen (nothing changes, the row is not
        valid) once done or at ``max_iter``, as the JAX loop's
        ``lax.cond(frozen, ...)``."""
        frozen = st.done | (st.n_iter >= self.max_iter)
        cond(~frozen, lambda: self._live(st, xdats, subdats))
        self.kidx.add_(1)

    def _live(self, st, xdats, subdats):
        M, Minv = compose_maps(self.pre, se3_expm(st.q, self.basis),
                               self.post)
        self.M.copy_(M)
        for i in range(self.Nobs):
            self.plan[i].copy_(push_plan(self.M[i], Minv[i], 1,
                                         self.src_dims[i], self.dim_y))
        Ms = self.nested(list(self.M))
        plans = self.nested(list(self.plan))
        scls = self.nested(list(st.scl.to(torch.float32)))

        def refresh_cdiags():
            st.cdiags.copy_(self.cdiag_fn(Ms, plans, scls, self.taus))
            st.has_cdiags.fill_(True)

        cond(~st.has_cdiags | (st.n_iter % self.cadence == 0), refresh_cdiags)
        lams = self.reg_scl.index_select(0, st.cnt_scl.view(1)) * self.lam0
        ys, z, w, jtv, obj = self.admm_body(
            st.ys, st.z, st.w, xdats, Ms, plans, scls, self.taus, lams,
            self.rho_of(lams), st.cdiags)
        st.ys.copy_(ys)
        st.z.copy_(z)
        st.w.copy_(w)
        st.jtv.copy_(jtv)
        del ys, z, w, jtv

        # gain over the posterior trace (nitorch get_gain)
        o0 = obj[0]
        omax = torch.maximum(st.obj_max, o0)
        omin = torch.minimum(st.obj_min, o0)
        denom = omax - omin
        gain = torch.where(st.has_prev,
                           torch.where(denom > 0, (st.prev_obj - o0) / denom,
                                       0.0), float("inf"))
        # convergence countdown (reference run.py:103-110)
        conv_ok = ((st.cnt_scl >= self.n_sched - 1) & (st.cnt_scl_iter > 20)
                   & ((gain.abs() < self.tol)
                      | (st.n_iter >= self.max_iter - 1)))
        cd0 = torch.where(conv_ok, st.countdown0 - 1, 6)
        done_now = conv_ok & (cd0 == 0)
        cond(~done_now, lambda: self._tail(st, xdats, subdats, Ms, gain))

        st.cnt_scl_iter.add_(1)
        st.countdown0.copy_(cd0)
        st.n_iter.add_(1)
        st.done.copy_(st.done | done_now)
        st.prev_obj.copy_(o0)
        st.obj_max.copy_(omax)
        st.obj_min.copy_(omin)
        st.has_prev.fill_(True)
        self.objs.index_copy_(0, self.kidx, obj.view(1, 3))
        self.gains.index_copy_(0, self.kidx, gain.view(1))
        self.valid.index_fill_(0, self.kidx, True)

    def _tail(self, st, xdats, subdats, Ms, gain):
        """Scaling, rigid and the schedule step of a live iteration that
        has not converged."""
        if self.do_scaling:
            for i, (c, n) in enumerate(self.obs):
                if not self.ct[i]:
                    st.scl[i].copy_(self.scaling_obs(
                        st.ys[c], xdats[c][n], Ms[c][n], st.scl[i], i))
        if self.do_rigid:
            cond((st.n_iter > 0) & (st.n_iter % self.rigid_mod == 0),
                 lambda: self._rigid_round(st, xdats, subdats))
        # schedule step (reference run.py:140-155)
        sch_ok = ((st.cnt_scl + 1 < self.n_sched) & (st.cnt_scl_iter > 16)
                  & (gain.abs() < 1e-3))
        cd1 = torch.where(sch_ok, st.countdown1 - 1, 6)
        stepped = sch_ok & (cd1 == 0)
        st.countdown1.copy_(torch.where(stepped, 6, cd1))

        def step_schedule():
            # z approximates lam D y: rescale it by lam'/lam at the step
            # (w by (lam'/lam)(rho'/rho) = 1), as the JAX loop does
            nxt = torch.clamp(st.cnt_scl + 1, max=self.n_sched - 1)
            fac = (self.reg_scl.index_select(0, nxt.view(1))
                   / self.reg_scl.index_select(0, st.cnt_scl.view(1)))
            st.z.mul_(fac.to(torch.float32))
            st.cnt_scl.add_(1)
            st.cnt_scl_iter.zero_()

        cond(stepped, step_schedule)

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
        return st, self.objs[:n], self.gains[:n], self.valid[:n]

    def _capture(self, st, xdats, subdats):
        """Warm every branch up on a copy of the state (every kernel, every
        library handle and workspace exists before the capture starts),
        then capture one iteration of ``st``."""
        self.graph = None
        scratch = st.clone()
        with torch.cuda.device(self.dev), forced():
            self.iterate(scratch, xdats, subdats)
        del scratch
        with torch.cuda.device(self.dev):
            self.graph = capture(lambda: self.iterate(st, xdats, subdats))

    def read(self, st: FitState, n: int) -> dict:
        """The host's one read of a chunk of ``n`` iterations: objs (n, 3),
        gains (n,), valid (n,), q, scl and the state's scalars, packed into
        one float64 vector; also written into ``st.host``."""
        parts = [self.objs[:n].reshape(-1), self.gains[:n],
                 self.valid[:n].to(torch.float64), st.q.reshape(-1), st.scl]
        parts += [getattr(st, k).to(torch.float64).reshape(1)
                  for k in SCALARS]
        v = to_host(torch.cat(parts))
        out, j = {}, 0
        for name, size in (("objs", 3 * n), ("gains", n), ("valid", n),
                           ("q", st.q.numel()), ("scl", st.scl.numel())):
            out[name] = v[j:j + size]
            j += size
        out["objs"] = out["objs"].reshape(n, 3)
        out["valid"] = out["valid"] != 0
        out["q"] = out["q"].reshape(tuple(st.q.shape))
        for k, val in zip(SCALARS, v[j:]):
            out[k] = (int(val) if k in _INTS else bool(val) if k in _FLAGS
                      else float(val))
        st.host.update({k: out[k] for k in ("q", "scl") + SCALARS})
        return out


def make_fit_chunk(x, y, sett, K: int, capture: Optional[bool] = None
                   ) -> FitChunk:
    """The K-iteration fit chunk of this problem (:class:`FitChunk`): the
    counterpart of ``unires_tpu.solvers.fitloop.make_fit_chunk``.
    ``capture=False`` runs it uncaptured on the card (tests and
    ``chip_smoke.py`` only; the fit captures on a CUDA device)."""
    return FitChunk(x, y, sett, K, capture)
