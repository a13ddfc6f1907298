"""unires_torch.parallel.sharding on 4 gloo ranks against the JAX package.

The problem of tests/test_sharding.py: B, C, R = 4, 2, 2 subjects, channels
and repeats at (16, 16, 17) -> (16, 16, 5), over ``build_mesh(4, batch=2)``
(each rank a (2, 1) block). The port's sharded step is held against the JAX
sharded step on 4 of the 8 virtual CPU devices, and against the port's own
unsharded ``make_admm_step`` subject by subject, at that file's tolerances:
ys 2e-3 of its scale, z and w 1e-3, the objective rtol 2e-3 (CG over
float32 inner products in other orders; the port sums the objective in
float64). The single-repeat operands and the dry run of the multi-device
surface run too. The ranks are spawned once for the file
(``unires_torch.parallel.launch.spawn``); they import only unires_torch.
"""
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import unires_torch
import unires_tpu
from unires_torch.models.forward import make_obs_ops as t_make_obs_ops
from unires_torch.models.forward import obs_dyn_args as t_obs_dyn_args
from unires_torch.models.proj_op import proj_info as t_proj_info
from unires_torch.parallel import dryrun
from unires_torch.parallel.launch import run_cases, spawn
from unires_torch.solvers.admm import make_admm_step as t_make_admm_step
from unires_tpu.geometry import affine_diag, affine_matrix_classic
from unires_tpu.models.proj_op import proj_info as j_proj_info
from unires_tpu.parallel.sharding import build_mesh as j_build_mesh
from unires_tpu.parallel.sharding import make_sharded_admm_step as j_step
from unires_tpu.parallel.sharding import shard_state as j_shard_state

torch.set_num_threads(2)

WORLD = 4
B, C, R = 4, 2, 2
DIM_Y, DIM_X = (16, 16, 17), (16, 16, 5)
TAUS = np.array([0.5, 0.8])
LAM, RHO = 0.1, 1.3
SETT = dict(do_print=0, cgs_max_iter=8, cgs_tol=1e-9, vx=1.0)
# the single-repeat case of tests/test_sharding.py
B1, C1, DIM_Y1, DIM_X1 = 4, 2, (8, 8, 9), (8, 8, 3)


def _geometry(proj_info, dim_y, dim_x, rigid=None):
    kw = {} if rigid is None else dict(rigid=rigid)
    return proj_info(dim_y, np.eye(4), dim_x, affine_diag([1, 1, 4]),
                     prof_ip=2, prof_tp=0, **kw)


RIGIDS = [None, affine_matrix_classic([0.4, -0.2, 0.1])]


def _settings(pkg, cgs_max_iter, cgs_tol):
    sett = pkg.Settings(**dict(SETT, cgs_max_iter=cgs_max_iter,
                               cgs_tol=cgs_tol))
    sett.method, sett.do_proj = "super-resolution", True
    return sett


@pytest.fixture(scope="module")
def problem():
    """Inputs (numpy, from seeds) and the port's ranks' results."""
    pos = [_geometry(t_proj_info, DIM_Y, DIM_X, r) for r in RIGIDS]
    rng = np.random.default_rng(0)
    gt = rng.random((B, C) + DIM_Y, dtype=np.float32) * 100
    Ms, Minvs = zip(*[t_obs_dyn_args(p, "super-resolution") for p in pos])
    A = [t_make_obs_ops(p, "super-resolution")[0] for p in pos]
    xdat = np.stack([[[A[n](torch.from_numpy(gt[b, c]), Ms[n], Minvs[n],
                            0.0).numpy() for c in range(C)]
                      for b in range(B)] for n in range(R)])
    state = dict(ys=gt * 0.5, z=np.zeros((B, C, 3) + DIM_Y, np.float32),
                 w=0.05 * np.ones((B, C, 3) + DIM_Y, np.float32), xdat=xdat,
                 M=np.stack(Ms), Minv=np.stack(Minvs),
                 scl=np.zeros((R, B, C)),
                 tau=np.broadcast_to(TAUS[:, None, None], (R, B, C)).copy(),
                 lam=np.full((B, C), LAM), rho=RHO)

    po1 = _geometry(t_proj_info, DIM_Y1, DIM_X1)
    gt1 = np.random.default_rng(1).random((B1, C1) + DIM_Y1, dtype=np.float32)
    M1, Minv1 = t_obs_dyn_args(po1, "super-resolution")
    A1 = t_make_obs_ops(po1, "super-resolution")[0]
    xd1 = np.stack([[A1(torch.from_numpy(gt1[b, c]), M1, Minv1, 0.0).numpy()
                     for c in range(C1)] for b in range(B1)])
    state1 = dict(ys=gt1, z=np.zeros((B1, C1, 3) + DIM_Y1, np.float32),
                  w=np.zeros((B1, C1, 3) + DIM_Y1, np.float32), xdat=xd1,
                  M=M1, Minv=Minv1, scl=np.zeros((B1, C1)),
                  tau=np.ones((B1, C1)), lam=np.full((B1, C1), 0.1), rho=1.0)

    cases = [
        (dryrun.sharded_step_rank, dict(
            po=pos, method="super-resolution",
            sett=_settings(unires_torch, 8, 1e-9), batch=2, **state)),
        (dryrun.sharded_step_rank, dict(
            po=po1, method="super-resolution",
            sett=_settings(unires_torch, 3, 1e-6), batch=2, **state1)),
    ]
    with ThreadPoolExecutor(1) as pool:  # the JAX step runs meanwhile
        job = pool.submit(spawn, run_cases, WORLD, "gloo", cases)
        jax_out = (_jax_sharded(state, [_geometry(j_proj_info, DIM_Y, DIM_X,
                                                  r) for r in RIGIDS],
                                _settings(unires_tpu, 8, 1e-9))
                   if len(jax.devices()) >= WORLD else None)
        ranks = job.result()
    return dict(pos=pos, gt=gt, state=state, state1=state1,
                main=_assemble([r[0] for r in ranks], B, C),
                single=_assemble([r[1] for r in ranks], B1, C1),
                ranks=ranks, jax=jax_out)


def _assemble(outs, nb, nc):
    """The global (B, C, ...) ys / z / w from the ranks' blocks."""
    full = {}
    for key in ("ys", "z", "w"):
        blk = outs[0][key]
        arr = np.zeros((nb, nc) + blk.shape[2:], np.float32)
        for o in outs:
            b0, c0 = (o["coords"][0] * blk.shape[0],
                      o["coords"][1] * blk.shape[1])
            arr[b0:b0 + blk.shape[0], c0:c0 + blk.shape[1]] = o[key]
        full[key] = arr
    full["obj"] = outs[0]["obj"]
    full["objs"] = [o["obj"] for o in outs]
    return full


def _jax_sharded(state, pos, sett):
    mesh = j_build_mesh(WORLD, batch=2)
    step = j_step(pos, "super-resolution", sett, mesh)
    ys, z, w, xd = j_shard_state(mesh, jnp.asarray(state["ys"]),
                                 jnp.asarray(state["z"]),
                                 jnp.asarray(state["w"]),
                                 jnp.asarray(state["xdat"]))
    out = step(ys, z, w, xd, jnp.asarray(state["M"]),
               jnp.asarray(state["Minv"]),
               jnp.asarray(state["scl"], jnp.float32),
               jnp.asarray(state["tau"], jnp.float32),
               jnp.asarray(state["lam"], jnp.float32),
               jnp.float32(state["rho"]))
    return [np.asarray(v) for v in out]


def test_mesh_and_obj_agree_across_ranks(problem):
    coords = sorted(tuple(o[0]["coords"]) for o in problem["ranks"])
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(o[0]["shape"] == {"batch": 2, "channel": 2}
               for o in problem["ranks"])
    for o in problem["main"]["objs"]:
        np.testing.assert_array_equal(o, problem["main"]["obj"])


@pytest.mark.parametrize("key", ["ys", "z", "w", "obj"])
def test_sharded_step_matches_jax(problem, key):
    if problem["jax"] is None:
        pytest.skip(f"needs {WORLD} JAX devices")
    want = dict(zip(("ys", "z", "w", "obj"), problem["jax"]))[key]
    got = problem["main"][key]
    if key == "obj":
        np.testing.assert_allclose(got, want, rtol=2e-3)
        return
    atol = 2e-3 * np.abs(want).max() if key == "ys" else 1e-3
    assert np.abs(got - want).max() <= atol


@pytest.fixture(scope="module")
def unsharded(problem):
    """The port's unsharded make_admm_step, subject by subject."""
    st = problem["state"]
    sett = _settings(unires_torch, 8, 1e-9)
    sett.device = "cpu"
    x = [[types.SimpleNamespace(po=problem["pos"][n], tau=float(TAUS[n]),
                                ct=False) for n in range(R)]
         for _ in range(C)]
    y = [types.SimpleNamespace(dat=None, dim=DIM_Y, mat=np.eye(4), lam=LAM,
                               lam0=LAM) for _ in range(C)]
    ref = t_make_admm_step(x, y, sett)
    out = []
    for b in range(B):
        ys, z, w, _, obj = ref(
            torch.from_numpy(st["ys"][b]), torch.from_numpy(st["z"][b]),
            torch.from_numpy(st["w"][b]),
            [[torch.from_numpy(st["xdat"][n, b, c]) for n in range(R)]
             for c in range(C)],
            [[st["M"][n] for n in range(R)]] * C,
            [[st["Minv"][n] for n in range(R)]] * C,
            [[0.0] * R] * C, [[float(t) for t in TAUS]] * C, [LAM] * C, RHO)
        out.append((ys.numpy(), z.numpy(), w.numpy(), obj.numpy()))
    return out


@pytest.mark.parametrize("b", range(B))
def test_sharded_step_matches_unsharded_subject(problem, unsharded, b):
    ys, z, w, _ = unsharded[b]
    got = problem["main"]
    assert np.abs(got["ys"][b] - ys).max() <= 2e-3 * np.abs(ys).max()
    assert np.abs(got["z"][b] - z).max() <= 1e-3
    assert np.abs(got["w"][b] - w).max() <= 1e-3


def test_sharded_objective_is_the_batch_total(problem, unsharded):
    total = np.sum([u[3] for u in unsharded], axis=0)
    np.testing.assert_allclose(problem["main"]["obj"], total, rtol=2e-3)


def test_single_repeat_operands(problem):
    """Operands without the leading repeat axis (tests/test_sharding.py:
    102-129): finite, of the right shape, the state moved."""
    got = problem["single"]
    assert got["ys"].shape == (B1, C1) + DIM_Y1
    assert all(np.isfinite(got[k]).all() for k in ("ys", "z", "w", "obj"))
    assert np.abs(got["ys"] - problem["state1"]["ys"]).max() > 0


def test_dryrun_multichip_on_four_cpu_ranks():
    dryrun.dryrun_multichip(WORLD, device="cpu")
