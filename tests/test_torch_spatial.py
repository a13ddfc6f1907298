"""unires_torch.parallel.spatial on 4 gloo ranks against the JAX package.

The 64-row volumes of tests/test_spatial.py cut into 4 slabs of 16 rows, on
both sides (the JAX slab step on 4 of the 8 virtual CPU devices): the halo
stencils against the unsharded ones (atol 1e-6); one denoising step and one
super-resolution step with the thick axis on the slab axis (0) and off it
(2), each against the port's unsharded ``make_admm_step`` at that file's
tolerances (ys 5e-3 of its scale, z and w 2e-2, the objective rtol 1e-2:
the slab-local preconditioner stops CG at other iterates than the global
one) and against the JAX slab step, which runs the same preconditioner, stop
rule and slabs, far tighter (ys 1e-5 of its scale, z and w 2e-4, the
objective rtol 1e-5: about 10 times the largest gap read on these inputs,
1.1e-6, 1.7e-5 and 5.8e-7); the slab preconditioner cutting the CG steps. The ranks are spawned once for the file and import only
unires_torch.
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
from unires_torch.ops.finite_diff import im_divergence, im_gradient
from unires_torch.parallel import dryrun
from unires_torch.parallel.launch import run_cases, spawn
from unires_torch.solvers.admm import make_admm_step as t_make_admm_step
from unires_tpu.geometry import affine_diag, affine_matrix_classic
from unires_tpu.models.proj_op import proj_info as j_proj_info
from unires_tpu.parallel import spatial as jsp

torch.set_num_threads(2)

WORLD = 4
DIM = (64, 12, 13)
VX = (1.0, 1.3, 0.8)
WHICH = ["forward", "backward", "central"]
TAU, LAM, RHO = [0.7, 1.1], [0.2, 0.15], 1.1
KINDS = ["denoising", "sr_thick0", "sr_thick2"]


def _case(kind, pkg_proj_info):
    """(po, sett arguments) of a step of ``kind``, as tests/test_spatial.py
    builds them."""
    if kind == "denoising":
        po = pkg_proj_info(DIM, np.eye(4), DIM, np.eye(4),
                           rigid=affine_matrix_classic([0.8, -0.5, 0.3]))
        return po, dict(cgs_max_iter=40, cgs_tol=1e-6, vx=0.0)
    thick = int(kind[-1])
    dim_x, vx = list(DIM), [1.0, 1.0, 1.0]
    dim_x[thick] = DIM[thick] // 4 if thick == 0 else 4
    vx[thick] = 4.0
    po = pkg_proj_info(DIM, np.eye(4), tuple(dim_x), affine_diag(vx),
                       rigid=affine_matrix_classic(
                           [0.8, -0.5, 0.3, 0.004, -0.003, 0.005]),
                       prof_ip=2, prof_tp=0, scl=0.07)
    return po, dict(cgs_max_iter=60, cgs_tol=1e-6, vx=1.0)


def _method(kind):
    return "denoising" if kind == "denoising" else "super-resolution"


def _settings(pkg, kind, kw):
    sett = pkg.Settings(do_print=0, **kw)
    sett.method, sett.do_proj = _method(kind), True
    return sett


def _state(kind, po):
    rng = np.random.default_rng(1 if kind == "denoising" else 2)
    gt = rng.random((2,) + DIM, dtype=np.float32) * 100
    method = _method(kind)
    M, Minv = t_obs_dyn_args(po, method)
    A = t_make_obs_ops(po, method)[0]
    scl = [0.0, 0.0] if kind == "denoising" else [0.07, -0.04]
    xdat = np.stack([A(torch.from_numpy(gt[c]), M, Minv, scl[c]).numpy()
                     for c in range(2)])
    return dict(ys=gt * 0.6, z=np.zeros((2, 3) + DIM, np.float32),
                w=0.03 * np.ones((2, 3) + DIM, np.float32), xdat=xdat, M=M,
                Minv=Minv, scl=scl, tau=TAU, lam=LAM, rho=RHO)


def _jax_step(kind, st):
    """The JAX package's slab step on 4 virtual devices."""
    po, kw = _case(kind, j_proj_info)
    mesh = jsp.build_spatial_mesh(WORLD)
    sett = _settings(unires_tpu, kind, kw)
    f32 = lambda v: jnp.asarray(v, jnp.float32)  # noqa: E731
    state = jsp.shard_spatial(mesh, *(f32(st[k]) for k in ("ys", "z", "w",
                                                           "xdat")))
    if kind == "denoising":
        step = jsp.make_spatial_admm_step(po, sett, mesh)
        args = (f32(st["tau"]), f32(st["lam"]), jnp.float32(RHO))
    else:
        step = jsp.make_spatial_admm_step_sr(po, sett, mesh)
        args = (f32(st["scl"]), f32(st["tau"]), f32(st["lam"]),
                jnp.float32(RHO))
    out = step(*state, f32(st["M"]), f32(st["Minv"]), *args)
    return [np.asarray(v) for v in out]


@pytest.fixture(scope="module")
def ranks():
    """Every case of the file on one group of 4 ranks, and its inputs; the
    JAX slab steps run here while the ranks do."""
    rng = np.random.default_rng(0)
    vol = rng.random(DIM, dtype=np.float32)
    p = rng.random((3,) + DIM, dtype=np.float32)
    rhs = np.random.default_rng(3).random(DIM, dtype=np.float32)
    cases = [(dryrun.halo_stencils_rank, dict(vol=vol, p=p, vx=VX, which=w))
             for w in WHICH]
    inputs = {}
    for kind in KINDS:
        po, kw = _case(kind, t_proj_info)
        inputs[kind] = (po, kw, _state(kind, po))
        cases.append((dryrun.spatial_step_rank, dict(
            kind=_method(kind), po=po, sett=_settings(unires_torch, kind, kw),
            **inputs[kind][2])))
    cases.append((dryrun.slab_pcg_rank, dict(
        rhs=rhs, vx=(1.0, 1.0, 1.0), tau=1.0, lam=0.4, rho=1.2, max_iter=60,
        tol=1e-6)))
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(spawn, run_cases, WORLD, "gloo", cases)
        jax_out = ({kind: _jax_step(kind, inputs[kind][2]) for kind in KINDS}
                   if len(jax.devices()) >= WORLD else None)
        outs = job.result()
    # the slabs in rank order along the sharded axis
    res = [[o[i] for o in outs] for i in range(len(cases))]
    stencils = {w: dict(grad=np.concatenate([r["grad"] for r in res[i]], 1),
                        div=np.concatenate([r["div"] for r in res[i]], 0))
                for i, w in enumerate(WHICH)}
    steps = {}
    for i, kind in enumerate(KINDS, start=len(WHICH)):
        steps[kind] = dict(ys=np.concatenate([r["ys"] for r in res[i]], 1),
                           z=np.concatenate([r["z"] for r in res[i]], 2),
                           w=np.concatenate([r["w"] for r in res[i]], 2),
                           obj=res[i][0]["obj"],
                           objs=[r["obj"] for r in res[i]])
    return dict(vol=vol, p=p, rhs=rhs, stencils=stencils, steps=steps,
                inputs=inputs, pcg=res[-1], jax=jax_out)


@pytest.mark.parametrize("which", WHICH)
def test_halo_stencils_match_unsharded(ranks, which):
    got = ranks["stencils"][which]
    want_g = im_gradient(torch.from_numpy(ranks["vol"]), VX, which).numpy()
    want_d = im_divergence(torch.from_numpy(ranks["p"]), VX, which).numpy()
    np.testing.assert_allclose(got["grad"], want_g, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["div"], want_d, rtol=0, atol=1e-6)


# (ys of its scale, z and w absolute, objective relative)
UNSHARDED_TOL = dict(ys=5e-3, zw=2e-2, obj=1e-2)
JAX_TOL = dict(ys=1e-5, zw=2e-4, obj=1e-5)


def _assert_step(got, want, tol):
    ys, z, w, obj = want
    scale = np.abs(ys).max()
    assert np.abs(got["ys"] - ys).max() <= tol["ys"] * scale, \
        np.abs(got["ys"] - ys).max() / scale
    assert np.abs(got["z"] - z).max() <= tol["zw"]
    assert np.abs(got["w"] - w).max() <= tol["zw"]
    np.testing.assert_allclose(got["obj"], obj, rtol=tol["obj"])


@pytest.mark.parametrize("kind", KINDS)
def test_slab_step_matches_unsharded(ranks, kind):
    po, kw, st = ranks["inputs"][kind]
    sett = _settings(unires_torch, kind, kw)
    sett.device = "cpu"
    x = [[types.SimpleNamespace(po=po, tau=TAU[c], ct=False)]
         for c in range(2)]
    y = [types.SimpleNamespace(dat=None, dim=DIM, mat=np.eye(4), lam=LAM[c],
                               lam0=LAM[c]) for c in range(2)]
    ys, z, w, _, obj = t_make_admm_step(x, y, sett)(
        torch.from_numpy(st["ys"]), torch.from_numpy(st["z"]),
        torch.from_numpy(st["w"]),
        [[torch.from_numpy(st["xdat"][c])] for c in range(2)],
        [[st["M"]]] * 2, [[st["Minv"]]] * 2, [[s] for s in st["scl"]],
        [[t] for t in TAU], LAM, RHO)
    got = ranks["steps"][kind]
    for o in got["objs"]:
        np.testing.assert_array_equal(o, got["obj"])
    _assert_step(got, (ys.numpy(), z.numpy(), w.numpy(), obj.numpy()),
                 UNSHARDED_TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_slab_step_matches_jax(ranks, kind):
    if ranks["jax"] is None:
        pytest.skip(f"needs {WORLD} JAX devices")
    _assert_step(ranks["steps"][kind], ranks["jax"][kind], JAX_TOL)


def test_slab_precond_cuts_cg_iterations(ranks):
    """The slab-local DCT preconditioner converges the slab y-solve in
    fewer steps than plain CG, to the same solution."""
    x_pcg = np.concatenate([r["pcg"][0] for r in ranks["pcg"]], 0)
    x_cg = np.concatenate([r["cg"][0] for r in ranks["pcg"]], 0)
    it_pcg = {r["pcg"][1] for r in ranks["pcg"]}
    it_cg = {r["cg"][1] for r in ranks["pcg"]}
    assert len(it_pcg) == len(it_cg) == 1  # every rank stopped together
    it_pcg, it_cg = it_pcg.pop(), it_cg.pop()
    assert np.allclose(x_pcg, x_cg, atol=1e-4 * float(np.abs(x_cg).max()))
    assert it_pcg < it_cg, (it_pcg, it_cg)
    assert it_pcg <= max(3, it_cg // 2), (it_pcg, it_cg)
