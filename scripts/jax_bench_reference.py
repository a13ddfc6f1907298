"""The JAX package's own float32 run of bench.py's workload, on the CPU.

Builds the workload of bench.py:40-97 through the JAX API (the structured
brain phantom, three contrasts at 181x217x181, per-channel rigids projected
to zero Lie-mean, 4 mm thick axes [2, 1, 0], sigma = 75 noise, even/odd
scaling 0.1), runs ``init`` (coreg on) and ``fit`` (unified rigid + scaling,
tolerance 1e-4, sched_num 3, reg_scl 4) and writes the figures the port is
held against to a JSON file:

* each input's sum and sum of squares (``chip_smoke.py`` phase 5 holds the
  port's inputs to them, so the reference is known to be of the same
  workload);
* after init: each channel's ``tau``, the coreg matrices, the recon grid's
  dim and mat, ``mse_trilinear``;
* the objective trace ``obj[:, 0]`` (``nll``; its first 8 values are what
  the 8-iteration comparison reads);
* ``n_iter``, PSNR, ``sr_vs_trilinear``, ``mse_sr``, each channel's final
  ``rigid_q`` and ``scl``.

Run it on the CPU, never on an accelerator (it is the float32 reference):

    JAX_PLATFORMS=cpu python scripts/jax_bench_reference.py
    JAX_PLATFORMS=cpu python scripts/jax_bench_reference.py --max-iter 8 \
        --out build/jax_bench_reference_8.json

The converged run takes about 19 min on 8 CPU cores (init about 3.5 min,
then some 9 s per iteration); ``--max-iter 8`` about 6 min. ``--eps E``
multiplies every observation by (1 + E N(0, 1)) (seeded by ``--seed``)
before ``init``: a perturbation of a few float32 roundings, which measures
the JAX package's own float32 spread (write it elsewhere with ``--out``).
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(ROOT, "unires_torch", "data",
                           "jax_bench_reference.json")
DIM_Y = (181, 217, 181)
THICK_AXES = (2, 1, 0)


def _moments(a):
    a = np.asarray(a, np.float64)
    return [float(a.sum()), float((a * a).sum())]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max-iter", type=int, default=None,
                    help="cap the fit's iterations (default: Settings' own)")
    ap.add_argument("--out", default=DEFAULT_OUT, help="JSON file to write")
    ap.add_argument("--eps", type=float, default=0.0,
                    help="relative perturbation of the observations")
    ap.add_argument("--seed", type=int, default=1000,
                    help="seed of the perturbation")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from tests.phantoms import brain_phantom
    from unires_tpu import Settings, init
    from unires_tpu.geometry import (affine_basis, affine_diag,
                                     affine_matrix_classic, expm, rigid_log)
    from unires_tpu.models.forward import proj_apply
    from unires_tpu.models.proj_op import proj_info
    from unires_tpu.ops.resample import affine_to_M, pull
    from unires_tpu.pipeline.fit import fit

    t_all = time.time()
    rng = np.random.default_rng(0)
    gts = [brain_phantom(dim=DIM_Y, contrast=c, amplitude=2000.0, seed=0)
           for c in ("t1", "t2", "pd")]
    basis = affine_basis("SE")
    rps = [rng.uniform(-2, 2, 3).tolist() + rng.uniform(-0.02, 0.02, 3).tolist()
           for _ in range(3)]
    logs = [rigid_log(affine_matrix_classic(rp), basis) for rp in rps]
    qm = np.mean(logs, axis=0)
    rigids = [expm(lg - qm, basis) for lg in logs]
    chans = []
    for c, ax in enumerate(THICK_AXES):
        vx = [1.0, 1.0, 1.0]
        vx[ax] = 4.0
        mat_x = affine_diag(vx)
        dim_x = list(DIM_Y)
        dim_x[ax] = int(np.ceil(DIM_Y[ax] / 4.0))
        po = proj_info(DIM_Y, np.eye(4), tuple(dim_x), mat_x,
                       rigid=rigids[c], prof_ip=2, prof_tp=0, scl=0.1)
        x = np.asarray(proj_apply("A", jnp.asarray(gts[c]), po,
                                  "super-resolution"))
        x = x + 75.0 * rng.standard_normal(x.shape).astype(np.float32)
        chans.append([x.astype(np.float32), mat_x])
    if args.eps:
        prng = np.random.default_rng(args.seed)
        chans = [[(x * (1.0 + args.eps * prng.standard_normal(x.shape))
                   ).astype(np.float32), m] for x, m in chans]
    t_data = time.time() - t_all
    print(f"phantom + degradation {t_data:.1f} s", flush=True)

    kw = dict(vx=1.0, do_print=0, write_out=False, tolerance=1e-4,
              sched_num=3, reg_scl=4.0, do_coreg=True, unified_rigid=True,
              scaling=True)
    if args.max_iter is not None:
        kw["max_iter"] = args.max_iter
    sett = Settings(**kw)
    t0 = time.time()
    x, y, sett = init(chans, sett)
    t_init = time.time() - t0
    M = affine_to_M(np.linalg.solve(np.eye(4), y[0].mat))
    gt_on_y = np.asarray(pull(jnp.asarray(gts[0]), M, y[0].dim))
    msk = gt_on_y > 0
    tri = np.asarray(y[0].dat)
    mse_tri = float(np.mean((tri[msk] - gt_on_y[msk]) ** 2))
    print(f"init {t_init:.1f} s, mse_trilinear {mse_tri}", flush=True)

    t0 = time.time()
    y, _, _, obj, n_iter = fit(x, y, sett)
    t_fit = time.time() - t0
    rec = np.asarray(y[0].dat)
    mse = float(np.mean((rec[msk] - gt_on_y[msk]) ** 2))
    psnr = 10.0 * np.log10(float(gt_on_y.max()) ** 2 / max(mse, 1e-12))
    print(f"fit {t_fit:.1f} s, n_iter {n_iter}, psnr {psnr}, "
          f"sr_vs_trilinear {mse / mse_tri}", flush=True)

    obj = np.asarray(obj, np.float64)
    out = {
        "jax_version": jax.__version__,
        "numpy_version": np.__version__,
        "backend": jax.default_backend(),
        "command": "JAX_PLATFORMS=cpu python " + " ".join(
            [os.path.relpath(os.path.abspath(sys.argv[0]), ROOT)]
            + sys.argv[1:]),
        "workload": "bench.py:40-97 (brain phantom 181x217x181, seed 0)",
        "perturbation": {"eps": args.eps, "seed": args.seed},
        "settings": {k: v for k, v in kw.items() if k != "do_print"},
        "max_iter": int(sett.max_iter),
        "reg_scl": [float(v) for v in np.atleast_1d(sett.reg_scl)],
        "seconds": {"data": t_data, "init": t_init, "fit": t_fit},
        "inputs": [{"dim": list(map(int, ch[0].shape)),
                    "moments": _moments(ch[0])} for ch in chans],
        "init": {
            "tau": [float(o.tau) for xc in x for o in xc],
            "mat_coreg": np.asarray(sett.mat_coreg).tolist(),
            "dim": [int(d) for d in y[0].dim],
            "mat": np.asarray(y[0].mat).tolist(),
            "mse_trilinear": mse_tri,
        },
        "nll": obj[:, 0].tolist(),
        "n_iter": int(n_iter),
        "psnr": float(psnr),
        "sr_vs_trilinear": float(mse / mse_tri),
        "mse_sr": mse,
        "rigid_q": [np.asarray(o.rigid_q).tolist() for xc in x for o in xc],
        "scl": [float(o.po.scl) for xc in x for o in xc],
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out} in {time.time() - t_all:.1f} s", flush=True)


if __name__ == "__main__":
    main()
