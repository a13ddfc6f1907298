"""The port's converged bench.py workload on one card against the JAX
package's float32 run on the CPU, and the port's own float32 spread.

    python3 scripts/cuda_bench_vs_jax.py [--reps 3] [--eps 1e-6]
        [--seed0 1000] [--out build/bench_vs_jax.json]

Builds ``chip_smoke.py`` phase 9's workload (the misaligned 3-channel brain
phantom of bench.py, seed 0) and runs ``unires_torch.init`` + ``fit`` to
tolerance 1e-4 once as built, then ``--reps`` times with every observation
multiplied by (1 + eps N(0, 1)), run r seeded by seed0 + r: a perturbation
of a few float32 roundings, the one ``scripts/jax_bench_reference.py --eps
1e-6 --seed`` draws for the JAX package. For each run it prints the lambda
schedule's steps and the differences from
``unires_torch/data/jax_bench_reference.json`` that ``chip_smoke.py``
phases 5 and 9 hold to ``chip_smoke.JAX_TOL``, as ``chip_smoke.jax_diffs``
computes them. Then the spread of the runs against each tolerance, from
which ``JAX_TOL`` is set, and of n_iter, PSNR and sr_vs_trilinear. Writes
every run's figures to ``--out``.

``--summarise NAME=FILE[,FILE...] ...`` needs no card: it prints the same
spread for each named group of earlier ``--out`` files and
``scripts/jax_bench_reference.py`` outputs (the runs outside ``JAX_TOL``
apart), and compares the groups' n_iter (Mann-Whitney; Wilcoxon paired in
order where two groups are as long).
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import unires_torch  # noqa: E402
from unires_torch.pipeline.fit import fit as fit_solver  # noqa: E402


def run_once(chans, gt, device):
    inputs = [cs._moments(c[0]) for c in chans]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y, sett = unires_torch.init(chans, unires_torch.Settings(
        device=device, vx=1.0, do_print=0, write_out=False, tolerance=1e-4,
        sched_num=3, reg_scl=4.0, do_coreg=True, unified_rigid=True,
        scaling=True))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    tri = y[0].dat.clone()
    t0 = time.perf_counter()
    y, _, _, obj, n_iter = fit_solver(x, y, sett)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    fig = cs._figures(inputs, x, y, sett, obj, n_iter, gt, tri, device)
    fig.update(steps=cs._sched_steps(fig["nll"]),
               seconds=dict(init=t_init, fit=t_fit))
    return fig


def _jax_run(path):
    """A ``scripts/jax_bench_reference.py`` output as a run of this script."""
    with open(path) as f:
        d = json.load(f)
    fig = cs._jax_figures(d)
    fig["steps"] = cs._sched_steps(d["nll"])
    return dict(eps=d["perturbation"]["eps"], figures=fig,
                vs_jax=cs.jax_diffs(fig, converged=True))


def _runs(paths):
    """The runs of ``--out`` files (the as-built run once) or of the JAX
    script's outputs, in the order given."""
    runs = []
    for path in paths:
        with open(path) as f:
            d = json.load(f)
        new = d["runs"] if "runs" in d else [_jax_run(path)]
        runs += [r for r in new
                 if r["eps"] or all(q["eps"] for q in runs)]
    return runs


def _outside(r):
    return any(abs(v) > cs.JAX_TOL[k] for k, v in r["vs_jax"].items())


def spread(name, runs):
    """Print the runs' differences from the reference against JAX_TOL, and
    n_iter, the first lambda step, PSNR and the ratio across the runs."""
    within = [r for r in runs if not _outside(r)]
    top = {k: max([abs(r["vs_jax"][k]) for r in within], default=0.0)
           for k in cs.JAX_TOL}
    print(f"[spread] {name}: {len(runs)} runs, {len(runs) - len(within)} "
          f"outside JAX_TOL; largest |difference| of the rest (tol): "
          + ", ".join(f"{k} {top[k]:.3e} ({tol:g})"
                      for k, tol in cs.JAX_TOL.items()))
    n = np.array([r["figures"]["n_iter"] for r in runs], np.float64)
    first = [r["figures"]["steps"][0] for r in runs]
    print(f"[spread] {name}: n_iter mean {n.mean():.2f} median "
          f"{np.median(n):g} sd {n.std(ddof=1) if len(n) > 1 else 0.0:.2f} "
          f"range {n.min():g}-{n.max():g} | first lambda step mean "
          f"{np.mean(first):.2f}")
    for k in ("psnr", "sr_vs_trilinear"):
        v = [float(r["figures"][k]) for r in runs]
        print(f"[spread] {name}: {k} mean {np.mean(v):.6g} range "
              f"{min(v):.6g}-{max(v):.6g}")
    for r in runs:
        if _outside(r):
            print(f"[spread] {name}: outside JAX_TOL: " + ", ".join(
                f"{k} {v:+.3e}" for k, v in r["vs_jax"].items()))


def summarise(groups):
    """``groups``: NAME=FILE[,FILE...] each. The spread of each group, then
    n_iter of each pair of groups: Mann-Whitney, and Wilcoxon with the runs
    paired in order where the groups are as long."""
    from scipy import stats

    runs = {}
    for g in groups:
        name, files = g.split("=", 1)
        runs[name] = _runs(files.split(","))
        spread(name, runs[name])
    names = list(runs)
    for a in range(len(names)):
        for b in range(a + 1, len(names)):
            x, y = ([r["figures"]["n_iter"] for r in runs[k]]
                    for k in (names[a], names[b]))
            line = (f"[n_iter] {names[a]} against {names[b]}: mean "
                    f"{np.mean(y) - np.mean(x):+.2f}, Mann-Whitney p "
                    f"{stats.mannwhitneyu(x, y).pvalue:.3f}")
            if len(x) == len(y):
                line += (f", paired Wilcoxon p "
                         f"{stats.wilcoxon(x, y).pvalue:.3f}")
            print(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--out", default=os.path.join(HERE, "build",
                                                  "bench_vs_jax.json"))
    ap.add_argument("--summarise", nargs="+", metavar="NAME=FILES",
                    help="no card: summarise earlier --out files and JAX "
                    "outputs, comma-separated, per named group")
    args = ap.parse_args()
    if args.summarise:
        summarise(args.summarise)
        return
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[card] {smi}", flush=True)
    ref = cs._jax_reference()
    gts, _, chans = cs._bench_workload("cuda", cs.DIM_Y, misaligned=True)
    runs = []
    for r in range(args.reps + 1):
        eps = 0.0 if r == 0 else args.eps
        rng = np.random.default_rng(args.seed0 + r)
        ch = [[(c[0] * (1.0 + eps * rng.standard_normal(c[0].shape))
                ).astype(np.float32), c[1]] for c in chans]
        fig = run_once(ch, gts[0], "cuda")
        d = cs.jax_diffs(fig, converged=True)
        runs.append(dict(eps=eps, seed=args.seed0 + r, figures=fig,
                         vs_jax=d))
        print(f"[run {r}] eps {eps:g} | n_iter {fig['n_iter']} steps "
              f"{fig['steps']} psnr {fig['psnr']:.4f} ratio "
              f"{fig['sr_vs_trilinear']:.5f} | init "
              f"{fig['seconds']['init']:.2f} s fit "
              f"{fig['seconds']['fit']:.2f} s", flush=True)
        print(f"[run {r}] vs JAX: " + ", ".join(
            f"{k} {v:+.3e}" for k, v in d.items()), flush=True)
    spread("card", runs)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, jax=dict(n_iter=ref["n_iter"],
                                          psnr=ref["psnr"],
                                          ratio=ref["sr_vs_trilinear"]),
                       runs=runs), f,
                  default=lambda a: np.asarray(a).tolist())
    print(f"[out] {args.out}")


if __name__ == "__main__":
    main()
