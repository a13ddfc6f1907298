"""Leveled console logging (reference: unires/_util.py:10-131 _print_info).

A copy of ``unires_tpu.utils.log`` that names the torch device.

Keeps the reference's per-iteration 'fit-ll' line format for comparability
(SURVEY §5), four verbosity levels (0-3), and wall-clock timers.
"""
from __future__ import annotations

from datetime import datetime
from timeit import default_timer as timer

import numpy as np

TITLE = "\nUniRes | unified super-resolution and denoising (PyTorch)\n"


def info(sett, kind: str, *args):
    """Print one progress message; returns a timestamp for duration pairing."""
    lvl = int(getattr(sett, "do_print", 1) or 0)
    if lvl <= 0:
        return timer()
    if lvl >= 1:
        if kind == "init":
            import torch

            print(TITLE)
            dev = torch.device(sett.device)
            name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                    else "cpu")
            print(f"{datetime.now():%d/%m/%Y %H:%M:%S} | device: {name} "
                  f"({dev.type}) | torch {torch.__version__}")
        elif kind == "fit-start":
            C, N = args
            print(f"\nStarting {sett.method} (update_rigid={sett.unified_rigid}, "
                  f"update_scaling={sett.scaling}) \n | C={C} | N={N} | "
                  f"max_iter={sett.max_iter} | tol={sett.tolerance} | "
                  f"sched_num={sett.sched_num}")
        elif kind == "fit-ll":
            n_iter, obj, gain, t_prev = args
            nit = len(str(sett.max_iter))
            print(f"{n_iter:{nit}d} - Convergence ({timer() - t_prev:4.1f} s)  | "
                  f"nlyx = {obj[0]:10.4g}, nlxy = {obj[1]:10.4g}, "
                  f"nly = {obj[2]:10.4g}, gain = {gain:10.7f}")
        elif kind == "fit-finish":
            t0, n_iter = args
            print(f" {sett.method} finished in {timer() - t0:0.5f} seconds and "
                  f"{n_iter + 1} iterations\n")
        elif kind == "step-size":
            rho, = args
            print(f"\nADMM step-size={rho:0.4f} | Regularisation scaling={list(np.round(np.asarray(sett.reg_scl, dtype=float), 4))}")
        elif kind == "hyper-start":
            print("\nEstimating model hyper-parameters... ", end="", flush=True)
        elif kind == "hyper-done":
            x, t0 = args
            print(f"completed in {timer() - t0:0.5f} seconds:")
            for c in range(len(x)):
                taus = " ".join(f"{o.tau:10.4g}" for o in x[c])
                sds = " ".join(f"{o.sd:10.4g}" for o in x[c])
                mus = " ".join(f"{o.mu:10.4g}" for o in x[c])
                cts = " ".join(str(o.ct) for o in x[c])
                print(f"c={c} | tau={taus} | sd={sds} | mu={mus} | ct={cts}")
        elif kind == "mean-space":
            dim, mat = args
            from ..geometry import voxel_size

            vx = tuple(float(f"{v:4.2f}") for v in voxel_size(mat))
            print(f"\nMean space | dim={tuple(dim)}, vx={vx}")
        elif kind == "filenames":
            x, = args
            print("\nInput")
            for c in range(len(x)):
                for n in range(len(x[c])):
                    print(f"c={c}, n={n} | fname={x[c][n].fname}")
        elif kind == "init-reg-begin":
            what, N = args
            lbl = "atlas " if what == "atlas" else f"multi-channel (N={N}) "
            print(f"\nPerforming {lbl}alignment...", end="", flush=True)
        elif kind == "init-reg-done":
            t0, = args
            print(f"completed in {timer() - t0:0.5f} seconds.")
        elif kind == "reg-change":
            oreg, nreg = args
            print(f"OBS: Regularisation changed from {oreg:.2E} to {nreg:.2E}")
        elif kind == "fix-affine":
            cnt, = args
            if cnt > 0:
                print(f"\nFixed affine of {cnt} CT image(s).")
        elif kind == "saved":
            fname, = args
            print(f"Output saved to: {fname}")
    if lvl >= 2:
        if kind == "reg-param":
            x, = args
            print("Rigid registration fit:")
            for c in range(len(x)):
                for n in range(len(x[c])):
                    q = np.round(np.asarray(x[c][n].rigid_q, float), 4).tolist()
                    print(f"c={c} n={n} | q={q}")
        elif kind == "scl-param":
            x, = args
            print("Scale fit:")
            for c in range(len(x)):
                for n in range(len(x[c])):
                    print(f"c={c} n={n} | exp(s)={np.exp(x[c][n].po.scl):.4f}")
    if lvl >= 3:
        if kind == "fit-done":
            t0, = args
            print(f"(completed in {timer() - t0:0.5f} seconds)")
        elif kind == "fit-update":
            which, n_iter = args
            print(f"{n_iter + 1:3d} - Updating {which:2} | ", end="")
    return timer()
