"""Multi-channel super-resolution demo of the PyTorch port (the counterpart
of demos/demo_multi_channel.py; reference demo_multi_channel.ipynb).

Three contrasts of the same anatomy, each acquired with 4 mm slices along a
DIFFERENT axis, with rigid misalignment and even/odd scaling: the full
pipeline (NMI coreg, data-driven hyper-parameters, joint-TV ADMM with
unified rigid + scaling updates) reconstructs all channels on a common 1 mm
grid. The synthetic brain phantom by default (``--dim`` cuts it: a CPU run
wants a small one); pass three NIfTI paths for real data.

Run:  python demos/torch_demo_multi_channel.py [--device cuda|cpu]
          [--dim 181 217 181] [--max_iter N] [t1.nii t2.nii pd.nii]
"""
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

sys.path.insert(0, ".")


def _centre_crop(vol, dim):
    lo = [(n - d) // 2 for n, d in zip(vol.shape, dim)]
    return np.ascontiguousarray(
        vol[tuple(slice(a, a + d) for a, d in zip(lo, dim))])


def main():
    from unires_torch import Settings, init, proj_apply, proj_info
    from unires_torch.geometry import affine_diag, affine_matrix_classic
    from unires_torch.pipeline.fit import fit as fit_solver
    from unires_torch.pipeline.run import get_device

    ap = ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", help="three NIfTI ground truths")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dim", type=int, nargs=3, default=(181, 217, 181))
    ap.add_argument("--max_iter", type=int, default=512)
    args = ap.parse_args()
    device = get_device(Settings(device=args.device))
    rng = np.random.default_rng(0)

    if len(args.paths) == 3:
        from unires_torch.pipeline.nifti import load

        gts = []
        for p in args.paths:
            g, hdr = load(p)
            gts.append((np.asarray(g, np.float32), hdr.affine))
    elif args.paths:
        ap.error("give three NIfTI paths, or none for the phantom")
    else:
        from unires_torch.utils.phantoms import brain_phantom

        # three contrasts of the same anatomy
        gts = [(_centre_crop(brain_phantom(contrast=c, amplitude=a), args.dim),
                np.eye(4))
               for c, a in (("t1", 4000.0), ("t2", 3000.0), ("pd", 2000.0))]

    chans = []
    for c, (gt, mat_gt) in enumerate(gts):
        ax = [2, 1, 0][c % 3]  # rotate the thick axis per channel
        vx = [1.0, 1.0, 1.0]
        vx[ax] = 4.0
        mat_x = mat_gt @ affine_diag(vx)
        dim_x = list(gt.shape)
        dim_x[ax] = int(np.ceil(gt.shape[ax] / 4.0))
        rp = (rng.uniform(-3, 3, 3).tolist()
              + rng.uniform(-0.03, 0.03, 3).tolist())
        po = proj_info(gt.shape, mat_gt, tuple(dim_x), mat_x,
                       rigid=affine_matrix_classic(rp), prof_ip=2, prof_tp=0,
                       scl=0.05)
        x = proj_apply("A", torch.from_numpy(gt).to(device), po,
                       "super-resolution").cpu().numpy()
        sd = 0.02 * float(np.max(gt))
        x = x + sd * rng.standard_normal(x.shape).astype(np.float32)
        chans.append([x, mat_x])
        print(f"channel {c}: thick axis {ax}, obs {x.shape}, "
              f"noise sd {sd:.1f}")

    sett = Settings(device=str(device), vx=1.0, do_coreg=True, scaling=True,
                    unified_rigid=True, do_print=1, write_out=False,
                    tolerance=1e-4, sched_num=3, max_iter=args.max_iter)
    t0 = time.time()
    xs, ys, sett = init(chans, sett)
    print(f"init (incl. NMI coreg): {time.time() - t0:.1f}s")
    t0 = time.time()
    ys, R, jtv, obj, n_iter = fit_solver(xs, ys, sett)
    dt = time.time() - t0
    print(f"\nfit: {n_iter} iterations in {dt:.1f}s "
          f"({dt / max(n_iter, 1):.2f} s/iter)")

    # cross-channel consistency (reference reports MSE(y_i, y_j))
    for a in range(3):
        for b in range(a + 1, 3):
            mse = float(torch.mean((ys[a].dat - ys[b].dat) ** 2))
            print(f"MSE(y{a}, y{b}) = {mse:,.4g}")


if __name__ == "__main__":
    main()
