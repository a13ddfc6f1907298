"""The main path's fit of a checkout of this repository, for comparing two
commits digit for digit on one card.

    python3 scripts/cuda_fit_trace.py [--tree PATH] [--label NAME] --out F
    python3 scripts/cuda_fit_trace.py --compare A.npz B.npz

Loads ``--tree``'s own ``chip_smoke.py`` (default: this checkout), which
binds that tree's ``unires_torch``, and runs the misaligned ``bench.py``
workload of its phase 5 (``_bench_init``: co-registration, unified rigid
and scaling, seed 0) and 8 captured iterations from that init
(``_fit_copy``). Writes the objective trace, the poses, the scales and the
channels' volumes to ``--out`` (npz) and prints the trace, the fit's
seconds, the warm-up + capture seconds and the graph's nodes. Run it for
the parent and the change in one chip call (each in its own process), then
``--compare`` the two files: equal digit for digit or not, and the largest
differences.
"""
import argparse
import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def compare(a, b):
    fa, fb = np.load(a), np.load(b)
    for k in fa.files:
        va, vb = fa[k], fb[k]
        same = va.shape == vb.shape and np.array_equal(va, vb)
        diff = (float(np.abs(va - vb).max()) if va.shape == vb.shape
                else float("nan"))
        print(f"[trace compare] {k} {va.shape}: equal digit for digit "
              f"{same} | max |a - b| {diff:.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(HERE))
    ap.add_argument("--label", default="this")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # binds the tree's unires_torch

    import torch

    smi = cs.phase_device()
    init = cs._bench_init("cuda", cs.DIM_Y, 8)
    cap = {}
    fn = cs.fitloop.FitChunk._capture

    def timed(self, *a):  # the tree's warm-up and capture, and its nodes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(self, *a)
        torch.cuda.synchronize()
        cap.update(s=time.perf_counter() - t0, nodes=self.graph.nodes)

    cs.fitloop.FitChunk._capture = timed
    x, y, _, obj, n_iter, secs = cs._fit_copy(init)
    cs.fitloop.FitChunk._capture = fn
    print(f"[trace {args.label}] {smi} | {n_iter} iterations {secs:.3f} s, "
          f"warm-up + capture {cap['s']:.3f} s, graph nodes {cap['nodes']},"
          f" {(secs - cap['s']) / n_iter:.4f} s/iter without")
    print(f"[trace {args.label}] nll {obj[:, 0].tolist()}")
    np.savez(args.out, obj=np.asarray(obj), q=cs._poses(x),
             scl=np.array([o.po.scl for xc in x for o in xc]),
             y=np.stack([c.dat.cpu().numpy() for c in y]))
    torch.cuda.synchronize()


if __name__ == "__main__":
    main()
