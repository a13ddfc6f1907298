"""Count the source visits of push's tiles at the fit's map, on the CPU.

    python3 scripts/push_tile_counts.py [--block 64 64 64]

The push kernel (``unires_torch/csrc/resample.cu``) gives a thread a tile
of TX (x) x TY (y) x TZ (z) targets and visits the union of their candidate
boxes once; a warp's 32 lanes are LX (x) x LY (y) x LZ (z) tiles and wait
for the lane with the most visits. For the fit case of ``chip_smoke.py``
(``fit_case``) this takes every target's box as ``push_reach`` and
``push_window`` give it, over a central block of the target grid, and
prints per tile and lane shape: the (source, target) pairs per target, the
union's sources per tile, and the slowest lane's visits per target (the
warp's loops over oa, ob and oc each run as many turns as its longest lane
needs on that axis: the product of the three maxima, averaged over the
warps and divided by the tile's targets). A tile of one
target with 8 (z) x 4 (y) lanes is the port's first gather. numpy only.
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from unires_torch.ops import resample as tr  # noqa: E402

# (tile TX, TY, TZ), (lanes LX, LY, LZ): the first gather, the first tile,
# the port's kernel
SHAPES = [((1, 1, 1), (1, 4, 8)), ((1, 2, 4), (1, 8, 4)),
          ((1, 2, 4), (4, 4, 2))]


def boxes(block):
    """Per axis, the candidate range [lo, hi] of every target of the central
    ``block`` of the fit case's target grid (float32, as the kernel)."""
    po, M, Minv = cs.fit_case()
    M, Minv = tr._as_map(M), tr._as_map(Minv).astype(np.float32)
    src, tgt = tuple(po.dim_yx), cs.DIM_Y
    reach = tr.push_reach(M, Minv, 1, src, tgt)
    w = tr.push_window(M)
    v = np.meshgrid(*[np.arange((n - s) // 2, (n - s) // 2 + s,
                                dtype=np.float32)
                      for n, s in zip(tgt, block)], indexing="ij")
    lo, hi = [], []
    for d in range(3):
        c = (Minv[d, 0] * v[0] + Minv[d, 1] * v[1]) + Minv[d, 2] * v[2] \
            + Minv[d, 3]
        anc = np.floor(c + 0.5)
        lo.append(np.maximum(np.maximum(np.ceil(c - reach[d]), anc - w[d]),
                             0).astype(np.int64))
        hi.append(np.minimum(np.minimum(np.floor(c + reach[d]), anc + w[d]),
                             src[d] - 1).astype(np.int64))
    return lo, hi


def counts(lo, hi, tile, lanes):
    """(pairs per target, union's sources per tile, slowest lane's visits
    per target) for whole warps of the block."""
    (TX, TY, TZ), (LX, LY, LZ) = tile, lanes
    pairs = np.prod([hi[d] - lo[d] + 1 for d in range(3)], axis=0).mean()

    def per_tile(a, f):
        x, y, z = (n - n % (t * ln) for n, t, ln in zip(a.shape, tile, lanes))
        a = a[:x, :y, :z].reshape(x // TX, TX, y // TY, TY, z // TZ, TZ)
        return f(f(f(a, axis=5), axis=3), axis=1)

    extent = [per_tile(hi[d], np.max) - per_tile(lo[d], np.min) + 1
              for d in range(3)]
    x, y, z = extent[0].shape
    turns = np.prod([e.reshape(x // LX, LX, y // LY, LY, z // LZ, LZ)
                     .max(axis=(1, 3, 5)) for e in extent], axis=0)
    return (pairs, np.prod(extent, axis=0).mean(),
            turns.mean() / (TX * TY * TZ))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--block", type=int, nargs=3, default=(64, 64, 64),
                    help="central targets counted (x, y, z)")
    args = ap.parse_args()
    lo, hi = boxes(tuple(args.block))
    for tile, lanes in SHAPES:
        pairs, union, slow = counts(lo, hi, tile, lanes)
        print(f"tile {'x'.join(map(str, tile))} lanes "
              f"{'x'.join(map(str, lanes))} (x, y, z): pairs per target "
              f"{pairs:.2f}, union {union:.1f} sources per tile, slowest "
              f"lane {slow:.2f} visits per target")


if __name__ == "__main__":
    main()
