// Trilinear / nearest pull, its exact adjoint (push) and its derivative with
// respect to the sample point (pull_grad) for Hopper (sm_90a).
//
// Semantics (the XLA oracles of unires_tpu/ops/resample.py state them plainly):
//   pull  out[o] = sum_corners w(o, v) * vol[v],  g(o) = M . (i, j, k, 1)
//         zero bound (out-of-range corners weigh 0); outputs whose sample
//         point lies outside [-0.5, n - 0.5]^3 (or the caller's fov bounds)
//         are exactly 0.
//   push  out[v] = sum_o w(o, v) * vals[o]        (push = pull^T)
//   pull_grad  out[o, d] = d pull(o) / d g_d(o)   (trilinear; same bound/FOV)
// M and Minv are (3,4) float32 maps that the kernels read from DEVICE memory
// (every thread loads the 12 floats once with __ldg; the address is uniform
// across the block, so the load is an L1 broadcast), so that a map may change
// between two replays of a captured CUDA graph: the CUDA counterpart of the
// Pallas kernels' scalar prefetch. Push reads its plan (M, Minv, the reach and
// the window) from one 32-float device buffer that ops/resample.py:push_plan
// computes on the device. Volumes are float32, C order (X, Y, Z).
// Every kernel counts its own launches: thread 0 of block 0 adds one to a
// device counter (and one more to the FOV = true count), so the launches made
// by the replays of a graph are counted as the eager ones are.
// Every kernel repeats its plain PyTorch version's roundings in the same
// order (unires_torch/ops/resample.py), so kernel and plain version agree to
// the bit.
//
// Plain C interface (one function per kernel, returning cudaGetLastError()),
// loaded with ctypes by unires_torch/ops/cuda_build.py. Each kernel launches on
// the caller's stream, never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// pull: a block of kPullWarps warps covers kPullTZ x 32 outputs along z,
// kPullWarps rows along y and kPullRX rows along x, kPullTZ x kPullRX
// outputs per thread; see pull_tile
constexpr int kPullWarps = 4;
constexpr int kPullTZ = 2;
constexpr int kPullRX = 2;
// push: a thread owns a tile of kPushTX (x) x kPushTY (y) x kPushTZ (z)
// targets, a block is kPushLanesZ (z) x kPushLanesY (y) x kPushLanesX (x)
// threads, so a warp covers 2 (z) x 4 (y) x 4 (x) tiles; see push_tile
constexpr int kPushTX = 1;
constexpr int kPushTY = 2;
constexpr int kPushTZ = 4;
constexpr int kPushLanesZ = 2;
constexpr int kPushLanesY = 4;
constexpr int kPushLanesX = 16;
// pull_grad: output rows along x a thread computes (i and i + 1)
constexpr int kRowsX = 2;
// pull_grad: a warp covers 16 (z) x 2 (y) outputs; see pull_grad_kernel
constexpr int kGradLanesZ = 16;
constexpr int kGradRowsY = 8;
// clamp before a float -> int cast: far anchors have no source anyway
constexpr float kFar = 1048576.0f;

struct Map34 {
  float m[12];  // row-major (3, 4)
};

// The map from device memory: three 16-byte loads (the wrapper checks the
// alignment), the same address in every thread.
__device__ __forceinline__ Map34 load_map_dev(const float* __restrict__ p) {
  Map34 M;
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float4 v = __ldg(q + r);
    M.m[4 * r] = v.x;
    M.m[4 * r + 1] = v.y;
    M.m[4 * r + 2] = v.z;
    M.m[4 * r + 3] = v.w;
  }
  return M;
}

// One launch more in the kernel's device counter (and in its FOV = true
// count): thread 0 of block 0 only (Z3: blocks with a third dimension).
template <bool FOV, bool Z3 = false>
__device__ __forceinline__ void count_launch(unsigned long long* cnt) {
  if (cnt != nullptr && (blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x |
                         threadIdx.y | (Z3 ? threadIdx.z : 0u)) == 0) {
    atomicAdd(cnt, 1ULL);
    if (FOV) atomicAdd(cnt + 1, 1ULL);
  }
}

// g_d = M[d,0]*x + M[d,1]*y + M[d,2]*z + M[d,3], rounded after every product
// and sum in this order. The explicit _rn intrinsics stop nvcc from
// contracting into FMAs, so pull and push compute bitwise-identical sample
// points (push is then exactly pull^T up to the order of its sums), and both
// match the plain PyTorch version, which rounds every operation.
__device__ __forceinline__ float map_axis(const Map34& M, int d, float x,
                                          float y, float z) {
  const float* r = M.m + 4 * d;
  float s = __fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y));
  s = __fadd_rn(s, __fmul_rn(r[2], z));
  return __fadd_rn(s, r[3]);
}

__device__ __forceinline__ void map_point(const Map34& M, float x, float y,
                                          float z, float g[3]) {
  g[0] = map_axis(M, 0, x, y, z);
  g[1] = map_axis(M, 1, x, y, z);
  g[2] = map_axis(M, 2, x, y, z);
}

// extrapolate=False: the sample point lies within [-0.5, n - 0.5] per axis.
// Bitwise & keeps the test free of branches.
__device__ __forceinline__ bool in_fov(const float g[3], int nx, int ny,
                                       int nz) {
  return (g[0] >= -0.5f) & (g[0] <= (float)nx - 0.5f) & (g[1] >= -0.5f) &
         (g[1] <= (float)ny - 0.5f) & (g[2] >= -0.5f) &
         (g[2] <= (float)nz - 0.5f);
}

// The fov override: bounds [lo_d, hi_d] given by the caller in place of
// [-0.5, n_d - 0.5] (the slab decomposition of unires_torch/parallel/
// spatial.py passes the GLOBAL field of view in a slab's local frame).
struct Box {
  float lo[3], hi[3];
};

// The FOV test of a kernel instantiated with (FOV = true) or without the
// override. The kernels take the Box last, so the default instantiation
// keeps its parameter offsets and its machine code.
template <bool FOV>
__device__ __forceinline__ bool inside(const float g[3], int nx, int ny,
                                       int nz, const Box& b) {
  if (FOV)
    return (g[0] >= b.lo[0]) & (g[0] <= b.hi[0]) & (g[1] >= b.lo[1]) &
           (g[1] <= b.hi[1]) & (g[2] >= b.lo[2]) & (g[2] <= b.hi[2]);
  return in_fov(g, nx, ny, nz);
}

__device__ __forceinline__ float madd(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

__device__ __forceinline__ int clamp_far(float x) {
  return (int)fminf(fmaxf(x, -kFar), kFar);
}

// The 8 trilinear corners of RX sample points g (the outputs of rows i and
// i + 1 of one thread): their floors fl, the corner values v in (a, b, c)
// order, and whether each point lies inside the FOV. Where every corner of
// every point lies inside the volume (almost everywhere), the corners are
// read from 4 row pointers at fixed +0 / +1 offsets with no test, and the
// default FOV test is implied; elsewhere each corner is tested and an
// outside corner reads 0, so that it adds w * 0 as the plain versions do.
// With the fov override (FOV = true) a point whose corners all lie inside
// the volume may still lie outside the bounds (a slab's zero halo rows lie
// inside its extended volume and outside the global FOV): every point is
// tested against the Box on both paths.
template <int RX, bool FOV = false>
__device__ __forceinline__ void gather_corners(
    const float* __restrict__ vol, float g[RX][3], int nx, int ny, int nz,
    float fl[RX][3], float v[RX][8], bool keep[RX], const Box& fov = Box()) {
  bool inner = true;
#pragma unroll
  for (int q = 0; q < RX; ++q) {
#pragma unroll
    for (int d = 0; d < 3; ++d) fl[q][d] = floorf(g[q][d]);
    inner = inner & (fl[q][0] >= 0.0f) & (fl[q][0] < (float)(nx - 1)) &
            (fl[q][1] >= 0.0f) & (fl[q][1] < (float)(ny - 1)) &
            (fl[q][2] >= 0.0f) & (fl[q][2] < (float)(nz - 1));
  }
  if (inner) {
    // every corner inside the volume, hence g inside the default FOV
    const unsigned sxy = (unsigned)ny * nz;
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      keep[q] = FOV ? inside<true>(g[q], nx, ny, nz, fov) : true;
      const unsigned idx =
          ((unsigned)fl[q][0] * ny + (unsigned)fl[q][1]) * nz +
          (unsigned)fl[q][2];
      const float* p0 = vol + idx;
      const float* p1 = vol + (idx + nz);
      const float* p2 = vol + (idx + sxy);
      const float* p3 = vol + (idx + sxy + nz);
      v[q][0] = __ldg(p0);
      v[q][1] = __ldg(p0 + 1);
      v[q][2] = __ldg(p1);
      v[q][3] = __ldg(p1 + 1);
      v[q][4] = __ldg(p2);
      v[q][5] = __ldg(p2 + 1);
      v[q][6] = __ldg(p3);
      v[q][7] = __ldg(p3 + 1);
    }
  } else {
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      keep[q] = inside<FOV>(g[q], nx, ny, nz, fov);
      const int a0 = clamp_far(fl[q][0]), b0 = clamp_far(fl[q][1]),
                c0 = clamp_far(fl[q][2]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int a = a0 + ((e >> 2) & 1), b = b0 + ((e >> 1) & 1),
                  c = c0 + (e & 1);
        const bool ok = (a >= 0) & (a < nx) & (b >= 0) & (b < ny) &
                        (c >= 0) & (c < nz);
        v[q][e] = ok ? __ldg(vol + (a * ny + b) * nz + c) : 0.0f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// pull
//
// Replaces the Pallas kernels _pull_shear_kernel (pallas_resample.py:423, via
// pallas_pull_shear) and _pull_kernel (pallas_resample.py:219, via
// pallas_pull) of unires_tpu/ops/pallas_resample.py. Their shear pre-pass,
// window plans and DMA covers exist because a TPU has no fast gather.
//
// Bound: device memory in principle (the input read once and the output
// written once: 17 us at the fit's 181x217x181 -> 181x217x185 on an H100 at
// 3.35 TB/s), in practice the issue rate: the plain version's arithmetic
// (the map, floors, 12 weight products, 8 multiply-adds, each rounded on
// its own: no FMA) plus the gather's addressing.
//
// Design: a block of 4 warps covers 64 (z) x 4 (y) x 2 (x) outputs, 4 per
// thread; each warp is one y row of 32 lanes along z, so that each corner
// load touches one or two 128-byte lines. The outputs of a thread (k and
// k + 32 of rows i and i + 1) share the rounded partial sums M[d,0] i +
// M[d,1] j of a row and M[d,2] k of a lane, and each finishes map_axis's
// sum in map_axis's order (pull_points), so the sample points stay
// bitwise those of push and of the plain version. The floors come from a
// rounding-down add (floor_rd), with no floorf or float -> int cast, which
// run on the conversion pipe. Order 1 reads its corners by gather_rd:
// where every corner of a thread's points lies inside the volume, 4 row
// pointers and no test; near the edge, each corner at an index clamped
// into the grid and zeroed outside (edge_corners: a warp with one lane near
// the edge runs it besides the fast path, so it is kept short). The fov
// override is the instantiation FOV = true, which tests every sample point
// against the caller's bounds.
//
// On an H100 at the bench fit's own maps, whose sample points all lie
// inside the volume, this tile is 20-23 % faster than the previous one, a
// warp of 8 (z) x 4 (y) outputs; at a map whose output grid overhangs the
// volume along z (chip_smoke.py's "fit" case) it is 4-7 % slower, every
// warp of a row's first and last blocks running the edge path. Mapping the
// lanes of such blocks as 8 (z) x 4 (y), chosen per block from the map,
// won there but cost every interior block 5-7 %, more than it saved over
// a converged fit's launches (scripts/cuda_pull_variants.py times it, the
// fixed tiles, a choice by a block barrier, z edges folded into the fast
// path by selects, and the c + 1 corners from the next lane by a shuffle).
// Staging each tile's input box in shared memory measured slower at every
// tile size tried (scripts/cuda_staged_variants.py).
//
// The batched launch (pull_batch_kernel) covers B volumes with one volume's
// launch grid: each thread computes its outputs in volume 0, 1, ... in
// turn, volume b at vol + b * vstride, its map at mp + 12 b and its output
// at out + b * ox * oy * oz, each by the same tile code (pull_tile) as the
// unbatched launch, so the two agree to the bit. The batch folded into the
// grid's z (volumes slowest or fastest) is timed by
// scripts/cuda_batch_variants.py.
// ---------------------------------------------------------------------------

// 1.5 * 2^23: for |x| < 2^22, x + kRd rounded down is kRd + floor(x), held
// exactly (the float32 spacing there is 1)
constexpr float kRd = 12582912.0f;
constexpr unsigned kRdBits = 0x4B400000u;  // the bits of kRd

// floor(x) as an unsigned integer by a rounding-down add: t = x + kRd
// rounded down, floor(x) = t - kRd exactly (*fl) and its integer is t's bits
// less kRd's. The unsigned test of that integer against n <= 2^22 holds iff
// floor(x) lies in [0, n), whatever x: for |x| >= 2^22 t's bits lie outside
// [kRdBits, kRdBits + 2^22).
__device__ __forceinline__ unsigned floor_rd(float x, float* fl) {
  const float t = __fadd_rd(x, kRd);
  *fl = __fsub_rn(t, kRd);
  return __float_as_uint(t) - kRdBits;
}

// The 8 corners of a point near the volume's edge, from its floors' bits
// fi (floor_rd): a corner outside the volume reads 0 (it then adds w * 0,
// as in the plain version), the others are read at their index. An
// outside index (fi + 1 past the grid, or a negative floor, whose bits wrap
// above any grid) is clamped into the grid so that every address is valid;
// its value is never used.
__device__ __forceinline__ void edge_corners(const float* __restrict__ vol,
                                             const unsigned fi[3], int nx,
                                             int ny, int nz, float v[8]) {
  const unsigned n[3] = {(unsigned)nx, (unsigned)ny, (unsigned)nz};
  bool ok[3][2];
  unsigned c[3][2];
#pragma unroll
  for (int d = 0; d < 3; ++d)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      ok[d][e] = fi[d] + e < n[d];
      c[d][e] = min(fi[d] + e, n[d] - 1);
    }
#pragma unroll
  for (int da = 0; da < 2; ++da)
#pragma unroll
    for (int db = 0; db < 2; ++db) {
      const float* row = vol + (c[0][da] * ny + c[1][db]) * nz;
#pragma unroll
      for (int dc = 0; dc < 2; ++dc)
        v[4 * da + 2 * db + dc] = (ok[0][da] & ok[1][db] & ok[2][dc])
                                      ? __ldg(row + c[2][dc])
                                      : 0.0f;
    }
}

// gather_corners for P points, the floors by floor_rd in place of floorf
// and a float -> int cast (both on the card's conversion pipe, a quarter of
// the float32 rate or less). Where every corner of every point lies inside
// the volume, the interior fast path of gather_corners (4 row pointers, no
// test); elsewhere each point's corners by edge_corners, fewer
// instructions than gather_corners' general path, which a warp runs
// whenever one of its lanes needs it. Every point is tested against the
// FOV (implied by the fast path for the default bounds).
template <int P, bool FOV>
__device__ __forceinline__ void gather_rd(const float* __restrict__ vol,
                                          float g[P][3], int nx, int ny,
                                          int nz, float fl[P][3],
                                          float v[P][8], bool keep[P],
                                          const Box& fov) {
  unsigned fi[P][3];
  bool inner = true;
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int d = 0; d < 3; ++d) fi[q][d] = floor_rd(g[q][d], &fl[q][d]);
    inner = inner & (fi[q][0] < (unsigned)(nx - 1)) &
            (fi[q][1] < (unsigned)(ny - 1)) & (fi[q][2] < (unsigned)(nz - 1));
  }
  if (inner) {
    // every corner inside the volume, hence g inside the default FOV
    const unsigned sxy = (unsigned)ny * nz;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      keep[q] = FOV ? inside<true>(g[q], nx, ny, nz, fov) : true;
      const unsigned idx = (fi[q][0] * ny + fi[q][1]) * nz + fi[q][2];
      const float* p0 = vol + idx;
      const float* p1 = vol + (idx + nz);
      const float* p2 = vol + (idx + sxy);
      const float* p3 = vol + (idx + sxy + nz);
      v[q][0] = __ldg(p0);
      v[q][1] = __ldg(p0 + 1);
      v[q][2] = __ldg(p1);
      v[q][3] = __ldg(p1 + 1);
      v[q][4] = __ldg(p2);
      v[q][5] = __ldg(p2 + 1);
      v[q][6] = __ldg(p3);
      v[q][7] = __ldg(p3 + 1);
    }
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      keep[q] = inside<FOV>(g[q], nx, ny, nz, fov);
      // floor_rd's floor is exact for |g| < 2^22 only
#pragma unroll
      for (int d = 0; d < 3; ++d) fl[q][d] = floorf(g[q][d]);
      edge_corners(vol, fi[q], nx, ny, nz, v[q]);
    }
  }
}

// The sample points of a thread's outputs (i0 + q, j, k0 + dz t), q < RX,
// t < TZ, point q TZ + t (a row or lane beyond the grid takes the grid's
// last; j is given inside it): map_axis's roundings in map_axis's order,
// with M[d,0] i + M[d,1] j rounded once per row and M[d,2] k once per lane.
template <int RX, int TZ>
__device__ __forceinline__ void pull_points(const Map34& M, int i0, int ox,
                                            int j, int k0, int dz, int oz,
                                            float g[RX * TZ][3]) {
  float pk[TZ][3];
#pragma unroll
  for (int t = 0; t < TZ; ++t) {
    const float k = (float)min(k0 + dz * t, oz - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) pk[t][d] = __fmul_rn(M.m[4 * d + 2], k);
  }
#pragma unroll
  for (int q = 0; q < RX; ++q) {
    const float i = (float)min(i0 + q, ox - 1);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float s = __fadd_rn(__fmul_rn(M.m[4 * d], i),
                                __fmul_rn(M.m[4 * d + 1], (float)j));
#pragma unroll
      for (int t = 0; t < TZ; ++t)
        g[q * TZ + t][d] = __fadd_rn(__fadd_rn(s, pk[t][d]), M.m[4 * d + 3]);
    }
  }
}

// One output of order 1 from its corners: the plain version's weights and
// corner order (a, then b, then c); 0 outside the FOV.
__device__ __forceinline__ float pull_trilinear(const float g[3],
                                                const float fl[3],
                                                const float v[8], bool keep) {
  const float f0 = __fsub_rn(g[0], fl[0]);
  const float f1 = __fsub_rn(g[1], fl[1]);
  const float f2 = __fsub_rn(g[2], fl[2]);
  const float wa[2] = {__fsub_rn(1.0f, f0), f0};
  const float wb[2] = {__fsub_rn(1.0f, f1), f1};
  const float wc[2] = {__fsub_rn(1.0f, f2), f2};
  float s = 0.0f;
#pragma unroll
  for (int da = 0; da < 2; ++da)
#pragma unroll
    for (int db = 0; db < 2; ++db) {
      const float wab = __fmul_rn(wa[da], wb[db]);
#pragma unroll
      for (int dc = 0; dc < 2; ++dc)
        s = madd(s, __fmul_rn(wab, wc[dc]), v[4 * da + 2 * db + dc]);
    }
  return keep ? s : 0.0f;
}

// One output of order 0: the voxel at floor(g + 1/2) (floor_rd), 0 outside
// the volume or the FOV.
template <bool FOV>
__device__ __forceinline__ float pull_nearest(const float* __restrict__ vol,
                                              const float g[3], int nx,
                                              int ny, int nz,
                                              const Box& fov) {
  float fl;
  const unsigned a = floor_rd(__fadd_rn(g[0], 0.5f), &fl);
  const unsigned b = floor_rd(__fadd_rn(g[1], 0.5f), &fl);
  const unsigned c = floor_rd(__fadd_rn(g[2], 0.5f), &fl);
  const bool ok = inside<FOV>(g, nx, ny, nz, fov) & (a < (unsigned)nx) &
                  (b < (unsigned)ny) & (c < (unsigned)nz);
  return ok ? __ldg(vol + (a * ny + b) * nz + c) : 0.0f;
}

// The outputs of thread (threadIdx.x, .y) of block (blockIdx.x, .y, xb):
// warp w the y row j = jb + w, lane l the outputs k = kb + l and k + 32 of
// rows i0 and i0 + 1 along x.
template <int ORDER, bool FOV>
__device__ __forceinline__ void pull_tile(const float* __restrict__ vol,
                                          float* __restrict__ out,
                                          const float* __restrict__ mp,
                                          int nx, int ny, int nz, int ox,
                                          int oy, int oz, const Box& fov,
                                          int xb) {
  constexpr int P = kPullRX * kPullTZ;
  const Map34 M = load_map_dev(mp);
  const int j = blockIdx.y * kPullWarps + threadIdx.y;
  const int k0 = blockIdx.x * (32 * kPullTZ) + threadIdx.x;
  const int i0 = xb * kPullRX;
  float g[P][3], res[P];
  pull_points<kPullRX, kPullTZ>(M, i0, ox, min(j, oy - 1), k0, 32, oz, g);
  if (ORDER == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      res[p] = pull_nearest<FOV>(vol, g[p], nx, ny, nz, fov);
  } else {
    float fl[P][3], v[P][8];
    bool keep[P];
    gather_rd<P, FOV>(vol, g, nx, ny, nz, fl, v, keep, fov);
#pragma unroll
    for (int p = 0; p < P; ++p)
      res[p] = pull_trilinear(g[p], fl[p], v[p], keep[p]);
  }
#pragma unroll
  for (int q = 0; q < kPullRX; ++q)
#pragma unroll
    for (int t = 0; t < kPullTZ; ++t) {
      const int k = k0 + 32 * t;
      if ((i0 + q < ox) & (j < oy) & (k < oz))
        out[((long long)(i0 + q) * oy + j) * oz + k] = res[q * kPullTZ + t];
    }
}

template <int ORDER, bool FOV>
__global__ void __launch_bounds__(32 * kPullWarps)
    pull_kernel(const float* __restrict__ vol, float* __restrict__ out,
                const float* __restrict__ mp, int nx, int ny, int nz, int ox,
                int oy, int oz, Box fov, unsigned long long* cnt) {
  count_launch<FOV>(cnt);
  pull_tile<ORDER, FOV>(vol, out, mp, nx, ny, nz, ox, oy, oz, fov,
                        blockIdx.z);
}

template <int ORDER, bool FOV>
__global__ void __launch_bounds__(32 * kPullWarps)
    pull_batch_kernel(const float* __restrict__ vol, float* __restrict__ out,
                      const float* __restrict__ mp, int nx, int ny, int nz,
                      int ox, int oy, int oz, Box fov,
                      unsigned long long* cnt, int batch, long long vstride) {
  count_launch<FOV>(cnt);
  for (int b = 0; b < batch; ++b)
    pull_tile<ORDER, FOV>(vol + b * vstride,
                          out + b * ((long long)ox * oy * oz), mp + 12 * b,
                          nx, ny, nz, ox, oy, oz, fov, blockIdx.z);
}

// pull's launch grid (z / 64, y / 4, x / 2) of blocks (32, 4)
dim3 pull_grid(int ox, int oy, int oz) {
  return dim3((unsigned)((oz + 32 * kPullTZ - 1) / (32 * kPullTZ)),
              (unsigned)((oy + kPullWarps - 1) / kPullWarps),
              (unsigned)((ox + kPullRX - 1) / kPullRX));
}

// ---------------------------------------------------------------------------
// push
//
// Replaces the Pallas kernels _push_shear_kernel (pallas_resample.py:782, via
// pallas_push_shear), _push_kernel (pallas_resample.py:673, via pallas_push)
// and their FOV premask _fov_premask (pallas_resample.py:1235).
//
// The gather form of the adjoint, as _push_gather (unires_tpu/ops/
// resample.py:151-207) and push_plain state it: target voxel v anchors at
// round(Minv . v) and sums, over the candidate sources o of its window in
// (da, db, dc) order, pull's weight of o onto v times vals[o]. No atomics:
// every output is written once by one thread, so the result is reproducible
// and bitwise equal to push_plain.
//
// Bound: device memory in principle (the source and target volumes once
// each: 17 us at the fit's shapes on an H100), in practice the issue rate.
// A source weighs on the 8 targets around its sample point g(o), so the
// port's first gather, one target per thread (scripts/push_variants.cu:
// "target"), computed every source's g, floors, fractions and load once per
// target it weighs on: 10.1 loop turns per target for a warp's slowest
// lane at the fit's map, 56 instructions each, 8.2 % of the bound on an
// H100 (0.209 ms).
//
// Design: a thread owns a tile of TX (x) x TY (y) x TZ (z) targets and
// visits the union of their candidate boxes once, in (oa, ob, oc) order. A
// weight needs |M o + m - v|_inf < 1 (1/2 at order 0), so |o - Minv v|_d <=
// reach_d, the L1 norm of Minv's row d plus rounding margins (ops/
// resample.py: push_reach); a target's box is [ceil(c - reach), floor(c +
// reach)] per axis, c = Minv . v, cut to the window and the grid. Per source
// the sample point (partial sums M[d,0] oa and + M[d,1] ob hoisted, in the
// plain version's left-to-right order), the FOV test, the floors, the
// fractions and the load are computed once; the source then adds
// ((w_x w_y) w_z) vals[o] to the targets v with v_d in {fl_d, fl_d + 1}
// (round(g) at order 0), with the plain version's roundings, each target's
// sum in its own register (unrolled, predicated adds: no dynamic index).
// Each target still receives its weighted sources in (oa, ob, oc) order,
// which the union's order keeps, so its sum is bitwise push_plain's: a
// source of the union outside a target's reach weighs 0 on it and is not
// added. Where the window is narrower than the reach for some target of the
// tile (a caller's window), the union would add sources the window drops:
// that tile takes the path of one target at a time, each over its own box,
// with the same visit code (a tile of 1). Tiles whose targets are all
// interior skip the FOV test (a weighted source of an interior target lies
// inside the default FOV); with the fov override (FOV = true) every source
// of every tile is tested against the bounds.
//
// The tile is 1 x 2 x 4 targets and a warp's 32 lanes are 2 (z) x 4 (y) x
// 4 (x) tiles: at the fit's map the slowest lane of a warp visits 4.7
// sources per target (10.1 turns before), 71 instructions each, 20 of them
// the routing into the 8 registers. The lanes span x as well because the
// union's extent varies with the fraction of c, and the shear moves that
// fraction least across a warp whose footprint is compact in all three
// axes (5.4 visits per target with 8 (z) x 4 (y) lanes; the counts:
// scripts/push_tile_counts.py). Measured on an H100 at 700 W: 0.123 ms at
// the fit's map, 14 % of the bound, 0.57 of grid_sampler_3d_backward;
// still bound by the issue rate. One tile serves every map: at the 45
// degree x 3 map of chip_smoke.py (an eighth as many sources as targets, a
// map no caller of the port makes) push is 1.02-1.06x the library call.
//
// Tried and lost (scripts/cuda_push_variants.py reruns them): one target
// per thread ("target"); other tiles (1 x 1 x 4 to 2 x 2 x 4) and block
// shapes; selects in place of predicated adds, the oc loop unrolled by 2, a
// floor by a rounding-down add, the union from every target's box, stores
// through shared memory (opt_tile's options there; the stores through
// shared memory won at the 45 degree x 3 map, 0.055 -> 0.046 ms, and cost
// 9 % at the fit's map); each tile's sums in shared memory, a source
// reaching its targets by address ("smem"); staging a source box per
// target tile in shared memory (scripts/cuda_staged_variants.py).
//
// The batched launch (push_batch_kernel) folds the B volumes into the
// grid's z, the volumes fastest: block z = (x block) * B + b; volume b's
// sources at vals + b * vstride, its plan at plan + 32 b, its output at
// out + b * tx * ty * tz, each tile computed by the same code (push_tile)
// as unbatched. One volume's launch grid with each thread over the volumes
// (pull's mapping) measured 1.18x three unbatched launches
// (scripts/cuda_batch_variants.py: "loop").
// ---------------------------------------------------------------------------

// Source o of sample point g(o) = (s01 + M[:,2] oc) + M[:,3] (fc = oc)
// added to the targets (vi + a, vj + b, vk + q) of the tile (a < TX,
// b < TY, q < TZ) that it weighs on. EDGE: the source is tested against the
// FOV (tx, ty, tz: the target grid).
template <int ORDER, bool FOV, bool EDGE, int TX, int TY, int TZ>
__device__ __forceinline__ void push_source(
    const Map34& M, const float s01[3], float fc, const float* __restrict__ src,
    float vi, float vj, float vk, int tx, int ty, int tz, const Box& fov,
    float acc[TX][TY][TZ]) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = __fadd_rn(__fadd_rn(s01[d], __fmul_rn(M.m[4 * d + 2], fc)),
                     M.m[4 * d + 3]);
  if (EDGE && !inside<FOV>(g, tx, ty, tz, fov)) return;
  const float val = __ldg(src);
  if (ORDER == 0) {
    // weight 1 on the target at round(g): + 1 * vals[o] as the plain
    // version adds it, + 0 on the others
    const float n0 = floorf(g[0] + 0.5f);
    const float n1 = floorf(g[1] + 0.5f);
    const float n2 = floorf(g[2] + 0.5f);
#pragma unroll
    for (int a = 0; a < TX; ++a)
#pragma unroll
      for (int b = 0; b < TY; ++b)
#pragma unroll
        for (int q = 0; q < TZ; ++q)
          acc[a][b][q] = madd(acc[a][b][q],
                              (n0 == vi + (float)a) & (n1 == vj + (float)b) &
                                      (n2 == vk + (float)q)
                                  ? 1.0f
                                  : 0.0f,
                              val);
    return;
  }
  // per axis, target v_d - floor(g_d) (a whole number): 0 weighs 1 - f,
  // 1 weighs f, any other 0
  float fl[3], f[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    fl[d] = floorf(g[d]);
    f[d] = __fsub_rn(g[d], fl[d]);
  }
  const float ex = __fsub_rn(vi, fl[0]);
  const float ey = __fsub_rn(vj, fl[1]);
  const float ez = __fsub_rn(vk, fl[2]);
  const float wx0 = __fsub_rn(1.0f, f[0]);
  const float wy0 = __fsub_rn(1.0f, f[1]);
  const float wz0 = __fsub_rn(1.0f, f[2]);
#pragma unroll
  for (int a = 0; a < TX; ++a) {
    const float wx = ex == -(float)a          ? wx0
                     : ex == 1.0f - (float)a ? f[0]
                                              : 0.0f;
#pragma unroll
    for (int b = 0; b < TY; ++b) {
      const float wy = ey == -(float)b          ? wy0
                       : ey == 1.0f - (float)b ? f[1]
                                                : 0.0f;
      // ((1 w_x) w_y) w_z, then times vals[o]: the plain version's
      // roundings
      const float wxy = __fmul_rn(wx, wy);
      const float m0 = __fmul_rn(__fmul_rn(wxy, wz0), val);
      const float m1 = __fmul_rn(__fmul_rn(wxy, f[2]), val);
#pragma unroll
      for (int q = 0; q < TZ; ++q) {
        const bool p0 = ez == -(float)q, p1 = ez == 1.0f - (float)q;
        if (p0 | p1) acc[a][b][q] = __fadd_rn(acc[a][b][q], p0 ? m0 : m1);
      }
    }
  }
}

// The sources of the box [lo, hi] in (oa, ob, oc) order, each added to the
// tile's targets that it weighs on (push_source).
template <int ORDER, bool FOV, bool EDGE, int TX, int TY, int TZ>
__device__ __forceinline__ void push_visit(
    const float* __restrict__ vals, const Map34& M, int sy, int sz,
    const int lo[3], const int hi[3], float vi, float vj, float vk, int tx,
    int ty, int tz, const Box& fov, float acc[TX][TY][TZ]) {
  float fa = (float)lo[0];
  for (int oa = lo[0]; oa <= hi[0]; ++oa, fa += 1.0f) {
    float pa[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) pa[d] = __fmul_rn(M.m[4 * d], fa);
    float fb = (float)lo[1];
    for (int ob = lo[1]; ob <= hi[1]; ++ob, fb += 1.0f) {
      float s01[3];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s01[d] = __fadd_rn(pa[d], __fmul_rn(M.m[4 * d + 1], fb));
      const float* src = vals + ((oa * sy + ob) * sz + lo[2]);
      float fc = (float)lo[2];
      // one turn at a time: unrolled by 2, or as the compiler chooses, it
      // measured 13 % and 4 % slower on an H100
#pragma unroll 1
      for (int oc = lo[2]; oc <= hi[2]; ++oc, fc += 1.0f, ++src)
        push_source<ORDER, FOV, EDGE, TX, TY, TZ>(
            M, s01, fc, src, vi, vj, vk, tx, ty, tz, fov, acc);
    }
  }
}

// One target's candidate box as a tile of one computes it (the path of a
// tile whose window cuts a box).
__device__ __forceinline__ void push_box(const float c[3], const float r[3],
                                         const int w[3], const int s[3],
                                         int lo[3], int hi[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int anc = clamp_far(floorf(c[d] + 0.5f));
    lo[d] = max(max(clamp_far(ceilf(c[d] - r[d])), anc - w[d]), 0);
    hi[d] = min(min(clamp_far(floorf(c[d] + r[d])), anc + w[d]), s[d] - 1);
  }
}

// The sums of the tile whose first target (vi, vj, vk) lies inside the
// target grid: put(a, b, q, sum) for every target (vi + a, vj + b, vk + q),
// a < TX, b < TY, q < TZ (those outside the grid included).
template <int ORDER, bool FOV, int TX, int TY, int TZ, class Put>
__device__ __forceinline__ void push_sums(const float* __restrict__ vals,
                                          const float* __restrict__ plan,
                                          int sx, int sy, int sz, int tx,
                                          int ty, int tz, int wx, int wy,
                                          int wz, const Box& fov, int vi,
                                          int vj, int vk, Put put) {
  // the plan (ops/resample.py: push_plan): M, Minv, reach (3), window (3)
  const Map34 M = load_map_dev(plan);
  const Map34 Minv = load_map_dev(plan + 12);
  const float4 p0 = __ldg(reinterpret_cast<const float4*>(plan + 24));
  const float4 p1 = __ldg(reinterpret_cast<const float4*>(plan + 28));
  const float r[3] = {p0.x, p0.y, p0.z};
  // a window given by the caller (>= 0) or the plan's
  const int w[3] = {wx >= 0 ? wx : (int)p0.w, wy >= 0 ? wy : (int)p1.x,
                    wz >= 0 ? wz : (int)p1.y};
  const int s[3] = {sx, sy, sz};
  const float fi = (float)vi, fj = (float)vj, fk = (float)vk;
  // The union of the tile's boxes, and whether the window cuts one. Where
  // the reach lies inside the window by a margin (r + 2^-8 < w + 1/2 on
  // every axis) and |c| < 2^13 at the tile's corners, no window can cut a
  // box (a cut needs r >= w + 1/2 - 2 ulp(c)), and, c being affine in the
  // target, the union is that of the corners' boxes (push_reach's margins
  // cover the rounding of c). Else every target's box is computed.
  float ulo[3] = {kFar, kFar, kFar}, uhi[3] = {-kFar, -kFar, -kFar};
  bool exact = false;
#pragma unroll
  for (int d = 0; d < 3; ++d)
    exact |= !(r[d] + 0.00390625f < (float)w[d] + 0.5f);
  if (!exact) {
#pragma unroll
    for (int a = 0; a < (TX > 1 ? 2 : 1); ++a)
#pragma unroll
      for (int b = 0; b < (TY > 1 ? 2 : 1); ++b)
#pragma unroll
        for (int q = 0; q < (TZ > 1 ? 2 : 1); ++q) {
          float c[3];
          map_point(Minv, fi + (float)(a * (TX - 1)),
                    fj + (float)(b * (TY - 1)), fk + (float)(q * (TZ - 1)),
                    c);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            exact |= !(fabsf(c[d]) < 8192.0f);
            ulo[d] = fminf(ulo[d], ceilf(c[d] - r[d]));
            uhi[d] = fmaxf(uhi[d], floorf(c[d] + r[d]));
          }
        }
  }
  bool cut = false;
  if (exact) {
#pragma unroll
    for (int d = 0; d < 3; ++d) ulo[d] = kFar, uhi[d] = -kFar;
#pragma unroll
    for (int a = 0; a < TX; ++a)
#pragma unroll
      for (int b = 0; b < TY; ++b)
#pragma unroll
        for (int q = 0; q < TZ; ++q) {
          if ((vi + a >= tx) | (vj + b >= ty) | (vk + q >= tz)) continue;
          float c[3];
          map_point(Minv, fi + (float)a, fj + (float)b, fk + (float)q, c);
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const float anc = floorf(c[d] + 0.5f);
            const float lo0 = ceilf(c[d] - r[d]), hi0 = floorf(c[d] + r[d]);
            const float wl = anc - (float)w[d], wh = anc + (float)w[d];
            cut = cut | (wl > lo0) | (wh < hi0);
            ulo[d] = fminf(ulo[d], fmaxf(lo0, wl));
            uhi[d] = fmaxf(uhi[d], fminf(hi0, wh));
          }
        }
  }
  // a weighted source of an interior target lies inside the default FOV
  const bool edge = FOV | (vi < 1) | (vi + TX > tx - 1) | (vj < 1) |
                    (vj + TY > ty - 1) | (vk < 1) | (vk + TZ > tz - 1);
  if (!cut) {
    int lo[3], hi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = (int)fminf(fmaxf(ulo[d], 0.0f), kFar);
      hi[d] = (int)fmaxf(fminf(uhi[d], (float)(s[d] - 1)), -1.0f);
    }
    float acc[TX][TY][TZ];
#pragma unroll
    for (int a = 0; a < TX; ++a)
#pragma unroll
      for (int b = 0; b < TY; ++b)
#pragma unroll
        for (int q = 0; q < TZ; ++q) acc[a][b][q] = 0.0f;
    if (edge)
      push_visit<ORDER, FOV, true, TX, TY, TZ>(
          vals, M, sy, sz, lo, hi, fi, fj, fk, tx, ty, tz, fov, acc);
    else
      push_visit<ORDER, FOV, false, TX, TY, TZ>(
          vals, M, sy, sz, lo, hi, fi, fj, fk, tx, ty, tz, fov, acc);
#pragma unroll
    for (int a = 0; a < TX; ++a)
#pragma unroll
      for (int b = 0; b < TY; ++b)
#pragma unroll
        for (int q = 0; q < TZ; ++q) put(a, b, q, acc[a][b][q]);
    return;
  }
  // the window cuts a box: each target alone over its own box
#pragma unroll 1
  for (int t = 0; t < TX * TY * TZ; ++t) {
    const int a = t / (TY * TZ), b = (t / TZ) % TY, q = t % TZ;
    const float i = fi + (float)a, j = fj + (float)b, k = fk + (float)q;
    float c[3];
    map_point(Minv, i, j, k, c);
    int lo[3], hi[3];
    push_box(c, r, w, s, lo, hi);
    float acc[1][1][1] = {{{0.0f}}};
    push_visit<ORDER, FOV, true, 1, 1, 1>(vals, M, sy, sz, lo, hi, i, j, k,
                                          tx, ty, tz, fov, acc);
    put(a, b, q, acc[0][0][0]);
  }
}

// The tiles of a block (blockIdx.x, .y, xb) of LZ (z) x LY (y) x LX (x)
// threads, thread (threadIdx.x, .y, .z) the tile of targets (vi + a, vj +
// b, vk + q), a < TX, b < TY, q < TZ, written to out (the target grid)
// where they lie inside it.
template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX>
__device__ __forceinline__ void push_tile(const float* __restrict__ vals,
                                          float* __restrict__ out,
                                          const float* __restrict__ plan,
                                          int sx, int sy, int sz, int tx,
                                          int ty, int tz, int wx, int wy,
                                          int wz, const Box& fov, int xb) {
  const int vi = (xb * LX + threadIdx.z) * TX;
  const int vj = (blockIdx.y * LY + threadIdx.y) * TY;
  const int vk = (blockIdx.x * LZ + threadIdx.x) * TZ;
  if ((vi < tx) & (vj < ty) & (vk < tz))
    push_sums<ORDER, FOV, TX, TY, TZ>(
        vals, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, fov, vi, vj, vk,
        [&](int a, int b, int q, float v) {
          if ((vi + a < tx) & (vj + b < ty) & (vk + q < tz))
            out[((long long)(vi + a) * ty + vj + b) * tz + vk + q] = v;
        });
}

template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX>
__global__ void __launch_bounds__(LZ * LY * LX)
    push_kernel(const float* __restrict__ vals, float* __restrict__ out,
                const float* __restrict__ plan, int sx, int sy, int sz,
                int tx, int ty, int tz, int wx, int wy, int wz, Box fov,
                unsigned long long* cnt) {
  count_launch<FOV, true>(cnt);
  push_tile<ORDER, FOV, TX, TY, TZ, LZ, LY, LX>(
      vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, fov, blockIdx.z);
}

// The batched launch: block z = (x block) * batch + b, so the blocks of
// one place in the B volumes run side by side.
template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX>
__global__ void __launch_bounds__(LZ * LY * LX)
    push_batch_kernel(const float* __restrict__ vals, float* __restrict__ out,
                      const float* __restrict__ plan, int sx, int sy, int sz,
                      int tx, int ty, int tz, int wx, int wy, int wz, Box fov,
                      unsigned long long* cnt, int batch, long long vstride) {
  count_launch<FOV, true>(cnt);
  const int xb = blockIdx.z / batch, b = blockIdx.z - xb * batch;
  push_tile<ORDER, FOV, TX, TY, TZ, LZ, LY, LX>(
      vals + b * vstride, out + b * ((long long)tx * ty * tz), plan + 32 * b,
      sx, sy, sz, tx, ty, tz, wx, wy, wz, fov, xb);
}

// push's launch: grid (z tiles / LZ, y tiles / LY, x tiles / LX), block
// (LZ, LY, LX)
template <int TX, int TY, int TZ, int LZ, int LY, int LX>
dim3 push_grid(int tx, int ty, int tz) {
  return dim3((unsigned)((tz + LZ * TZ - 1) / (LZ * TZ)),
              (unsigned)((ty + LY * TY - 1) / (LY * TY)),
              (unsigned)((tx + LX * TX - 1) / (LX * TX)));
}

// ---------------------------------------------------------------------------
// pull_grad
//
// Replaces the Pallas kernels _pull_grad_shear_kernel (pallas_resample.py:547,
// via pallas_pull_grad_shear) and _pull_grad_kernel (pallas_resample.py:328,
// via pallas_pull_grad) of unires_tpu/ops/pallas_resample.py: d pull / d g,
// the derivative of the trilinear sample with respect to the sample point,
// as _pull_grad_gather (unires_tpu/ops/resample.py:210-245) states it.
//
// Per output voxel and per corner (a, b, c) with value v of the 8 corners:
//   grad_x += (+-1) * wb * wc * v,  grad_y += wa * (+-1) * wc * v,
//   grad_z += wa * wb * (+-1) * v
// (+1 for the upper corner, -1 for the lower), out-of-range corners count 0,
// and outputs whose sample point lies outside the FOV are 0. The plain
// version rounds ((s * w) * w) * v and sums over a, b, c in loop order. A
// product with +-1 is exact, so (sa * wb) * wc = +-(wb * wc), (wa * sb) * wc
// = +-(wa * wc) and (wa * wb) * sc = +-(wa * wb): the 12 pair products
// wb wc, wa wc, wa wb are rounded once each and reused with a sign, the
// sample point comes from the same map_axis as pull, and kernel and plain
// version agree to the bit.
//
// Bound: device memory (the input read once, three floats written per
// output: 34 us at the fit's 181x217x181 -> 181x217x185x3 on an H100 at 3.35
// TB/s, three quarters of it stores), with pull's gather and issue load on
// top. The output is (ox, oy, oz, 3) in C order, the JAX layout: a thread's
// three results lie 12 bytes apart.
//
// Design: pull's launch grid (no index split), its two rows per thread and
// its corner gather (gather_corners: no branch per corner, the 8 loads
// issued together), and the 12 pair products above in place of 48 weight
// products. A warp covers 16 (z) x 2 (y) outputs and stores its results
// directly: each of its three store instructions touches two runs of 192
// bytes, and L2 merges the three into whole sectors. Passing the results
// through shared memory, so that every store instruction writes consecutive
// floats, measured slower at every block shape, behind a block barrier and
// behind a warp barrier alike: the stores were not what held the first
// kernel back (scripts/cuda_pull_grad_variants.py reruns the comparison,
// with the first kernel and the other block shapes).
// ---------------------------------------------------------------------------
template <int RX>
__device__ __forceinline__ void pull_grad_rows(
    const float* __restrict__ vol, const Map34& M, int nx, int ny, int nz,
    int i0, int ox, int j, int k, float res[RX][3]) {
  float g[RX][3], fl[RX][3], v[RX][8];
  bool keep[RX];
#pragma unroll
  for (int q = 0; q < RX; ++q)
    map_point(M, (float)min(i0 + q, ox - 1), (float)j, (float)k, g[q]);
  gather_corners<RX>(vol, g, nx, ny, nz, fl, v, keep);
#pragma unroll
  for (int q = 0; q < RX; ++q) {
    const float f0 = __fsub_rn(g[q][0], fl[q][0]);
    const float f1 = __fsub_rn(g[q][1], fl[q][1]);
    const float f2 = __fsub_rn(g[q][2], fl[q][2]);
    const float wa[2] = {__fsub_rn(1.0f, f0), f0};
    const float wb[2] = {__fsub_rn(1.0f, f1), f1};
    const float wc[2] = {__fsub_rn(1.0f, f2), f2};
    float pbc[2][2], pac[2][2], pab[2][2];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        pbc[s][t] = __fmul_rn(wb[s], wc[t]);
        pac[s][t] = __fmul_rn(wa[s], wc[t]);
        pab[s][t] = __fmul_rn(wa[s], wb[t]);
      }
    // the plain version's corner order: a, then b, then c
    float gx = 0.0f, gy = 0.0f, gz = 0.0f;
#pragma unroll
    for (int da = 0; da < 2; ++da)
#pragma unroll
      for (int db = 0; db < 2; ++db)
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) {
          const float val = v[q][4 * da + 2 * db + dc];
          gx = madd(gx, da ? pbc[db][dc] : -pbc[db][dc], val);
          gy = madd(gy, db ? pac[da][dc] : -pac[da][dc], val);
          gz = madd(gz, dc ? pab[da][db] : -pab[da][db], val);
        }
    res[q][0] = keep[q] ? gx : 0.0f;
    res[q][1] = keep[q] ? gy : 0.0f;
    res[q][2] = keep[q] ? gz : 0.0f;
  }
}

template <int LZ, int RY, int RX>
__device__ __forceinline__ void pull_grad_tile(const float* __restrict__ vol,
                                               float* __restrict__ out,
                                               const Map34& M, int nx, int ny,
                                               int nz, int ox, int oy,
                                               int oz, int zb) {
  const int j = blockIdx.y * RY + threadIdx.y;
  const int k = blockIdx.x * LZ + threadIdx.x;
  if (j >= oy || k >= oz) return;
  const int i0 = zb * RX;
  float res[RX][3];
  pull_grad_rows<RX>(vol, M, nx, ny, nz, i0, ox, j, k, res);
#pragma unroll
  for (int q = 0; q < RX; ++q) {
    if (i0 + q >= ox) break;
    float* o = out + 3 * (((i0 + q) * oy + j) * oz + k);
    o[0] = res[q][0];
    o[1] = res[q][1];
    o[2] = res[q][2];
  }
}

template <int LZ, int RY, int RX>
__global__ void __launch_bounds__(LZ * RY)
    pull_grad_kernel(const float* __restrict__ vol, float* __restrict__ out,
                     const float* __restrict__ mp, int nx, int ny, int nz,
                     int ox, int oy, int oz, unsigned long long* cnt) {
  count_launch<false>(cnt);
  pull_grad_tile<LZ, RY, RX>(vol, out, load_map_dev(mp), nx, ny, nz, ox, oy,
                             oz, blockIdx.z);
}

// The batched launch, as pull's: one volume's launch grid, each thread
// its output position in every volume in turn.
template <int LZ, int RY, int RX>
__global__ void __launch_bounds__(LZ * RY)
    pull_grad_batch_kernel(const float* __restrict__ vol,
                           float* __restrict__ out,
                           const float* __restrict__ mp, int nx, int ny,
                           int nz, int ox, int oy, int oz,
                           unsigned long long* cnt, int batch,
                           long long vstride) {
  count_launch<false>(cnt);
  for (int b = 0; b < batch; ++b)
    pull_grad_tile<LZ, RY, RX>(vol + b * vstride,
                               out + b * (3LL * ox * oy * oz),
                               load_map_dev(mp + 12 * b), nx, ny, nz, ox, oy,
                               oz, blockIdx.z);
}

// The map by value and no count: the block-shape sweep of
// scripts/pull_grad_variants.cu (which includes this file) launches this
// form; the library never instantiates it.
template <int LZ, int RY, int RX>
__global__ void __launch_bounds__(LZ * RY)
    pull_grad_kernel(const float* __restrict__ vol, float* __restrict__ out,
                     Map34 M, int nx, int ny, int nz, int ox, int oy,
                     int oz) {
  pull_grad_tile<LZ, RY, RX>(vol, out, M, nx, ny, nz, ox, oy, oz,
                             blockIdx.z);
}

// A host map (12 floats) by value, for scripts/pull_grad_variants.cu.
inline Map34 load_map(const float* m) {
  Map34 M;
  for (int q = 0; q < 12; ++q) M.m[q] = m[q];
  return M;
}

// fov: null, or a host pointer to the (3, 2) bounds [[lo_x, hi_x], ...]
inline Box load_box(const float* fov) {
  Box b = {};
  if (fov)
    for (int d = 0; d < 3; ++d) {
      b.lo[d] = fov[2 * d];
      b.hi[d] = fov[2 * d + 1];
    }
  return b;
}

template <int ORDER>
void launch_pull(cudaStream_t s, const float* vol, float* out,
                 const float* m, int nx, int ny, int nz, int ox, int oy,
                 int oz, const float* fov, unsigned long long* cnt) {
  const dim3 grid = pull_grid(ox, oy, oz), block(32, kPullWarps);
  if (fov)
    pull_kernel<ORDER, true><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, load_box(fov), cnt);
  else
    pull_kernel<ORDER, false><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, Box(), cnt);
}

// One launch of push at tile TX x TY x TZ and block LZ x LY x LX: the batched
// kernel when batch > 0, else the unbatched one.
template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX>
void launch_push_kernel(cudaStream_t s, const float* vals, float* out,
                        const float* plan, int sx, int sy, int sz, int tx,
                        int ty, int tz, int wx, int wy, int wz, Box box,
                        unsigned long long* cnt, int batch,
                        long long vstride) {
  dim3 grid = push_grid<TX, TY, TZ, LZ, LY, LX>(tx, ty, tz);
  const dim3 block(LZ, LY, LX);
  if (batch > 0) {
    grid.z *= (unsigned)batch;
    push_batch_kernel<ORDER, FOV, TX, TY, TZ, LZ, LY, LX>
        <<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                                wy, wz, box, cnt, batch, vstride);
  } else {
    push_kernel<ORDER, FOV, TX, TY, TZ, LZ, LY, LX>
        <<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                                wy, wz, box, cnt);
  }
}

// push's instantiation for the order and the fov (null: the default bounds)
int launch_push(cudaStream_t s, const float* vals, float* out,
                const float* plan, const float* fov, int sx, int sy, int sz,
                int tx, int ty, int tz, int wx, int wy, int wz, int order,
                unsigned long long* cnt, int batch, long long vstride) {
  constexpr int TX = kPushTX, TY = kPushTY, TZ = kPushTZ;
  constexpr int LZ = kPushLanesZ, LY = kPushLanesY, LX = kPushLanesX;
  const Box box = load_box(fov);
  if (order == 0 && fov)
    launch_push_kernel<0, true, TX, TY, TZ, LZ, LY, LX>(
        s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, box, cnt,
        batch, vstride);
  else if (order == 0)
    launch_push_kernel<0, false, TX, TY, TZ, LZ, LY, LX>(
        s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, box, cnt,
        batch, vstride);
  else if (fov)
    launch_push_kernel<1, true, TX, TY, TZ, LZ, LY, LX>(
        s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, box, cnt,
        batch, vstride);
  else
    launch_push_kernel<1, false, TX, TY, TZ, LZ, LY, LX>(
        s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, box, cnt,
        batch, vstride);
  return (int)cudaGetLastError();
}

template <int ORDER>
void launch_pull_batch(cudaStream_t s, const float* vol, float* out,
                       const float* m, int nx, int ny, int nz, int ox, int oy,
                       int oz, const float* fov, unsigned long long* cnt,
                       int batch, long long vstride) {
  const dim3 grid = pull_grid(ox, oy, oz), block(32, kPullWarps);
  if (fov)
    pull_batch_kernel<ORDER, true><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, load_box(fov), cnt, batch,
        vstride);
  else
    pull_batch_kernel<ORDER, false><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, Box(), cnt, batch, vstride);
}

}  // namespace

extern "C" {

// vol (nx, ny, nz) -> out (ox, oy, oz); m: device pointer to the 12 floats of
// the map (16-byte aligned); fov: null (bounds [-0.5, n - 0.5]) or a host
// pointer to 6 floats; cnt: null or the device counter (2 x u64: launches,
// FOV = true launches).
int unires_pull(const float* vol, float* out, const float* m,
                const float* fov, int nx, int ny, int nz, int ox, int oy,
                int oz, int order, unsigned long long* cnt, void* stream) {
  if ((long long)ox * oy * oz == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    launch_pull<0>(s, vol, out, m, nx, ny, nz, ox, oy, oz, fov, cnt);
  else
    launch_pull<1>(s, vol, out, m, nx, ny, nz, ox, oy, oz, fov, cnt);
  return (int)cudaGetLastError();
}

// vals (sx, sy, sz) on pull's output grid -> out (tx, ty, tz) on pull's
// input grid; plan: device pointer to the 32 floats of ops/resample.py:
// push_plan (M, Minv, reach, window; 16-byte aligned); fov: null or a host
// pointer to 6 floats, as pull's; (wx, wy, wz): the caller's window, or -1
// for the plan's; cnt as pull's.
int unires_push(const float* vals, float* out, const float* plan,
                const float* fov, int sx, int sy, int sz, int tx, int ty,
                int tz, int wx, int wy, int wz, int order,
                unsigned long long* cnt, void* stream) {
  if ((long long)tx * ty * tz == 0) return (int)cudaGetLastError();
  return launch_push((cudaStream_t)stream, vals, out, plan, fov, sx, sy, sz,
                     tx, ty, tz, wx, wy, wz, order, cnt, 0, 0);
}

// vol (nx, ny, nz) -> out (ox, oy, oz, 3); m: device pointer to 12 floats;
// cnt as pull's.
int unires_pull_grad(const float* vol, float* out, const float* m, int nx,
                     int ny, int nz, int ox, int oy, int oz,
                     unsigned long long* cnt, void* stream) {
  if ((long long)ox * oy * oz == 0) return (int)cudaGetLastError();
  const dim3 block(kGradLanesZ, kGradRowsY);
  const dim3 grid((unsigned)((oz + kGradLanesZ - 1) / kGradLanesZ),
                  (unsigned)((oy + kGradRowsY - 1) / kGradRowsY),
                  (unsigned)((ox + kRowsX - 1) / kRowsX));
  pull_grad_kernel<kGradLanesZ, kGradRowsY, kRowsX>
      <<<grid, block, 0, (cudaStream_t)stream>>>(vol, out, m, nx, ny, nz, ox,
                                                 oy, oz, cnt);
  return (int)cudaGetLastError();
}

// The batched launches: B volumes in one launch. Volume b of the input
// starts vstride floats after volume b - 1 (each volume C-contiguous; a
// stride of 0 reads one volume B times); its map (pull, pull_grad) is the
// 12 floats at m + 12 b, its plan (push) the 32 at plan + 32 b, and its
// output follows the previous one's. Other arguments as unbatched.
int unires_pull_batch(const float* vol, float* out, const float* m,
                      const float* fov, int nx, int ny, int nz, int ox,
                      int oy, int oz, int order, int batch, long long vstride,
                      unsigned long long* cnt, void* stream) {
  if ((long long)ox * oy * oz * batch == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    launch_pull_batch<0>(s, vol, out, m, nx, ny, nz, ox, oy, oz, fov, cnt,
                         batch, vstride);
  else
    launch_pull_batch<1>(s, vol, out, m, nx, ny, nz, ox, oy, oz, fov, cnt,
                         batch, vstride);
  return (int)cudaGetLastError();
}

int unires_push_batch(const float* vals, float* out, const float* plan,
                      const float* fov, int sx, int sy, int sz, int tx,
                      int ty, int tz, int wx, int wy, int wz, int order,
                      int batch, long long vstride, unsigned long long* cnt,
                      void* stream) {
  if ((long long)tx * ty * tz * batch == 0) return (int)cudaGetLastError();
  return launch_push((cudaStream_t)stream, vals, out, plan, fov, sx, sy, sz,
                     tx, ty, tz, wx, wy, wz, order, cnt, batch, vstride);
}

int unires_pull_grad_batch(const float* vol, float* out, const float* m,
                           int nx, int ny, int nz, int ox, int oy, int oz,
                           int batch, long long vstride,
                           unsigned long long* cnt, void* stream) {
  if ((long long)ox * oy * oz * batch == 0) return (int)cudaGetLastError();
  const dim3 block(kGradLanesZ, kGradRowsY);
  const dim3 grid((unsigned)((oz + kGradLanesZ - 1) / kGradLanesZ),
                  (unsigned)((oy + kGradRowsY - 1) / kGradRowsY),
                  (unsigned)((ox + kRowsX - 1) / kRowsX));
  pull_grad_batch_kernel<kGradLanesZ, kGradRowsY, kRowsX>
      <<<grid, block, 0, (cudaStream_t)stream>>>(vol, out, m, nx, ny, nz, ox,
                                                 oy, oz, cnt, batch, vstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
