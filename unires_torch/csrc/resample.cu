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

// pull and push: a block is kLanesZ lanes along z times kRowsY rows along
// y, so a warp covers 8 (z) x 4 (y) outputs; see push_kernel for why
constexpr int kLanesZ = 8;
constexpr int kRowsY = 16;
// pull and pull_grad: output rows along x a thread computes (i and i + 1)
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
// count): thread 0 of block 0 only.
template <bool FOV>
__device__ __forceinline__ void count_launch(unsigned long long* cnt) {
  if (cnt != nullptr && (blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x |
                         threadIdx.y) == 0) {
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
// (the map, floors, 12 weight products, 8 multiply-adds, about 60 float
// operations per output) plus the gather's addressing.
//
// Design: the fewest instructions around that arithmetic. The launch grid
// is (z / kLanesZ, y / kRowsY, x / kRowsX), so no index is split at run
// time; a warp covers 8 (z) x 4 (y) outputs (stores in 32-byte sectors, and
// its corner reads fall on a few input rows, served by L1). A thread
// computes the outputs of rows i and i + 1, whose corner planes overlap in
// L1, and reads their corners through gather_corners (an interior fast
// path without bound tests). Staging each tile's input box in shared memory
// (the TPU kernel's VMEM window) measured slower at every tile size tried,
// L1 already serving the overlap (scripts/cuda_staged_variants.py reruns
// it). The fov override is the instantiation FOV = true, which tests every
// sample point against the caller's bounds (gather_corners); the default
// instantiation is the kernel without it, instruction for instruction.
//
// The batched launch (pull_batch_kernel) covers B volumes with one volume's
// launch grid: each thread computes its output position in volume 0, 1, ...
// in turn, volume b at vol + b * vstride, its map at mp + 12 b and its
// output at out + b * ox * oy * oz. Each output is computed by the same tile
// code (pull_tile) as in the unbatched launch, so the two agree to the bit;
// the unbatched kernel is the old one, instruction for instruction. Folding
// the batch into the grid's z instead (a block index split by a division)
// measured slower, with the volumes slowest or fastest
// (scripts/cuda_batch_variants.py reruns both).
// ---------------------------------------------------------------------------
template <int ORDER, bool FOV>
__device__ __forceinline__ void pull_tile(const float* __restrict__ vol,
                                          float* __restrict__ out,
                                          const float* __restrict__ mp,
                                          int nx, int ny, int nz, int ox,
                                          int oy, int oz, const Box& fov,
                                          int zb) {
  const Map34 M = load_map_dev(mp);
  const int j = blockIdx.y * kRowsY + threadIdx.y;
  const int k = blockIdx.x * kLanesZ + threadIdx.x;
  if (j >= oy || k >= oz) return;
  const int i0 = zb * kRowsX;
  float g[kRowsX][3];
#pragma unroll
  for (int q = 0; q < kRowsX; ++q)
    map_point(M, (float)min(i0 + q, ox - 1), (float)j, (float)k, g[q]);
  float res[kRowsX];
  if (ORDER == 0) {
#pragma unroll
    for (int q = 0; q < kRowsX; ++q) {
      const int a = clamp_far(floorf(g[q][0] + 0.5f));
      const int b = clamp_far(floorf(g[q][1] + 0.5f));
      const int c = clamp_far(floorf(g[q][2] + 0.5f));
      const bool ok = inside<FOV>(g[q], nx, ny, nz, fov) & (a >= 0) &
                      (a < nx) & (b >= 0) & (b < ny) & (c >= 0) & (c < nz);
      res[q] = ok ? __ldg(vol + (a * ny + b) * nz + c) : 0.0f;
    }
  } else {
    float fl[kRowsX][3], v[kRowsX][8];
    bool keep[kRowsX];
    gather_corners<kRowsX, FOV>(vol, g, nx, ny, nz, fl, v, keep, fov);
#pragma unroll
    for (int q = 0; q < kRowsX; ++q) {
      const float f0 = __fsub_rn(g[q][0], fl[q][0]);
      const float f1 = __fsub_rn(g[q][1], fl[q][1]);
      const float f2 = __fsub_rn(g[q][2], fl[q][2]);
      const float wa[2] = {__fsub_rn(1.0f, f0), f0};
      const float wb[2] = {__fsub_rn(1.0f, f1), f1};
      const float wc[2] = {__fsub_rn(1.0f, f2), f2};
      // the plain version's corner order: a, then b, then c
      float s = 0.0f;
#pragma unroll
      for (int da = 0; da < 2; ++da)
#pragma unroll
        for (int db = 0; db < 2; ++db) {
          const float wab = __fmul_rn(wa[da], wb[db]);
#pragma unroll
          for (int dc = 0; dc < 2; ++dc)
            s = madd(s, __fmul_rn(wab, wc[dc]), v[q][4 * da + 2 * db + dc]);
        }
      res[q] = keep[q] ? s : 0.0f;
    }
  }
#pragma unroll
  for (int q = 0; q < kRowsX; ++q)
    if (i0 + q < ox) out[((long long)(i0 + q) * oy + j) * oz + k] = res[q];
}

template <int ORDER, bool FOV>
__global__ void __launch_bounds__(kLanesZ * kRowsY)
    pull_kernel(const float* __restrict__ vol, float* __restrict__ out,
                const float* __restrict__ mp, int nx, int ny, int nz, int ox,
                int oy, int oz, Box fov, unsigned long long* cnt) {
  count_launch<FOV>(cnt);
  pull_tile<ORDER, FOV>(vol, out, mp, nx, ny, nz, ox, oy, oz, fov,
                        blockIdx.z);
}

template <int ORDER, bool FOV>
__global__ void __launch_bounds__(kLanesZ * kRowsY)
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
// each: 17 us at the fit's shapes on an H100), in practice the issue rate:
// every (source, target) pair with a weight costs the map, three floors and
// the weight products, and a near-identity map has ~8 such pairs per target.
//
// Design: only sources that can weigh on v are visited. A weight needs
// |M o + m - v|_inf < 1 (1/2 at order 0), so |o - Minv v|_d <= reach_d, the
// L1 norm of Minv's row d plus rounding margins (ops/resample.py:
// push_reach). Per axis the candidates are [ceil(c - reach), floor(c +
// reach)] cut to the window and the grid: 2 values, rarely 3, at the fit's
// maps (8.6 candidates per target where the window has 27). They are
// visited in the window's (da, db, dc) order, and a skipped candidate weighs
// 0, so the sum is bitwise push_plain's. The partial sums M[d,0] oa and
// M[d,0] oa + M[d,1] ob are computed once per candidate x and (x, y) row
// (the plain version rounds left to right, so the bits are the same). The
// candidate count of a target depends on where Minv v falls between the
// integers; a warp runs as many iterations as its most demanding lane, so
// a warp covers 8 (z) x 4 (y) targets, whose Minv v drift less than along 32
// z (9.8 instead of 12.5 iterations for 8.6 candidates on average at the
// fit's map). Interior targets skip the FOV test (their weighted sources lie
// inside it), and every candidate adds w * vals[o], 0 where it weighs
// nothing. Staging a source box per target tile in shared memory, each
// source's floors and fractions computed once, measured slower at every
// tile size tried (scripts/cuda_staged_variants.py). With the fov override
// (FOV = true) the bounds need not enclose the target grid, so every
// candidate of every target is tested against them; the default
// instantiation is the kernel without it, instruction for instruction.
//
// The batched launch (push_batch_kernel) covers B volumes with one volume's
// launch grid as pull's: the sources of volume b at vals + b * vstride, its
// plan at plan + 32 b, its output at out + b * tx * ty * tz, each target
// computed by the same code (push_target) as unbatched.
// ---------------------------------------------------------------------------
template <int ORDER, bool FOV>
__device__ __forceinline__ void push_target(const float* __restrict__ vals,
                                            float* __restrict__ out,
                                            const float* __restrict__ plan,
                                            int sx, int sy, int sz, int tx,
                                            int ty, int tz, int wx, int wy,
                                            int wz, const Box& fov, int vi) {
  const int vk = blockIdx.x * kLanesZ + threadIdx.x;
  const int vj = blockIdx.y * kRowsY + threadIdx.y;
  if (vk >= tz || vj >= ty) return;
  // the plan (ops/resample.py: push_plan): M, Minv, reach (3), window (3)
  const Map34 M = load_map_dev(plan);
  const Map34 Minv = load_map_dev(plan + 12);
  const float4 p0 = __ldg(reinterpret_cast<const float4*>(plan + 24));
  const float4 p1 = __ldg(reinterpret_cast<const float4*>(plan + 28));
  float c[3];
  map_point(Minv, (float)vi, (float)vj, (float)vk, c);
  const float r[3] = {p0.x, p0.y, p0.z};
  // a window given by the caller (>= 0) or the plan's
  const int w[3] = {wx >= 0 ? wx : (int)p0.w, wy >= 0 ? wy : (int)p1.x,
                    wz >= 0 ? wz : (int)p1.y};
  const int s[3] = {sx, sy, sz};
  int lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int anc = clamp_far(floorf(c[d] + 0.5f));
    lo[d] = max(max(clamp_far(ceilf(c[d] - r[d])), anc - w[d]), 0);
    hi[d] = min(min(clamp_far(floorf(c[d] + r[d])), anc + w[d]), s[d] - 1);
  }
  const int v[3] = {vi, vj, vk};
  // a weighted source of an interior target lies inside the default FOV
  const bool edge = FOV | (vi < 1) | (vi > tx - 2) | (vj < 1) |
                    (vj > ty - 2) | (vk < 1) | (vk > tz - 2);
  float acc = 0.0f;
  for (int oa = lo[0]; oa <= hi[0]; ++oa) {
    float pa[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) pa[d] = __fmul_rn(M.m[4 * d], (float)oa);
    for (int ob = lo[1]; ob <= hi[1]; ++ob) {
      float s01[3];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s01[d] = __fadd_rn(pa[d], __fmul_rn(M.m[4 * d + 1], (float)ob));
      const float* row = vals + (oa * sy + ob) * sz;
      for (int oc = lo[2]; oc <= hi[2]; ++oc) {
        float g[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          g[d] = __fadd_rn(__fadd_rn(s01[d], __fmul_rn(M.m[4 * d + 2],
                                                       (float)oc)),
                           M.m[4 * d + 3]);
        if (edge && !inside<FOV>(g, tx, ty, tz, fov)) continue;
        float wt = 1.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          if (ORDER == 0) {
            if ((int)floorf(g[d] + 0.5f) != v[d]) wt = 0.0f;
          } else {
            const float fl = floorf(g[d]);
            const float f = __fsub_rn(g[d], fl);
            const int ai = (int)fl;
            const float wd = (v[d] == ai)       ? __fsub_rn(1.0f, f)
                             : (v[d] == ai + 1) ? f
                                                : 0.0f;
            wt = __fmul_rn(wt, wd);
          }
        }
        // w * vals[o] with w = 0 adds nothing, as in the plain version
        acc = madd(acc, wt, __ldg(row + oc));
      }
    }
  }
  out[((long long)vi * ty + vj) * tz + vk] = acc;
}

template <int ORDER, bool FOV>
__global__ void __launch_bounds__(kLanesZ * kRowsY)
    push_kernel(const float* __restrict__ vals, float* __restrict__ out,
                const float* __restrict__ plan, int sx, int sy, int sz,
                int tx, int ty, int tz, int wx, int wy, int wz, Box fov,
                unsigned long long* cnt) {
  count_launch<FOV>(cnt);
  push_target<ORDER, FOV>(vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy,
                          wz, fov, blockIdx.z);
}

template <int ORDER, bool FOV>
__global__ void __launch_bounds__(kLanesZ * kRowsY)
    push_batch_kernel(const float* __restrict__ vals, float* __restrict__ out,
                      const float* __restrict__ plan, int sx, int sy, int sz,
                      int tx, int ty, int tz, int wx, int wy, int wz, Box fov,
                      unsigned long long* cnt, int batch, long long vstride) {
  count_launch<FOV>(cnt);
  for (int b = 0; b < batch; ++b)
    push_target<ORDER, FOV>(vals + b * vstride,
                            out + b * ((long long)tx * ty * tz),
                            plan + 32 * b, sx, sy, sz, tx, ty, tz, wx, wy, wz,
                            fov, blockIdx.z);
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
void launch_pull(dim3 grid, dim3 block, cudaStream_t s, const float* vol,
                 float* out, const float* m, int nx, int ny, int nz, int ox,
                 int oy, int oz, const float* fov, unsigned long long* cnt) {
  if (fov)
    pull_kernel<ORDER, true><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, load_box(fov), cnt);
  else
    pull_kernel<ORDER, false><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, Box(), cnt);
}

template <int ORDER>
void launch_push(dim3 grid, dim3 block, cudaStream_t s, const float* vals,
                 float* out, const float* plan, int sx, int sy, int sz,
                 int tx, int ty, int tz, int wx, int wy, int wz,
                 const float* fov, unsigned long long* cnt) {
  if (fov)
    push_kernel<ORDER, true><<<grid, block, 0, s>>>(
        vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, load_box(fov),
        cnt);
  else
    push_kernel<ORDER, false><<<grid, block, 0, s>>>(
        vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, Box(), cnt);
}

template <int ORDER>
void launch_pull_batch(dim3 grid, dim3 block, cudaStream_t s,
                       const float* vol, float* out, const float* m, int nx,
                       int ny, int nz, int ox, int oy, int oz,
                       const float* fov, unsigned long long* cnt, int batch,
                       long long vstride) {
  if (fov)
    pull_batch_kernel<ORDER, true><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, load_box(fov), cnt, batch,
        vstride);
  else
    pull_batch_kernel<ORDER, false><<<grid, block, 0, s>>>(
        vol, out, m, nx, ny, nz, ox, oy, oz, Box(), cnt, batch, vstride);
}

template <int ORDER>
void launch_push_batch(dim3 grid, dim3 block, cudaStream_t s,
                       const float* vals, float* out, const float* plan,
                       int sx, int sy, int sz, int tx, int ty, int tz, int wx,
                       int wy, int wz, const float* fov,
                       unsigned long long* cnt, int batch, long long vstride) {
  if (fov)
    push_batch_kernel<ORDER, true><<<grid, block, 0, s>>>(
        vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, load_box(fov),
        cnt, batch, vstride);
  else
    push_batch_kernel<ORDER, false><<<grid, block, 0, s>>>(
        vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, Box(), cnt,
        batch, vstride);
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
  const dim3 block(kLanesZ, kRowsY);
  const dim3 grid((unsigned)((oz + kLanesZ - 1) / kLanesZ),
                  (unsigned)((oy + kRowsY - 1) / kRowsY),
                  (unsigned)((ox + kRowsX - 1) / kRowsX));
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    launch_pull<0>(grid, block, s, vol, out, m, nx, ny, nz, ox, oy, oz, fov,
                   cnt);
  else
    launch_pull<1>(grid, block, s, vol, out, m, nx, ny, nz, ox, oy, oz, fov,
                   cnt);
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
  const dim3 block(kLanesZ, kRowsY);
  const dim3 grid((unsigned)((tz + kLanesZ - 1) / kLanesZ),
                  (unsigned)((ty + kRowsY - 1) / kRowsY), (unsigned)tx);
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    launch_push<0>(grid, block, s, vals, out, plan, sx, sy, sz, tx, ty, tz,
                   wx, wy, wz, fov, cnt);
  else
    launch_push<1>(grid, block, s, vals, out, plan, sx, sy, sz, tx, ty, tz,
                   wx, wy, wz, fov, cnt);
  return (int)cudaGetLastError();
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
  const dim3 block(kLanesZ, kRowsY);
  const dim3 grid((unsigned)((oz + kLanesZ - 1) / kLanesZ),
                  (unsigned)((oy + kRowsY - 1) / kRowsY),
                  (unsigned)((ox + kRowsX - 1) / kRowsX));
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    launch_pull_batch<0>(grid, block, s, vol, out, m, nx, ny, nz, ox, oy, oz,
                         fov, cnt, batch, vstride);
  else
    launch_pull_batch<1>(grid, block, s, vol, out, m, nx, ny, nz, ox, oy, oz,
                         fov, cnt, batch, vstride);
  return (int)cudaGetLastError();
}

int unires_push_batch(const float* vals, float* out, const float* plan,
                      const float* fov, int sx, int sy, int sz, int tx,
                      int ty, int tz, int wx, int wy, int wz, int order,
                      int batch, long long vstride, unsigned long long* cnt,
                      void* stream) {
  if ((long long)tx * ty * tz * batch == 0) return (int)cudaGetLastError();
  const dim3 block(kLanesZ, kRowsY);
  const dim3 grid((unsigned)((tz + kLanesZ - 1) / kLanesZ),
                  (unsigned)((ty + kRowsY - 1) / kRowsY), (unsigned)tx);
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    launch_push_batch<0>(grid, block, s, vals, out, plan, sx, sy, sz, tx, ty,
                         tz, wx, wy, wz, fov, cnt, batch, vstride);
  else
    launch_push_batch<1>(grid, block, s, vals, out, plan, sx, sy, sz, tx, ty,
                         tz, wx, wy, wz, fov, cnt, batch, vstride);
  return (int)cudaGetLastError();
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
