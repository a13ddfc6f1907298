// Trilinear / nearest pull, its exact adjoint (push) and its derivative with
// respect to the sample point (pull_grad) for Hopper (sm_90a).
//
// Semantics (the XLA oracles of unires_tpu/ops/resample.py state them plainly):
//   pull  out[o] = sum_corners w(o, v) * vol[v],  g(o) = M . (i, j, k, 1)
//         zero bound (out-of-range corners weigh 0); outputs whose sample
//         point lies outside [-0.5, n - 0.5]^3 are exactly 0.
//   push  out[v] = sum_o w(o, v) * vals[o]        (push = pull^T)
//   pull_grad  out[o, d] = d pull(o) / d g_d(o)   (trilinear; same bound/FOV)
// M and Minv are (3,4) float32 maps passed by value, the CUDA counterpart of
// the Pallas kernels' scalar prefetch. Volumes are float32, C order (X, Y, Z).
//
// Plain C interface (one function per kernel, returning cudaGetLastError()),
// loaded with ctypes by unires_torch/ops/cuda_build.py. Each kernel launches on
// the caller's stream, never synchronises and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct Map34 {
  float m[12];  // row-major (3, 4)
};

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
__device__ __forceinline__ bool in_fov(const float g[3], int nx, int ny,
                                       int nz) {
  return g[0] >= -0.5f && g[0] <= (float)nx - 0.5f &&
         g[1] >= -0.5f && g[1] <= (float)ny - 0.5f &&
         g[2] >= -0.5f && g[2] <= (float)nz - 0.5f;
}

__device__ __forceinline__ float madd(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

// ---------------------------------------------------------------------------
// pull
//
// Replaces the Pallas kernels _pull_shear_kernel (pallas_resample.py:423, via
// pallas_pull_shear) and _pull_kernel (pallas_resample.py:219, via
// pallas_pull) of unires_tpu/ops/pallas_resample.py. Their shear pre-pass,
// window plans and DMA covers exist because a TPU has no fast gather; the
// card has one, so this kernel needs no plan.
//
// Bound: a gather. Each output voxel reads 8 neighbouring input voxels and
// writes one, so the kernel is limited by device-memory bandwidth and by how
// often the corner reads hit L1/L2. Design: one thread per output voxel,
// consecutive threads along the last (Z) axis, so stores coalesce and the
// corner reads of a warp fall on a few neighbouring input rows (the maps of
// this pipeline are near-identity in their linear part); the read-only path
// (__ldg) serves the corners. The sample grid is computed from the thread
// index and never stored.
// ---------------------------------------------------------------------------
template <int ORDER>
__global__ void pull_kernel(const float* __restrict__ vol,
                            float* __restrict__ out, Map34 M, int nx, int ny,
                            int nz, int ox, int oy, int oz) {
  const int n_out = ox * oy * oz;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int k = t % oz;
  const int r = t / oz;
  const int j = r % oy;
  const int i = r / oy;
  float g[3];
  map_point(M, (float)i, (float)j, (float)k, g);
  float acc = 0.0f;
  if (in_fov(g, nx, ny, nz)) {
    if (ORDER == 0) {
      const int a = (int)floorf(g[0] + 0.5f);
      const int b = (int)floorf(g[1] + 0.5f);
      const int c = (int)floorf(g[2] + 0.5f);
      if (a >= 0 && a < nx && b >= 0 && b < ny && c >= 0 && c < nz)
        acc = __ldg(vol + (a * ny + b) * nz + c);
    } else {
      const float fa = floorf(g[0]), fb = floorf(g[1]), fc = floorf(g[2]);
      const int a0 = (int)fa, b0 = (int)fb, c0 = (int)fc;
      const float f0 = __fsub_rn(g[0], fa);
      const float f1 = __fsub_rn(g[1], fb);
      const float f2 = __fsub_rn(g[2], fc);
#pragma unroll
      for (int da = 0; da < 2; ++da) {
        const int a = a0 + da;
        if (a < 0 || a >= nx) continue;
        const float wa = da ? f0 : __fsub_rn(1.0f, f0);
#pragma unroll
        for (int db = 0; db < 2; ++db) {
          const int b = b0 + db;
          if (b < 0 || b >= ny) continue;
          const float wab = __fmul_rn(wa, db ? f1 : __fsub_rn(1.0f, f1));
#pragma unroll
          for (int dc = 0; dc < 2; ++dc) {
            const int c = c0 + dc;
            if (c < 0 || c >= nz) continue;
            const float w = __fmul_rn(wab, dc ? f2 : __fsub_rn(1.0f, f2));
            acc = madd(acc, w, __ldg(vol + (a * ny + b) * nz + c));
          }
        }
      }
    }
  }
  out[t] = acc;
}

// ---------------------------------------------------------------------------
// push
//
// Replaces the Pallas kernels _push_shear_kernel (pallas_resample.py:782, via
// pallas_push_shear), _push_kernel (pallas_resample.py:673, via pallas_push)
// and their FOV premask _fov_premask (pallas_resample.py:1235).
//
// The gather form of the adjoint, as _push_gather (unires_tpu/ops/
// resample.py:151-207): one thread per TARGET voxel v. It anchors at
// round(Minv . v), visits the (2w+1)^3 candidate sources o of the window
// (w from the L1 row norms of Minv, computed on the host), recomputes pull's
// sample point g(o) with the same map_axis, and adds pull's weight of o onto v
// times vals[o]. No atomics: every output is written once by one thread, so a
// result is bitwise reproducible from run to run.
//
// Bound: a gather, like pull, but each target reads up to (2w+1)^3 sources
// (27 for the near-identity maps of this pipeline) of which at most 8 carry
// weight, so it also spends integer and float work on the candidates it
// rejects. Design: candidates outside the source grid or the FOV are skipped
// before any load, loads happen only for nonzero weights, and consecutive
// threads run along Z so that their candidate reads overlap in L1.
// ---------------------------------------------------------------------------
template <int ORDER>
__global__ void push_kernel(const float* __restrict__ vals,
                            float* __restrict__ out, Map34 M, Map34 Minv,
                            int sx, int sy, int sz, int tx, int ty, int tz,
                            int wx, int wy, int wz) {
  const int n_out = tx * ty * tz;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int vk = t % tz;
  const int r = t / tz;
  const int vj = r % ty;
  const int vi = r / ty;
  float c[3];
  map_point(Minv, (float)vi, (float)vj, (float)vk, c);
  int anc[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)  // clamp before the cast: far anchors have no
    anc[d] = (int)fminf(fmaxf(floorf(c[d] + 0.5f), -1048576.0f), 1048576.0f);
  const int v[3] = {vi, vj, vk};
  float acc = 0.0f;
  for (int da = -wx; da <= wx; ++da) {
    const int oa = anc[0] + da;
    if (oa < 0 || oa >= sx) continue;
    for (int db = -wy; db <= wy; ++db) {
      const int ob = anc[1] + db;
      if (ob < 0 || ob >= sy) continue;
      for (int dc = -wz; dc <= wz; ++dc) {
        const int oc = anc[2] + dc;
        if (oc < 0 || oc >= sz) continue;
        float g[3];
        map_point(M, (float)oa, (float)ob, (float)oc, g);
        if (!in_fov(g, tx, ty, tz)) continue;
        float w = 1.0f;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          if (ORDER == 0) {
            const int nd = (int)floorf(g[d] + 0.5f);
            if (nd != v[d]) w = 0.0f;
          } else {
            const float fl = floorf(g[d]);
            const float f = __fsub_rn(g[d], fl);
            const int ai = (int)fl;
            const float wd = (v[d] == ai) ? __fsub_rn(1.0f, f)
                             : (v[d] == ai + 1) ? f : 0.0f;
            w = __fmul_rn(w, wd);
          }
        }
        if (w != 0.0f)
          acc = madd(acc, w, __ldg(vals + (oa * sy + ob) * sz + oc));
      }
    }
  }
  out[t] = acc;
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
// and outputs whose sample point lies outside the FOV are 0. Each product and
// sum is rounded in the plain version's order (((s * w) * w) * v, summed over
// a, b, c in loop order) with the _rn intrinsics, and the sample point comes
// from the same map_axis as pull, so kernel and plain version agree to the
// bit.
//
// Bound: a gather like pull (8 corner reads) with three times the stores:
// the output is (ox, oy, oz, 3) in C order, the JAX layout, written directly
// (thread t stores floats 3t .. 3t+2, so a warp stores 96 contiguous floats).
// Design: pull's, one thread per output voxel along Z; no shared memory.
// ---------------------------------------------------------------------------
__global__ void pull_grad_kernel(const float* __restrict__ vol,
                                 float* __restrict__ out, Map34 M, int nx,
                                 int ny, int nz, int ox, int oy, int oz) {
  const int n_out = ox * oy * oz;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_out) return;
  const int k = t % oz;
  const int r = t / oz;
  const int j = r % oy;
  const int i = r / oy;
  float g[3];
  map_point(M, (float)i, (float)j, (float)k, g);
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (in_fov(g, nx, ny, nz)) {
    const float fa = floorf(g[0]), fb = floorf(g[1]), fc = floorf(g[2]);
    const int a0 = (int)fa, b0 = (int)fb, c0 = (int)fc;
    const float f0 = __fsub_rn(g[0], fa);
    const float f1 = __fsub_rn(g[1], fb);
    const float f2 = __fsub_rn(g[2], fc);
#pragma unroll
    for (int da = 0; da < 2; ++da) {
      const int a = a0 + da;
      if (a < 0 || a >= nx) continue;
      const float wa = da ? f0 : __fsub_rn(1.0f, f0);
      const float sa = da ? 1.0f : -1.0f;
#pragma unroll
      for (int db = 0; db < 2; ++db) {
        const int b = b0 + db;
        if (b < 0 || b >= ny) continue;
        const float wb = db ? f1 : __fsub_rn(1.0f, f1);
        const float sb = db ? 1.0f : -1.0f;
#pragma unroll
        for (int dc = 0; dc < 2; ++dc) {
          const int c = c0 + dc;
          if (c < 0 || c >= nz) continue;
          const float wc = dc ? f2 : __fsub_rn(1.0f, f2);
          const float sc = dc ? 1.0f : -1.0f;
          const float v = __ldg(vol + (a * ny + b) * nz + c);
          gx = madd(gx, __fmul_rn(__fmul_rn(sa, wb), wc), v);
          gy = madd(gy, __fmul_rn(__fmul_rn(wa, sb), wc), v);
          gz = madd(gz, __fmul_rn(__fmul_rn(wa, wb), sc), v);
        }
      }
    }
  }
  float* o = out + 3 * (long long)t;
  o[0] = gx;
  o[1] = gy;
  o[2] = gz;
}

constexpr int kThreads = 256;

inline Map34 load_map(const float* m) {
  Map34 M;
  for (int q = 0; q < 12; ++q) M.m[q] = m[q];
  return M;
}

inline unsigned int n_blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// vol (nx, ny, nz) -> out (ox, oy, oz); m: host pointer to 12 floats.
int unires_pull(const float* vol, float* out, const float* m, int nx, int ny,
                int nz, int ox, int oy, int oz, int order, void* stream) {
  const Map34 M = load_map(m);
  const long long n = (long long)ox * oy * oz;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    pull_kernel<0><<<n_blocks(n), kThreads, 0, s>>>(vol, out, M, nx, ny, nz,
                                                    ox, oy, oz);
  else
    pull_kernel<1><<<n_blocks(n), kThreads, 0, s>>>(vol, out, M, nx, ny, nz,
                                                    ox, oy, oz);
  return (int)cudaGetLastError();
}

// vals (sx, sy, sz) on pull's output grid -> out (tx, ty, tz) on pull's
// input grid; m, minv: host pointers to 12 floats; (wx, wy, wz): window.
int unires_push(const float* vals, float* out, const float* m,
                const float* minv, int sx, int sy, int sz, int tx, int ty,
                int tz, int wx, int wy, int wz, int order, void* stream) {
  const Map34 M = load_map(m);
  const Map34 Minv = load_map(minv);
  const long long n = (long long)tx * ty * tz;
  if (n == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    push_kernel<0><<<n_blocks(n), kThreads, 0, s>>>(
        vals, out, M, Minv, sx, sy, sz, tx, ty, tz, wx, wy, wz);
  else
    push_kernel<1><<<n_blocks(n), kThreads, 0, s>>>(
        vals, out, M, Minv, sx, sy, sz, tx, ty, tz, wx, wy, wz);
  return (int)cudaGetLastError();
}

// vol (nx, ny, nz) -> out (ox, oy, oz, 3); m: host pointer to 12 floats.
int unires_pull_grad(const float* vol, float* out, const float* m, int nx,
                     int ny, int nz, int ox, int oy, int oz, void* stream) {
  const Map34 M = load_map(m);
  const long long n = (long long)ox * oy * oz;
  if (n == 0) return (int)cudaGetLastError();
  pull_grad_kernel<<<n_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      vol, out, M, nx, ny, nz, ox, oy, oz);
  return (int)cudaGetLastError();
}

}  // extern "C"
