// Shared-memory staged variants of the pull and push kernels, for the
// comparison in scripts/cuda_staged_variants.py. Not part of unires_torch:
// the port's kernels are the direct gathers of unires_torch/csrc/resample.cu,
// which measured faster than these at every tile tried (PERF.md, section 6).
//
// The design is the one the TPU kernels use with VMEM: a block owns a tile
// of outputs (pull) or targets (push), finds the box of inputs or sources it
// needs from the tile's 8 corners (the map is affine and floor / round are
// monotone, so the corners bound the box), stages the box in shared memory
// with coalesced loads, and gathers from there.
//   pull  stages the input values of the box; each output reads its 8
//         corners from shared memory. No slab walk: a box larger than the
//         plan's budget is refused (the host reports it).
//   push  computes each staged source's sample point once (the same
//         map_axis roundings as the port's kernels) and stores its floors,
//         as a target code, its fractions and its value; each target then
//         sums its candidates from shared memory in (oa, ob, oc) order. The
//         box is walked in slabs along x when it exceeds the budget.
// Both keep the plain versions' roundings and order, so they agree with
// pull_plain / push_plain to the bit.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream.
// plan: tile (tx, ty, tz), box (bx, by, bz), slab depth sd, shared bytes.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoTarget = 0x3fffffffu;
constexpr unsigned kCornerBits = 0x100401u;  // bit 0 of each 10-bit field
constexpr float kEps = 1.0f / 256.0f;  // box margin against the float map
constexpr float kFar = 1048576.0f;

struct Map34 {
  float m[12];
};

struct Plan {
  int tx, ty, tz, bx, by, bz, sd, smem;
};

// the port's map_axis, split into (x, y) and z parts: same roundings
__device__ __forceinline__ float row_axis(const Map34& M, int d, float x,
                                          float y) {
  const float* r = M.m + 4 * d;
  return __fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y));
}

__device__ __forceinline__ float row_finish(const Map34& M, int d, float s,
                                            float z) {
  const float* r = M.m + 4 * d;
  return __fadd_rn(__fadd_rn(s, __fmul_rn(r[2], z)), r[3]);
}

__device__ __forceinline__ void map_point(const Map34& M, float x, float y,
                                          float z, float g[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) g[d] = row_finish(M, d, row_axis(M, d, x, y), z);
}

__device__ __forceinline__ bool in_fov(const float g[3], int nx, int ny,
                                       int nz) {
  return g[0] >= -0.5f && g[0] <= (float)nx - 0.5f && g[1] >= -0.5f &&
         g[1] <= (float)ny - 0.5f && g[2] >= -0.5f && g[2] <= (float)nz - 0.5f;
}

__device__ __forceinline__ float madd(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

__device__ __forceinline__ int clamp_far(float x) {
  return (int)fminf(fmaxf(x, -kFar), kFar);
}

// min and max over the 8 lanes of a group (the tile's corners)
__device__ __forceinline__ void minmax8(int& lo, int& hi) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    lo = min(lo, __shfl_xor_sync(kFull, lo, off));
    hi = max(hi, __shfl_xor_sync(kFull, hi, off));
  }
}

__device__ __forceinline__ void tile_corner(int c, const int o[3],
                                            const int n[3], float p[3]) {
  p[0] = (float)(o[0] + ((c >> 2) & 1) * (n[0] - 1));
  p[1] = (float)(o[1] + ((c >> 1) & 1) * (n[1] - 1));
  p[2] = (float)(o[2] + (c & 1) * (n[2] - 1));
}

// pull (trilinear): tile (tx, ty, 32 * QZ), lanes along z, a warp per row
template <int QZ, int MAXR>
__global__ void __launch_bounds__(kThreads)
    pull_staged(const float* __restrict__ vol, float* __restrict__ out,
                Map34 M, Plan P, int nx, int ny, int nz, int ox, int oy,
                int oz) {
  extern __shared__ float box[];
  __shared__ int s_box[6];
  const int o[3] = {(int)blockIdx.z * P.tx, (int)blockIdx.y * P.ty,
                    (int)blockIdx.x * P.tz};
  const int n[3] = {min(P.tx, ox - o[0]), min(P.ty, oy - o[1]),
                    min(P.tz, oz - o[2])};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 0) {
    float p[3], g[3];
    tile_corner(lane & 7, o, n, p);
    map_point(M, p[0], p[1], p[2], g);
    const int bmax[3] = {P.bx, P.by, P.bz};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      int lo = clamp_far(floorf(g[d] - kEps));
      int hi = clamp_far(floorf(g[d] + kEps)) + 1;
      minmax8(lo, hi);
      if (lane == 0) {
        s_box[d] = lo;
        s_box[3 + d] = min(hi, lo + bmax[d] - 1);
      }
    }
  }
  __syncthreads();
  const int lx = s_box[0], ly = s_box[1], lz = s_box[2];
  const int ey = s_box[4] - ly + 1, ez = s_box[5] - lz + 1;
  const int rows = (s_box[3] - lx + 1) * ey;
  // stage the box, zero outside the volume (the zero bound)
  for (int r = warp; r < rows; r += kWarps) {
    const int a = r / ey, b = r - a * ey;
    const int xa = lx + a, yb = ly + b;
    const bool row_in = xa >= 0 && xa < nx && yb >= 0 && yb < ny;
    const float* src = vol + (row_in ? xa * ny + yb : 0) * nz;
    float* dst = box + (a * P.by + b) * P.bz;
    for (int c = lane; c < ez; c += 32) {
      const int zc = lz + c;
      dst[c] = (row_in && zc >= 0 && zc < nz) ? __ldg(src + zc) : 0.0f;
    }
  }
  __syncthreads();
  const int sy = P.bz, sx = P.by * P.bz;
#pragma unroll
  for (int q = 0; q < MAXR; ++q) {
    const int r = warp + kWarps * q;
    if (r >= n[0] * n[1]) break;
    const int i = o[0] + r / n[1], j = o[1] + r % n[1];
    float s01[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) s01[d] = row_axis(M, d, (float)i, (float)j);
    float* orow = out + ((long long)i * oy + j) * oz;
    float g[QZ][3], v[QZ][8];
    int kk[QZ];
#pragma unroll
    for (int u = 0; u < QZ; ++u) {
      kk[u] = o[2] + min(lane + 32 * u, n[2] - 1);
#pragma unroll
      for (int d = 0; d < 3; ++d)
        g[u][d] = row_finish(M, d, s01[d], (float)kk[u]);
      const int a0 = clamp_far(floorf(g[u][0])),
                b0 = clamp_far(floorf(g[u][1])),
                c0 = clamp_far(floorf(g[u][2]));
      const float* p = box + (a0 - lx) * sx + (b0 - ly) * sy + (c0 - lz);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[u][e] = p[((e >> 2) & 1) * sx + ((e >> 1) & 1) * sy + (e & 1)];
    }
#pragma unroll
    for (int u = 0; u < QZ; ++u) {
      const float fa = floorf(g[u][0]), fb = floorf(g[u][1]),
                  fc = floorf(g[u][2]);
      const float f0 = __fsub_rn(g[u][0], fa), f1 = __fsub_rn(g[u][1], fb),
                  f2 = __fsub_rn(g[u][2], fc);
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
            s = madd(s, __fmul_rn(wab, wc[dc]), v[u][4 * da + 2 * db + dc]);
        }
      if (lane + 32 * u < n[2])
        orow[kk[u]] = in_fov(g[u], nx, ny, nz) ? s : 0.0f;
    }
  }
}

// push: tile (tx, ty, <= 32) of targets, lanes along z, a warp per row
template <int ORDER, int MAXR>
__global__ void __launch_bounds__(kThreads)
    push_staged(const float* __restrict__ vals, float* __restrict__ out,
                Map34 M, Map34 Minv, float r0, float r1, float r2, Plan P,
                int sx, int sy, int sz, int tx, int ty, int tz, int wx,
                int wy, int wz) {
  extern __shared__ float smem[];
  __shared__ int s_box[6];
  const int S = P.sd * P.by * P.bz;
  unsigned* s_code = reinterpret_cast<unsigned*>(smem);
  float* s_f0 = smem + S;
  float* s_f1 = smem + 2 * S;
  float* s_f2 = smem + 3 * S;
  float* s_val = smem + 4 * S;
  const int t0[3] = {(int)blockIdx.z * P.tx, (int)blockIdx.y * P.ty,
                     (int)blockIdx.x * P.tz};
  const int n[3] = {min(P.tx, tx - t0[0]), min(P.ty, ty - t0[1]),
                    min(P.tz, tz - t0[2])};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float r[3] = {r0, r1, r2};
  const int w[3] = {wx, wy, wz};
  if (warp == 0) {
    const int sdim[3] = {sx, sy, sz}, bmax[3] = {P.bx, P.by, P.bz};
    float p[3], c[3];
    tile_corner(lane & 7, t0, n, p);
    map_point(Minv, p[0], p[1], p[2], c);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      int lo = clamp_far(ceilf(c[d] - r[d] - kEps));
      int hi = clamp_far(floorf(c[d] + r[d] + kEps));
      minmax8(lo, hi);
      if (lane == 0) {
        lo = max(lo, 0);
        s_box[d] = lo;
        s_box[3 + d] = min(min(hi, sdim[d] - 1), lo + bmax[d] - 1);
      }
    }
  }
  __syncthreads();
  const int lx = s_box[0], ly = s_box[1], lz = s_box[2];
  const int hx = s_box[3], hy = s_box[4], hz = s_box[5];
  const int ey = hy - ly + 1, ez = hz - lz + 1;
  const int nrows = n[0] * n[1];
  float acc[MAXR];
#pragma unroll
  for (int q = 0; q < MAXR; ++q) acc[q] = 0.0f;
  for (int x0 = lx; x0 <= hx; x0 += P.sd) {
    const int x1 = min(x0 + P.sd - 1, hx);
    const int rows = (x1 - x0 + 1) * ey;
    // each source of the slab once: its target code (floors relative to
    // the tile, kNoTarget outside the FOV or the tile), fractions, value
    for (int rr = warp; rr < rows; rr += kWarps) {
      const int a = rr / ey, b = rr - a * ey;
      float s01[3];
#pragma unroll
      for (int d = 0; d < 3; ++d)
        s01[d] = row_axis(M, d, (float)(x0 + a), (float)(ly + b));
      const float* src = vals + ((x0 + a) * sy + (ly + b)) * sz;
      const int row = (a * P.by + b) * P.bz;
      for (int cz = lane; cz < ez; cz += 32) {
        const int oc = lz + cz;
        const float val = __ldg(src + oc);
        float g[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) g[d] = row_finish(M, d, s01[d], (float)oc);
        unsigned code = kNoTarget;
        float f[3] = {0.0f, 0.0f, 0.0f};
        if (in_fov(g, tx, ty, tz)) {
          bool hit = true;
          unsigned packed = 0u;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            int rel;
            if (ORDER == 0) {
              rel = (int)floorf(g[d] + 0.5f) - t0[d];
              hit = hit && rel >= 0 && rel < n[d];
            } else {
              const float fl = floorf(g[d]);
              f[d] = __fsub_rn(g[d], fl);
              rel = (int)fl - t0[d];
              hit = hit && rel >= -1 && rel < n[d];
            }
            packed |= (unsigned)(rel + 1) << (10 * d);
          }
          if (hit) code = packed;
        }
        s_code[row + cz] = code;
        s_f0[row + cz] = f[0];
        s_f1[row + cz] = f[1];
        s_f2[row + cz] = f[2];
        s_val[row + cz] = val;
      }
    }
    __syncthreads();
    const int blo[3] = {x0, ly, lz}, bhi[3] = {x1, hy, hz};
#pragma unroll
    for (int q = 0; q < MAXR; ++q) {
      const int rr = warp + kWarps * q;
      if (rr >= nrows) break;
      if (lane >= n[2]) continue;
      const int a = rr / n[1], b = rr - a * n[1];
      const int v[3] = {t0[0] + a, t0[1] + b, t0[2] + lane};
      float c[3];
      map_point(Minv, (float)v[0], (float)v[1], (float)v[2], c);
      int lo[3], hi[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int anc = clamp_far(floorf(c[d] + 0.5f));
        lo[d] = max(max(clamp_far(ceilf(c[d] - r[d])), anc - w[d]), blo[d]);
        hi[d] = min(min(clamp_far(floorf(c[d] + r[d])), anc + w[d]), bhi[d]);
      }
      // a source weighs on v where v - floor(g) is 0 or 1 on every axis
      const unsigned tcode = (unsigned)(a + 1) | ((unsigned)(b + 1) << 10) |
                             ((unsigned)(lane + 1) << 20);
      float sum = acc[q];
      for (int oa = lo[0]; oa <= hi[0]; ++oa)
        for (int ob = lo[1]; ob <= hi[1]; ++ob) {
          const int base = ((oa - x0) * P.by + (ob - ly)) * P.bz - lz;
          for (int oc = lo[2]; oc <= hi[2]; ++oc) {
            const int idx = base + oc;
            const unsigned diff = tcode - s_code[idx];
            if (ORDER == 0) {
              if (diff == 0u) sum = madd(sum, 1.0f, s_val[idx]);
            } else if ((diff & ~kCornerBits) == 0u) {
              const float f0 = s_f0[idx], f1 = s_f1[idx], f2 = s_f2[idx];
              const float w0 = (diff & 1u) ? f0 : __fsub_rn(1.0f, f0);
              const float w1 = (diff & 0x400u) ? f1 : __fsub_rn(1.0f, f1);
              const float w2 = (diff & 0x100000u) ? f2 : __fsub_rn(1.0f, f2);
              sum = madd(sum, __fmul_rn(__fmul_rn(w0, w1), w2), s_val[idx]);
            }
          }
        }
      acc[q] = sum;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < MAXR; ++q) {
    const int rr = warp + kWarps * q;
    if (rr >= nrows) break;
    if (lane >= n[2]) continue;
    const int a = rr / n[1], b = rr - a * n[1];
    out[((long long)(t0[0] + a) * ty + (t0[1] + b)) * tz + (t0[2] + lane)] =
        acc[q];
  }
}

inline Map34 load_map(const float* m) {
  Map34 M;
  for (int q = 0; q < 12; ++q) M.m[q] = m[q];
  return M;
}

inline Plan load_plan(const int* p) {
  return Plan{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

template <typename Kernel, typename... Args>
int launch_tiled(Kernel kernel, const Plan& P, dim3 grid, cudaStream_t s,
                 Args... args) {
  if (P.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P.smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, P.smem, s>>>(args...);
  return (int)cudaGetLastError();
}

inline dim3 tile_grid(const Plan& P, int x, int y, int z) {
  return dim3((unsigned)((z + P.tz - 1) / P.tz),
              (unsigned)((y + P.ty - 1) / P.ty),
              (unsigned)((x + P.tx - 1) / P.tx));
}

}  // namespace

extern "C" {

// trilinear pull, vol (nx, ny, nz) -> out (ox, oy, oz); tile rows tx * ty
// <= 64, tz 32 or 64. Returns -1 for a plan it cannot run.
int staged_pull(const float* vol, float* out, const float* m, int nx, int ny,
                int nz, int ox, int oy, int oz, const int* plan,
                void* stream) {
  const Map34 M = load_map(m);
  const Plan P = load_plan(plan);
  if (P.tx * P.ty > 64 || (P.tz != 32 && P.tz != 64)) return -1;
  const dim3 grid = tile_grid(P, ox, oy, oz);
  cudaStream_t s = (cudaStream_t)stream;
  if (P.tz == 64)
    return launch_tiled(pull_staged<2, 8>, P, grid, s, vol, out, M, P, nx, ny,
                        nz, ox, oy, oz);
  return launch_tiled(pull_staged<1, 8>, P, grid, s, vol, out, M, P, nx, ny,
                      nz, ox, oy, oz);
}

// push, vals (sx, sy, sz) -> out (tx, ty, tz), the arguments of the port's
// unires_push plus the plan; tile rows tx * ty <= 64, tz <= 32.
int staged_push(const float* vals, float* out, const float* m,
                const float* minv, const float* r, int sx, int sy, int sz,
                int tx, int ty, int tz, int wx, int wy, int wz, int order,
                const int* plan, void* stream) {
  const Map34 M = load_map(m), Minv = load_map(minv);
  const Plan P = load_plan(plan);
  if (P.tx * P.ty > 64 || P.tz > 32) return -1;
  const dim3 grid = tile_grid(P, tx, ty, tz);
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    return launch_tiled(push_staged<0, 8>, P, grid, s, vals, out, M, Minv,
                        r[0], r[1], r[2], P, sx, sy, sz, tx, ty, tz, wx, wy,
                        wz);
  return launch_tiled(push_staged<1, 8>, P, grid, s, vals, out, M, Minv, r[0],
                      r[1], r[2], P, sx, sy, sz, tx, ty, tz, wx, wy, wz);
}

}  // extern "C"
