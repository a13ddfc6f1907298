// Variants of the push kernel, timed against the port's by
// scripts/cuda_push_variants.py. Every variant computes the function of
// unires_torch/csrc/resample.cu's push_kernel and must equal push_plain to
// the bit:
//   target  the port's first gather, one target per thread: per target its
//         candidate box, each candidate's sample point, floors, fractions,
//         FOV test and load computed for that target alone; block 8 (z) x
//         16 (y);
//   tile  a copy of the port's kernel (a thread owns TX x TY x TZ targets
//         and visits the union of their boxes once: opt_tile) at other
//         tile and block shapes than the port's (kPushTX, kPushTY, kPushTZ,
//         kPushLanesZ, kPushLanesY, kPushLanesX) and with options that the
//         port's lacks (kPushSelect, kPushUnroll2, kPushExactSetup,
//         kPushFastFloor, kPushStage), order 1 only;
//   smem  a thread owns TX x TY x TZ targets and keeps their sums in its
//         column of shared memory: each source adds to the targets it
//         weighs on by address (order 1; several launches for a batch).
// Each has an unbatched and a batched launch (target: one volume's launch
// grid, each thread over the volumes; tile: the port's). This file
// includes the port's source, so the variants share its helpers.

#include "../unires_torch/csrc/resample.cu"

namespace {

// target: a block of 8 lanes along z times 16 rows along y
constexpr int kLanesZ = 8;
constexpr int kRowsY = 16;

template <int ORDER, bool FOV>
__device__ __forceinline__ void per_target(const float* __restrict__ vals,
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
    target_kernel(const float* __restrict__ vals, float* __restrict__ out,
                  const float* __restrict__ plan, int sx, int sy, int sz,
                  int tx, int ty, int tz, int wx, int wy, int wz, Box fov,
                  unsigned long long* cnt) {
  count_launch<FOV>(cnt);
  per_target<ORDER, FOV>(vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy,
                         wz, fov, blockIdx.z);
}

template <int ORDER, bool FOV>
__global__ void __launch_bounds__(kLanesZ * kRowsY)
    target_batch_kernel(const float* __restrict__ vals,
                        float* __restrict__ out,
                        const float* __restrict__ plan, int sx, int sy,
                        int sz, int tx, int ty, int tz, int wx, int wy,
                        int wz, Box fov, unsigned long long* cnt, int batch,
                        long long vstride) {
  count_launch<FOV>(cnt);
  for (int b = 0; b < batch; ++b)
    per_target<ORDER, FOV>(vals + b * vstride,
                           out + b * ((long long)tx * ty * tz), plan + 32 * b,
                           sx, sy, sz, tx, ty, tz, wx, wy, wz, fov,
                           blockIdx.z);
}

template <int ORDER, bool FOV>
void launch_target(cudaStream_t s, const float* vals, float* out,
                const float* plan, int sx, int sy, int sz, int tx, int ty,
                int tz, int wx, int wy, int wz, Box box, int batch,
                long long vstride) {
  const dim3 block(kLanesZ, kRowsY);
  const dim3 grid((unsigned)((tz + kLanesZ - 1) / kLanesZ),
                  (unsigned)((ty + kRowsY - 1) / kRowsY), (unsigned)tx);
  if (batch > 0)
    target_batch_kernel<ORDER, FOV><<<grid, block, 0, s>>>(
        vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, box, nullptr,
        batch, vstride);
  else
    target_kernel<ORDER, FOV><<<grid, block, 0, s>>>(
        vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, box, nullptr);
}

// opt_*: a copy of the port's push kernel (push_source, push_visit,
// push_sums, push_tile, push_kernel, push_batch_kernel) with options, each
// a design that was measured and not taken (times: PERF.md). At
// OPT = 0 it computes what the port's does, the same way.
constexpr int kPushSelect = 1;      // route by selects, not predicated adds
constexpr int kPushUnroll2 = 2;     // unroll the oc loop by 2
constexpr int kPushExactSetup = 4;  // the union from every target's box
constexpr int kPushFastFloor = 8;   // floor by a rounding-down add
constexpr int kPushStage = 16;      // store through shared memory

// x rounded down by a float add in round-down mode and an exact subtract:
// floorf(x) for |x| < 2^22
__device__ __forceinline__ float floor_add(float x) {
  return __fsub_rn(__fadd_rd(x, 12582912.0f), 12582912.0f);
}

// Source o of sample point g(o) = (s01 + M[:,2] oc) + M[:,3] (fc = oc)
// added to the targets (vi + a, vj + b, vk + q) of the tile (a < TX,
// b < TY, q < TZ) that it weighs on. EDGE: the source is tested against the
// FOV (tx, ty, tz: the target grid).
template <int ORDER, bool FOV, bool EDGE, int TX, int TY, int TZ, int OPT>
__device__ __forceinline__ void opt_source(
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
    fl[d] = (OPT & kPushFastFloor) ? floor_add(g[d]) : floorf(g[d]);
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
        if (OPT & kPushSelect) {
          // + 0 where the source weighs nothing (the sums never hold -0)
          acc[a][b][q] = __fadd_rn(acc[a][b][q], p0 ? m0 : p1 ? m1 : 0.0f);
        } else if (p0 | p1) {
          acc[a][b][q] = __fadd_rn(acc[a][b][q], p0 ? m0 : m1);
        }
      }
    }
  }
}

// The sources of the box [lo, hi] in (oa, ob, oc) order, each added to the
// tile's targets that it weighs on (opt_source).
template <int ORDER, bool FOV, bool EDGE, int TX, int TY, int TZ, int OPT>
__device__ __forceinline__ void opt_visit(
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
#pragma unroll ((OPT & kPushUnroll2) ? 2 : 1)
      for (int oc = lo[2]; oc <= hi[2]; ++oc, fc += 1.0f, ++src)
        opt_source<ORDER, FOV, EDGE, TX, TY, TZ, OPT>(
            M, s01, fc, src, vi, vj, vk, tx, ty, tz, fov, acc);
    }
  }
}

// The sums of the tile whose first target (vi, vj, vk) lies inside the
// target grid: put(a, b, q, sum) for every target (vi + a, vj + b, vk + q),
// a < TX, b < TY, q < TZ (those outside the grid included).
template <int ORDER, bool FOV, int TX, int TY, int TZ, int OPT, class Put>
__device__ __forceinline__ void opt_sums(const float* __restrict__ vals,
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
  bool exact = (OPT & kPushExactSetup) != 0;
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
      opt_visit<ORDER, FOV, true, TX, TY, TZ, OPT>(
          vals, M, sy, sz, lo, hi, fi, fj, fk, tx, ty, tz, fov, acc);
    else
      opt_visit<ORDER, FOV, false, TX, TY, TZ, OPT>(
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
    opt_visit<ORDER, FOV, true, 1, 1, 1, 0>(vals, M, sy, sz, lo, hi, i, j,
                                             k, tx, ty, tz, fov, acc);
    put(a, b, q, acc[0][0][0]);
  }
}

// The tiles of a block (blockIdx.x, .y, xb) of LZ (z) x LY (y) x LX (x)
// threads, thread (threadIdx.x, .y, .z) the tile of targets (vi + a, vj +
// b, vk + q), a < TX, b < TY, q < TZ, written to out (the target grid)
// where they lie inside it. kPushStage: through shared memory, so that a
// warp's store instruction writes whole runs of LZ * TZ floats (a thread's
// tile has one run of TZ floats per (x, y) row, and a warp's lanes lie on
// 16 rows); else each thread stores its own tile.
template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX, int OPT>
__device__ __forceinline__ void opt_tile(const float* __restrict__ vals,
                                          float* __restrict__ out,
                                          const float* __restrict__ plan,
                                          int sx, int sy, int sz, int tx,
                                          int ty, int tz, int wx, int wy,
                                          int wz, const Box& fov, int xb) {
  const int vi = (xb * LX + threadIdx.z) * TX;
  const int vj = (blockIdx.y * LY + threadIdx.y) * TY;
  const int vk = (blockIdx.x * LZ + threadIdx.x) * TZ;
  const bool inside = (vi < tx) & (vj < ty) & (vk < tz);
  if (!(OPT & kPushStage)) {
    if (inside)
      opt_sums<ORDER, FOV, TX, TY, TZ, OPT>(
          vals, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, fov, vi, vj, vk,
          [&](int a, int b, int q, float v) {
            if ((vi + a < tx) & (vj + b < ty) & (vk + q < tz))
              out[((long long)(vi + a) * ty + vj + b) * tz + vk + q] = v;
          });
    return;
  }
  // the block's targets, rows of NZ + 1 floats (few bank conflicts)
  constexpr int NX = LX * TX, NY = LY * TY, NZ = LZ * TZ, P = NZ + 1;
  __shared__ float stage[NX * NY * P];
  float* mine = stage + ((threadIdx.z * TX) * NY + threadIdx.y * TY) * P +
                threadIdx.x * TZ;
  if (inside)
    opt_sums<ORDER, FOV, TX, TY, TZ, OPT>(
        vals, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, fov, vi, vj, vk,
        [&](int a, int b, int q, float v) { mine[(a * NY + b) * P + q] = v; });
  __syncthreads();
  const int x0 = xb * NX, y0 = blockIdx.y * NY, z0 = blockIdx.x * NZ;
  for (int e = threadIdx.x + LZ * (threadIdx.y + LY * threadIdx.z);
       e < NX * NY * NZ; e += LZ * LY * LX) {
    const int z = e % NZ, y = (e / NZ) % NY, x = e / (NZ * NY);
    if ((x0 + x < tx) & (y0 + y < ty) & (z0 + z < tz))
      out[((long long)(x0 + x) * ty + y0 + y) * tz + z0 + z] =
          stage[(x * NY + y) * P + z];
  }
}

template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX, int OPT>
__global__ void __launch_bounds__(LZ * LY * LX)
    opt_kernel(const float* __restrict__ vals, float* __restrict__ out,
                const float* __restrict__ plan, int sx, int sy, int sz,
                int tx, int ty, int tz, int wx, int wy, int wz, Box fov,
                unsigned long long* cnt) {
  count_launch<FOV, true>(cnt);
  opt_tile<ORDER, FOV, TX, TY, TZ, LZ, LY, LX, OPT>(
      vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, fov, blockIdx.z);
}

// The batched launch: block z = (x block) * batch + b, so the blocks of
// one place in the B volumes run side by side.
template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX, int OPT>
__global__ void __launch_bounds__(LZ * LY * LX)
    opt_batch_kernel(const float* __restrict__ vals, float* __restrict__ out,
                      const float* __restrict__ plan, int sx, int sy, int sz,
                      int tx, int ty, int tz, int wx, int wy, int wz, Box fov,
                      unsigned long long* cnt, int batch, long long vstride) {
  count_launch<FOV, true>(cnt);
  const int xb = blockIdx.z / batch, b = blockIdx.z - xb * batch;
  opt_tile<ORDER, FOV, TX, TY, TZ, LZ, LY, LX, OPT>(
      vals + b * vstride, out + b * ((long long)tx * ty * tz), plan + 32 * b,
      sx, sy, sz, tx, ty, tz, wx, wy, wz, fov, xb);
}

// One launch of push at tile TX x TY x TZ and block LZ x LY x LX: the batched
// kernel when batch > 0, else the unbatched one.
template <int ORDER, bool FOV, int TX, int TY, int TZ, int LZ, int LY,
          int LX, int OPT>
void launch_opt_kernel(cudaStream_t s, const float* vals, float* out,
                        const float* plan, int sx, int sy, int sz, int tx,
                        int ty, int tz, int wx, int wy, int wz, Box box,
                        unsigned long long* cnt, int batch,
                        long long vstride) {
  dim3 grid = push_grid<TX, TY, TZ, LZ, LY, LX>(tx, ty, tz);
  const dim3 block(LZ, LY, LX);
  if (batch > 0) {
    grid.z *= (unsigned)batch;
    opt_batch_kernel<ORDER, FOV, TX, TY, TZ, LZ, LY, LX, OPT>
        <<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                                wy, wz, box, cnt, batch, vstride);
  } else {
    opt_kernel<ORDER, FOV, TX, TY, TZ, LZ, LY, LX, OPT>
        <<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                                wy, wz, box, cnt);
  }
}


template <int TX, int TY, int TZ, int LZ, int LY, int LX, int OPT>
void launch_tile(cudaStream_t s, const float* vals, float* out,
                 const float* plan, int sx, int sy, int sz, int tx, int ty,
                 int tz, int wx, int wy, int wz, const float* fov, int batch,
                 long long vstride) {
  if (fov)
    launch_opt_kernel<1, true, TX, TY, TZ, LZ, LY, LX, OPT>(
        s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz,
        load_box(fov), nullptr, batch, vstride);
  else
    launch_opt_kernel<1, false, TX, TY, TZ, LZ, LY, LX, OPT>(
        s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx, wy, wz, Box(),
        nullptr, batch, vstride);
}

// smem: a thread owns TX (x) x TY (y) x TZ (z) targets whose sums it keeps
// in its own column of shared memory (slot t of thread n at t * NT + n: no
// bank conflict), so a source reaches its up to 8 targets by address, not
// by a compare per register. Order 1; a tile whose window cuts a box takes
// the port's path of one target at a time.
template <bool FOV, int TX, int TY, int TZ, int LZ, int RY>
__global__ void __launch_bounds__(LZ * RY)
    push_smem(const float* __restrict__ vals, float* __restrict__ out,
              const float* __restrict__ plan, int sx, int sy, int sz, int tx,
              int ty, int tz, int wx, int wy, int wz, Box fov) {
  constexpr int NT = LZ * RY;
  extern __shared__ float sacc[];
  const int n = threadIdx.y * LZ + threadIdx.x;
  const int vi = blockIdx.z * TX;
  const int vj = (blockIdx.y * RY + threadIdx.y) * TY;
  const int vk = (blockIdx.x * LZ + threadIdx.x) * TZ;
  if (vj >= ty || vk >= tz) return;
  const Map34 M = load_map_dev(plan);
  const Map34 Minv = load_map_dev(plan + 12);
  const float4 p0 = __ldg(reinterpret_cast<const float4*>(plan + 24));
  const float4 p1 = __ldg(reinterpret_cast<const float4*>(plan + 28));
  const float r[3] = {p0.x, p0.y, p0.z};
  const int w[3] = {wx >= 0 ? wx : (int)p0.w, wy >= 0 ? wy : (int)p1.x,
                    wz >= 0 ? wz : (int)p1.y};
  const int s[3] = {sx, sy, sz};
  const float fi = (float)vi, fj = (float)vj, fk = (float)vk;
  float ulo[3] = {kFar, kFar, kFar}, uhi[3] = {-kFar, -kFar, -kFar};
  bool cut = false;
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
  const bool edge = FOV | (vi < 1) | (vi + TX > tx - 1) | (vj < 1) |
                    (vj + TY > ty - 1) | (vk < 1) | (vk + TZ > tz - 1);
  if (cut) {
    for (int t = 0; t < TX * TY * TZ; ++t) {
      const int i = vi + t / (TY * TZ), j = vj + (t / TZ) % TY,
                k = vk + t % TZ;
      if ((i >= tx) | (j >= ty) | (k >= tz)) continue;
      float c[3];
      map_point(Minv, (float)i, (float)j, (float)k, c);
      int lo[3], hi[3];
      push_box(c, r, w, s, lo, hi);
      float acc[1][1][1] = {{{0.0f}}};
      push_visit<1, FOV, true, 1, 1, 1>(vals, M, sy, sz, lo, hi,
                                           (float)i, (float)j, (float)k, tx,
                                           ty, tz, fov, acc);
      out[((long long)i * ty + j) * tz + k] = acc[0][0][0];
    }
    return;
  }
  int lo[3], hi[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = (int)fminf(fmaxf(ulo[d], 0.0f), kFar);
    hi[d] = (int)fmaxf(fminf(uhi[d], (float)(s[d] - 1)), -1.0f);
  }
  float* mine = sacc + n;
#pragma unroll
  for (int t = 0; t < TX * TY * TZ; ++t) mine[t * NT] = 0.0f;
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
      for (int oc = lo[2]; oc <= hi[2]; ++oc, fc += 1.0f, ++src) {
        float g[3];
#pragma unroll
        for (int d = 0; d < 3; ++d)
          g[d] = __fadd_rn(__fadd_rn(s01[d], __fmul_rn(M.m[4 * d + 2], fc)),
                           M.m[4 * d + 3]);
        if (edge && !inside<FOV>(g, tx, ty, tz, fov)) continue;
        const float val = __ldg(src);
        float fl[3], wv[3][2];
        int e[3];
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          fl[d] = floorf(g[d]);
          const float f = __fsub_rn(g[d], fl[d]);
          wv[d][0] = __fsub_rn(1.0f, f);
          wv[d][1] = f;
        }
        // the floor's place in the tile (far floors clamped: no slot)
        e[0] = (int)fminf(fmaxf(__fsub_rn(fl[0], fi), -4.0f), 1024.0f);
        e[1] = (int)fminf(fmaxf(__fsub_rn(fl[1], fj), -4.0f), 1024.0f);
        e[2] = (int)fminf(fmaxf(__fsub_rn(fl[2], fk), -4.0f), 1024.0f);
        float* base = mine + ((e[0] * TY + e[1]) * TZ + e[2]) * NT;
#pragma unroll
        for (int da = 0; da < 2; ++da)
#pragma unroll
          for (int db = 0; db < 2; ++db) {
            const float wab = __fmul_rn(wv[0][da], wv[1][db]);
#pragma unroll
            for (int dc = 0; dc < 2; ++dc) {
              const bool in = ((unsigned)(e[0] + da) < (unsigned)TX) &
                              ((unsigned)(e[1] + db) < (unsigned)TY) &
                              ((unsigned)(e[2] + dc) < (unsigned)TZ);
              if (in) {
                float* p = base + ((da * TY + db) * TZ + dc) * NT;
                *p = __fadd_rn(*p, __fmul_rn(__fmul_rn(wab, wv[2][dc]), val));
              }
            }
          }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TX; ++a)
#pragma unroll
    for (int b = 0; b < TY; ++b)
#pragma unroll
      for (int q = 0; q < TZ; ++q)
        if ((vi + a < tx) & (vj + b < ty) & (vk + q < tz))
          out[((long long)(vi + a) * ty + vj + b) * tz + vk + q] =
              mine[((a * TY + b) * TZ + q) * NT];
}

template <int TX, int TY, int TZ, int LZ, int RY>
void launch_smem(cudaStream_t s, const float* vals, float* out,
                 const float* plan, int sx, int sy, int sz, int tx, int ty,
                 int tz, int wx, int wy, int wz, const float* fov, int batch,
                 long long vstride) {
  const dim3 grid((unsigned)((tz + LZ * TZ - 1) / (LZ * TZ)),
                  (unsigned)((ty + RY * TY - 1) / (RY * TY)),
                  (unsigned)((tx + TX - 1) / TX)),
      block(LZ, RY);
  const size_t smem = sizeof(float) * TX * TY * TZ * LZ * RY;
  for (int b = 0; b < (batch > 0 ? batch : 1); ++b) {
    const float* v = vals + b * vstride;
    float* o = out + b * ((long long)tx * ty * tz);
    const float* pl = plan + 32 * b;
    if (fov)
      push_smem<true, TX, TY, TZ, LZ, RY><<<grid, block, smem, s>>>(
          v, o, pl, sx, sy, sz, tx, ty, tz, wx, wy, wz, load_box(fov));
    else
      push_smem<false, TX, TY, TZ, LZ, RY><<<grid, block, smem, s>>>(
          v, o, pl, sx, sy, sz, tx, ty, tz, wx, wy, wz, Box());
  }
}

}  // namespace

extern "C" {

// variant 0: target (orders 0 and 1); 1 ..: the tile shapes of
// scripts/cuda_push_variants.py (order 1). Arguments as unires_push_batch's
// (fov: null or 6 host floats; batch 0: the unbatched launch); returns
// cudaGetLastError(), or -1 for an unknown variant or order.
int variant_push(int variant, const float* vals, float* out,
                 const float* plan, const float* fov, int sx, int sy, int sz,
                 int tx, int ty, int tz, int wx, int wy, int wz, int order,
                 int batch, long long vstride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0) {
    const Box box = load_box(fov);
    if (order == 0 && fov)
      launch_target<0, true>(s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                             wy, wz, box, batch, vstride);
    else if (order == 0)
      launch_target<0, false>(s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                              wy, wz, box, batch, vstride);
    else if (fov)
      launch_target<1, true>(s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                             wy, wz, box, batch, vstride);
    else
      launch_target<1, false>(s, vals, out, plan, sx, sy, sz, tx, ty, tz, wx,
                              wy, wz, box, batch, vstride);
    return (int)cudaGetLastError();
  }
  if (order != 1) return -1;
#define TILE(code, TX, TY, TZ, LZ, LY, LX, OPT)                           \
  case code:                                                               \
    launch_tile<TX, TY, TZ, LZ, LY, LX, OPT>(s, vals, out, plan, sx, sy,   \
                                             sz, tx, ty, tz, wx, wy, wz,   \
                                             fov, batch, vstride);         \
    break;
  switch (variant) {
    TILE(1, 1, 2, 4, 2, 4, 16, 0)
    TILE(2, 1, 2, 4, 4, 16, 1, 0)
    TILE(3, 1, 2, 4, 2, 4, 16, kPushSelect)
    TILE(4, 1, 2, 4, 2, 4, 16, kPushUnroll2)
    TILE(5, 1, 2, 4, 2, 4, 16, kPushFastFloor)
    TILE(6, 1, 2, 4, 2, 4, 16, kPushExactSetup)
    TILE(7, 1, 3, 4, 2, 4, 16, 0)
    TILE(8, 1, 2, 4, 2, 2, 32, 0)
    TILE(9, 1, 2, 4, 2, 4, 16, kPushStage)
    TILE(10, 1, 2, 2, 2, 4, 16, 0)
    TILE(11, 1, 1, 4, 2, 4, 16, 0)
    TILE(12, 2, 2, 2, 2, 4, 16, 0)
    TILE(13, 1, 3, 4, 2, 4, 16, kPushStage)
    TILE(14, 1, 4, 4, 2, 4, 16, kPushStage)
    TILE(15, 1, 2, 4, 2, 2, 32, kPushStage)
    TILE(16, 1, 1, 1, 8, 16, 1, 0)
    TILE(17, 1, 4, 4, 2, 4, 16, 0)
    TILE(18, 1, 3, 4, 2, 2, 32, 0)
    TILE(19, 1, 2, 4, 2, 8, 8, 0)
#define SMEM(code, TX, TY, TZ, LZ, RY)                                      \
  case code:                                                                \
    launch_smem<TX, TY, TZ, LZ, RY>(s, vals, out, plan, sx, sy, sz, tx, ty, \
                                    tz, wx, wy, wz, fov, batch, vstride);   \
    break;
    SMEM(20, 4, 4, 4, 8, 4)
    SMEM(21, 4, 4, 4, 8, 8)
    SMEM(22, 2, 4, 8, 4, 16)
    SMEM(23, 2, 8, 8, 4, 8)
    SMEM(24, 1, 8, 8, 4, 16)
    SMEM(25, 2, 4, 4, 8, 8)
    SMEM(26, 4, 4, 8, 4, 8)
    SMEM(27, 2, 2, 8, 4, 16)
#undef SMEM
    default:
      return -1;
  }
#undef TILE
  return (int)cudaGetLastError();
}

}  // extern "C"
