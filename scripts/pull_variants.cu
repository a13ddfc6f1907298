// Variants of the pull kernel, timed against the port's by
// scripts/cuda_pull_variants.py. Every variant computes the function of
// unires_torch/csrc/resample.cu's pull_kernel and must equal pull_plain to
// the bit. Two tiles:
//   rows   the port's previous pull: a block of LZ lanes along z times RY
//          rows along y (8 x 16: a warp of 8 (z) x 4 (y) outputs, each
//          corner load on 4 input rows), a thread the outputs of rows
//          i ... i + RX - 1 of one (j, k), each sample point by map_point;
//   warp   a warp of 32 outputs along z of one (i, j) row, TZ outputs along
//          z per thread (lanes 32 apart) in each of RX rows along x, RY
//          warps along y, the partial sums M[d,0] i + M[d,1] j shared
//          (pull_points).
// and "adapt", the port's block (4 warps over 64 (z) x 4 (y) x 2 (x)
// outputs, 4 per thread) with its warps 32 lanes along z (lane + 32 t, the
// port's) where every point of the block lies inside, else 8 (z) x 4 (y) lanes,
// each warp 16 outputs along z (lane + 8 t): one warp of the block then
// holds a z edge, not all four; the choice by __syncthreads_or ("adapt"),
// or from the map alone before any point is computed, each mapping its own
// body with a compile-time lane stride ("adapt map": clear_of_z_edges);
// and these ways to read the corners (G):
//   0  gather_corners: floorf and float -> int casts; a warp with a lane
//      near the volume's edge runs its general path (each corner's index
//      and bound test computed on its own);
//   1  the floors by floor_rd, the same general path;
//   2  the port's gather_rd: the floors by floor_rd, the edge by
//      edge_corners;
//   3  as 1, with the c + 1 corners taken from the next lane with
//      __shfl_down_sync where that lane's (a, b, c0) is (a, b, c0 + 1),
//      loaded otherwise ("shfl");
//   4  every point by floor_rd and edge_corners, no interior fast path and
//      no branch ("edge");
//   5  as 2, but the fast path also takes a point whose c0 is -1 or nz - 1
//      (a z edge, which splits a warp of 32 lanes along z): c0 clamped into
//      [0, nz - 2] and the two c corners of each (a, b) shifted or zeroed
//      by selects ("zfix").
// Order 0 reads floor(g + 1/2) by floorf and a cast (G = 0) or by floor_rd.
// This file includes the port's source, so the variants share its helpers.

#include "../unires_torch/csrc/resample.cu"

namespace {

constexpr int kWarp = 32;  // warp: lanes along z

// G = 1: floor_rd's floors, gather_corners' general path near the edge
template <int P>
__device__ __forceinline__ void gather_rd_general(
    const float* __restrict__ vol, float g[P][3], int nx, int ny, int nz,
    float fl[P][3], float v[P][8], bool keep[P]) {
  unsigned fi[P][3];
  bool inner = true;
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int d = 0; d < 3; ++d) fi[q][d] = floor_rd(g[q][d], &fl[q][d]);
    inner = inner & (fi[q][0] < (unsigned)(nx - 1)) &
            (fi[q][1] < (unsigned)(ny - 1)) & (fi[q][2] < (unsigned)(nz - 1));
  }
  if (!inner) {
    gather_corners<P, false>(vol, g, nx, ny, nz, fl, v, keep);
    return;
  }
  const unsigned sxy = (unsigned)ny * nz;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    keep[q] = true;
    const unsigned idx = (fi[q][0] * ny + fi[q][1]) * nz + fi[q][2];
    const float* p[4] = {vol + idx, vol + (idx + nz), vol + (idx + sxy),
                         vol + (idx + sxy + nz)};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      v[q][2 * r] = __ldg(p[r]);
      v[q][2 * r + 1] = __ldg(p[r] + 1);
    }
  }
}

// G = 3: G = 1 with the c + 1 corners from the next lane where that lane's
// corner (a, b, c0) is this lane's (a, b, c0 + 1): the same voxel, hence
// the same value. A warp whose points are all interior loads the c0
// corners, passes them down by one lane, and loads a c0 + 1 corner only
// where the next lane's flat index is not this lane's + 1 (skipped where
// no lane needs it); any other warp runs gather_corners.
template <int P>
__device__ __forceinline__ void gather_shfl(const float* __restrict__ vol,
                                            float g[P][3], int nx, int ny,
                                            int nz, float fl[P][3],
                                            float v[P][8], bool keep[P]) {
  constexpr unsigned kAll = 0xffffffffu;
  unsigned fi[P][3];
  bool inner = true;
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int d = 0; d < 3; ++d) fi[q][d] = floor_rd(g[q][d], &fl[q][d]);
    inner = inner & (fi[q][0] < (unsigned)(nx - 1)) &
            (fi[q][1] < (unsigned)(ny - 1)) & (fi[q][2] < (unsigned)(nz - 1));
  }
  if (!__all_sync(kAll, inner)) {
    gather_corners<P, false>(vol, g, nx, ny, nz, fl, v, keep);
    return;
  }
  const unsigned sxy = (unsigned)ny * nz;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    keep[q] = true;
    const unsigned idx = (fi[q][0] * ny + fi[q][1]) * nz + fi[q][2];
    const float* p[4] = {vol + idx, vol + (idx + nz), vol + (idx + sxy),
                         vol + (idx + sxy + nz)};
#pragma unroll
    for (int r = 0; r < 4; ++r) v[q][2 * r] = __ldg(p[r]);
    const bool take = __shfl_down_sync(kAll, idx, 1) == idx + 1;
    float nv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) nv[r] = __shfl_down_sync(kAll, v[q][2 * r], 1);
    if (__all_sync(kAll, take)) {
#pragma unroll
      for (int r = 0; r < 4; ++r) v[q][2 * r + 1] = nv[r];
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        v[q][2 * r + 1] = take ? nv[r] : __ldg(p[r] + 1);
    }
  }
}

// G = 4: floor_rd and edge_corners for every point (the default FOV: a
// point with |g| >= 2^22, whose floor_rd floor is not exact, lies outside)
template <int P>
__device__ __forceinline__ void gather_edge(const float* __restrict__ vol,
                                            float g[P][3], int nx, int ny,
                                            int nz, float fl[P][3],
                                            float v[P][8], bool keep[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    unsigned fi[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) fi[d] = floor_rd(g[q][d], &fl[q][d]);
    keep[q] = in_fov(g[q], nx, ny, nz);
    edge_corners(vol, fi, nx, ny, nz, v[q]);
  }
}

// G = 5: the fast path for every point whose a and b corners lie inside
// the volume and whose c0 lies in [-1, nz - 1]: the row read at c0
// clamped into [0, nz - 2], then per (a, b) pair (u0, u1) read at (cc,
// cc + 1): c0 = -1 gives (0, u0), c0 = nz - 1 gives (u1, 0). edge_corners
// elsewhere.
template <int P>
__device__ __forceinline__ void gather_zfix(const float* __restrict__ vol,
                                            float g[P][3], int nx, int ny,
                                            int nz, float fl[P][3],
                                            float v[P][8], bool keep[P]) {
  unsigned fi[P][3];
  bool inner = nz > 1;
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int d = 0; d < 3; ++d) fi[q][d] = floor_rd(g[q][d], &fl[q][d]);
    inner = inner & (fi[q][0] < (unsigned)(nx - 1)) &
            (fi[q][1] < (unsigned)(ny - 1)) &
            (fi[q][2] + 1u < (unsigned)(nz + 1));
  }
  if (inner) {
    const unsigned sxy = (unsigned)ny * nz;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      // g_z may lie in [-1, -0.5) or (nz - 0.5, nz): the z bound tested
      keep[q] = (g[q][2] >= -0.5f) & (g[q][2] <= (float)nz - 0.5f);
      const bool lo = fi[q][2] == 0xffffffffu, hi = fi[q][2] == nz - 1u;
      const unsigned cc = lo ? 0u : (hi ? nz - 2u : fi[q][2]);
      const unsigned idx = (fi[q][0] * ny + fi[q][1]) * nz + cc;
      const float* p[4] = {vol + idx, vol + (idx + nz), vol + (idx + sxy),
                           vol + (idx + sxy + nz)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float u0 = __ldg(p[r]), u1 = __ldg(p[r] + 1);
        v[q][2 * r] = lo ? 0.0f : (hi ? u1 : u0);
        v[q][2 * r + 1] = hi ? 0.0f : (lo ? u0 : u1);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      keep[q] = in_fov(g[q], nx, ny, nz);
#pragma unroll
      for (int d = 0; d < 3; ++d) fl[q][d] = floorf(g[q][d]);
      edge_corners(vol, fi[q], nx, ny, nz, v[q]);
    }
  }
}

template <int G, int P>
__device__ __forceinline__ void var_gather(const float* __restrict__ vol,
                                           float g[P][3], int nx, int ny,
                                           int nz, float fl[P][3],
                                           float v[P][8], bool keep[P]) {
  if (G == 0)
    gather_corners<P, false>(vol, g, nx, ny, nz, fl, v, keep);
  else if (G == 1)
    gather_rd_general<P>(vol, g, nx, ny, nz, fl, v, keep);
  else if (G == 2)
    gather_rd<P, false>(vol, g, nx, ny, nz, fl, v, keep, Box());
  else if (G == 3)
    gather_shfl<P>(vol, g, nx, ny, nz, fl, v, keep);
  else if (G == 4)
    gather_edge<P>(vol, g, nx, ny, nz, fl, v, keep);
  else
    gather_zfix<P>(vol, g, nx, ny, nz, fl, v, keep);
}

template <int G>
__device__ __forceinline__ float var_nearest(const float* __restrict__ vol,
                                             const float g[3], int nx,
                                             int ny, int nz) {
  if (G != 0) return pull_nearest<false>(vol, g, nx, ny, nz, Box());
  const int a = clamp_far(floorf(g[0] + 0.5f));
  const int b = clamp_far(floorf(g[1] + 0.5f));
  const int c = clamp_far(floorf(g[2] + 0.5f));
  const bool ok = in_fov(g, nx, ny, nz) & (a >= 0) & (a < nx) & (b >= 0) &
                  (b < ny) & (c >= 0) & (c < nz);
  return ok ? __ldg(vol + (a * ny + b) * nz + c) : 0.0f;
}

template <int ORDER, int G, int LZ, int RY, int RX>
__global__ void __launch_bounds__(LZ * RY)
    rows_kernel(const float* __restrict__ vol, float* __restrict__ out,
                const float* __restrict__ mp, int nx, int ny, int nz, int ox,
                int oy, int oz) {
  const Map34 M = load_map_dev(mp);
  const int j = blockIdx.y * RY + threadIdx.y;
  const int k = blockIdx.x * LZ + threadIdx.x;
  if (j >= oy || k >= oz) return;
  const int i0 = blockIdx.z * RX;
  float g[RX][3], res[RX];
#pragma unroll
  for (int q = 0; q < RX; ++q)
    map_point(M, (float)min(i0 + q, ox - 1), (float)j, (float)k, g[q]);
  if (ORDER == 0) {
#pragma unroll
    for (int q = 0; q < RX; ++q)
      res[q] = var_nearest<G>(vol, g[q], nx, ny, nz);
  } else {
    float fl[RX][3], v[RX][8];
    bool keep[RX];
    var_gather<G, RX>(vol, g, nx, ny, nz, fl, v, keep);
#pragma unroll
    for (int q = 0; q < RX; ++q)
      res[q] = pull_trilinear(g[q], fl[q], v[q], keep[q]);
  }
#pragma unroll
  for (int q = 0; q < RX; ++q)
    if (i0 + q < ox) out[((long long)(i0 + q) * oy + j) * oz + k] = res[q];
}

template <int ORDER, int G, int TZ, int RY, int RX>
__global__ void __launch_bounds__(kWarp * RY)
    warp_kernel(const float* __restrict__ vol, float* __restrict__ out,
                const float* __restrict__ mp, int nx, int ny, int nz, int ox,
                int oy, int oz) {
  constexpr int P = RX * TZ;
  const int j = blockIdx.y * RY + threadIdx.y;
  if (j >= oy) return;  // the whole warp
  const Map34 M = load_map_dev(mp);
  const int k0 = blockIdx.x * (kWarp * TZ) + threadIdx.x;
  const int i0 = blockIdx.z * RX;
  float g[P][3], res[P];
  pull_points<RX, TZ>(M, i0, ox, j, k0, kWarp, oz, g);
  if (ORDER == 0) {
#pragma unroll
    for (int p = 0; p < P; ++p) res[p] = var_nearest<G>(vol, g[p], nx, ny, nz);
  } else {
    float fl[P][3], v[P][8];
    bool keep[P];
    var_gather<G, P>(vol, g, nx, ny, nz, fl, v, keep);
#pragma unroll
    for (int p = 0; p < P; ++p)
      res[p] = pull_trilinear(g[p], fl[p], v[p], keep[p]);
  }
#pragma unroll
  for (int q = 0; q < RX; ++q)
#pragma unroll
    for (int t = 0; t < TZ; ++t) {
      const int k = k0 + kWarp * t;
      if ((i0 + q < ox) & (k < oz))
        out[((long long)(i0 + q) * oy + j) * oz + k] = res[q * TZ + t];
    }
}

template <int ORDER, int G>
__global__ void __launch_bounds__(128)
    adapt_kernel(const float* __restrict__ vol, float* __restrict__ out,
                 const float* __restrict__ mp, int nx, int ny, int nz, int ox,
                 int oy, int oz) {
  const Map34 M = load_map_dev(mp);
  const int lane = threadIdx.x, w = threadIdx.y;
  const int kb = blockIdx.x * 64, jb = blockIdx.y * 4, i0 = blockIdx.z * 2;
  int j = jb + w, k0 = kb + lane, dz = 32;
  float g[4][3], res[4];
  pull_points<2, 2>(M, i0, ox, min(j, oy - 1), k0, 32, oz, g);
  bool inner = true;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float f;
    inner = inner & (floor_rd(g[p][0], &f) < (unsigned)(nx - 1)) &
            (floor_rd(g[p][1], &f) < (unsigned)(ny - 1)) &
            (floor_rd(g[p][2], &f) < (unsigned)(nz - 1));
  }
  if (ORDER == 1 && __syncthreads_or(!inner)) {
    j = jb + lane / 8;
    k0 = kb + 16 * w + lane % 8;
    dz = 8;
    pull_points<2, 2>(M, i0, ox, min(j, oy - 1), k0, 8, oz, g);
  }
  if (ORDER == 0) {
#pragma unroll
    for (int p = 0; p < 4; ++p) res[p] = var_nearest<G>(vol, g[p], nx, ny, nz);
  } else {
    float fl[4][3], v[4][8];
    bool keep[4];
    var_gather<G, 4>(vol, g, nx, ny, nz, fl, v, keep);
#pragma unroll
    for (int p = 0; p < 4; ++p)
      res[p] = pull_trilinear(g[p], fl[p], v[p], keep[p]);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int k = k0 + dz * t;
      if ((i0 + q < ox) & (j < oy) & (k < oz))
        out[((long long)(i0 + q) * oy + j) * oz + k] = res[q * 2 + t];
    }
}

// Whether the block's sample points stay clear of the volume's z edges:
// g_z is affine, so over the block's tile (x from i0, y from jb, z from kb,
// clamped to the grid) it lies between its values at the tile's corners,
// here summed per axis from the smaller and the larger product. The margin
// covers the roundings; the answer only picks a mapping.
__device__ __forceinline__ bool clear_of_z_edges(const Map34& M, int i0,
                                                 int jb, int kb, int ox,
                                                 int oy, int oz, int nz) {
  const float* r = M.m + 8;
  const float ends[3][2] = {{(float)i0, (float)min(i0 + 1, ox - 1)},
                            {(float)jb, (float)min(jb + 3, oy - 1)},
                            {(float)kb, (float)min(kb + 63, oz - 1)}};
  float lo = r[3], hi = r[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float a = r[d] * ends[d][0], b = r[d] * ends[d][1];
    lo += fminf(a, b);
    hi += fmaxf(a, b);
  }
  return (lo >= 0.01f) & (hi <= (float)nz - 1.01f);
}

// The port's tile with its lanes mapped WIDE (each warp one y row, 32 lanes
// along z, outputs k and k + 32) or 8 (z) x 4 (y) (warp w the 16 z from
// 16 w, outputs k and k + 8)
template <int ORDER, bool WIDE>
__device__ __forceinline__ void mapped_tile(const float* __restrict__ vol,
                                            float* __restrict__ out,
                                            const Map34& M, int nx, int ny,
                                            int nz, int ox, int oy, int oz,
                                            int i0, int jb, int kb) {
  constexpr int dz = WIDE ? 32 : 8;
  const int lane = threadIdx.x, w = threadIdx.y;
  const int j = WIDE ? jb + w : jb + lane / 8;
  const int k0 = WIDE ? kb + lane : kb + 16 * w + lane % 8;
  float g[4][3], res[4];
  pull_points<2, 2>(M, i0, ox, min(j, oy - 1), k0, dz, oz, g);
  if (ORDER == 0) {
#pragma unroll
    for (int p = 0; p < 4; ++p)
      res[p] = pull_nearest<false>(vol, g[p], nx, ny, nz, Box());
  } else {
    float fl[4][3], v[4][8];
    bool keep[4];
    gather_rd<4, false>(vol, g, nx, ny, nz, fl, v, keep, Box());
#pragma unroll
    for (int p = 0; p < 4; ++p)
      res[p] = pull_trilinear(g[p], fl[p], v[p], keep[p]);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int k = k0 + dz * t;
      if ((i0 + q < ox) & (j < oy) & (k < oz))
        out[((long long)(i0 + q) * oy + j) * oz + k] = res[q * 2 + t];
    }
}

template <int ORDER>
__global__ void __launch_bounds__(128)
    adapt_map_kernel(const float* __restrict__ vol, float* __restrict__ out,
                     const float* __restrict__ mp, int nx, int ny, int nz,
                     int ox, int oy, int oz) {
  const Map34 M = load_map_dev(mp);
  const int kb = blockIdx.x * 64, jb = blockIdx.y * 4, i0 = blockIdx.z * 2;
  if (ORDER == 0 || clear_of_z_edges(M, i0, jb, kb, ox, oy, oz, nz))
    mapped_tile<ORDER, true>(vol, out, M, nx, ny, nz, ox, oy, oz, i0, jb,
                             kb);
  else
    mapped_tile<ORDER, false>(vol, out, M, nx, ny, nz, ox, oy, oz, i0, jb,
                              kb);
}

template <int G, int LZ, int RY, int RX>
void launch_rows(int order, cudaStream_t s, const float* vol, float* out,
                 const float* mp, int nx, int ny, int nz, int ox, int oy,
                 int oz) {
  const dim3 grid((unsigned)((oz + LZ - 1) / LZ),
                  (unsigned)((oy + RY - 1) / RY),
                  (unsigned)((ox + RX - 1) / RX));
  if (order == 0)
    rows_kernel<0, G, LZ, RY, RX><<<grid, dim3(LZ, RY), 0, s>>>(
        vol, out, mp, nx, ny, nz, ox, oy, oz);
  else
    rows_kernel<1, G, LZ, RY, RX><<<grid, dim3(LZ, RY), 0, s>>>(
        vol, out, mp, nx, ny, nz, ox, oy, oz);
}

template <int G, int TZ, int RY, int RX>
void launch_warp(int order, cudaStream_t s, const float* vol, float* out,
                 const float* mp, int nx, int ny, int nz, int ox, int oy,
                 int oz) {
  const dim3 grid((unsigned)((oz + kWarp * TZ - 1) / (kWarp * TZ)),
                  (unsigned)((oy + RY - 1) / RY),
                  (unsigned)((ox + RX - 1) / RX));
  if (order == 0)
    warp_kernel<0, G, TZ, RY, RX><<<grid, dim3(kWarp, RY), 0, s>>>(
        vol, out, mp, nx, ny, nz, ox, oy, oz);
  else
    warp_kernel<1, G, TZ, RY, RX><<<grid, dim3(kWarp, RY), 0, s>>>(
        vol, out, mp, nx, ny, nz, ox, oy, oz);
}

template <int G>
void launch_adapt(int order, cudaStream_t s, const float* vol, float* out,
                  const float* mp, int nx, int ny, int nz, int ox, int oy,
                  int oz) {
  const dim3 grid((unsigned)((oz + 63) / 64), (unsigned)((oy + 3) / 4),
                  (unsigned)((ox + 1) / 2));
  if (order == 0)
    adapt_kernel<0, G><<<grid, dim3(32, 4), 0, s>>>(vol, out, mp, nx, ny, nz,
                                                    ox, oy, oz);
  else
    adapt_kernel<1, G><<<grid, dim3(32, 4), 0, s>>>(vol, out, mp, nx, ny, nz,
                                                    ox, oy, oz);
}

void launch_adapt_map(int order, cudaStream_t s, const float* vol,
                      float* out, const float* mp, int nx, int ny, int nz,
                      int ox, int oy, int oz) {
  const dim3 grid((unsigned)((oz + 63) / 64), (unsigned)((oy + 3) / 4),
                  (unsigned)((ox + 1) / 2));
  if (order == 0)
    adapt_map_kernel<0><<<grid, dim3(32, 4), 0, s>>>(vol, out, mp, nx, ny,
                                                     nz, ox, oy, oz);
  else
    adapt_map_kernel<1><<<grid, dim3(32, 4), 0, s>>>(vol, out, mp, nx, ny,
                                                     nz, ox, oy, oz);
}

}  // namespace

extern "C" {

// variant: 100 * kind + index: kind 0 rows with G = 0, 1 warp with G = 0,
// 2 warp with G = 1, 3 warp with G = 3 (shfl), 4 rows with G = 1, 5 rows
// with G = 2, 6 warp with G = 2, 7 rows with G = 4, 8 warp with G = 4, 9
// rows with G = 5, 10 warp with G = 5, 11 adapt with G = 2 (index 0: by
// a barrier, 1: from the map); the
// index picks the shape as listed in
// scripts/cuda_pull_variants.py. m: the map in device memory. Returns -1
// for an unknown variant.
int variant_pull(const float* vol, float* out, const float* m, int nx,
                 int ny, int nz, int ox, int oy, int oz, int order,
                 int variant, void* stream) {
  if ((long long)ox * oy * oz == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
#define ROWS(G, LZ, RY, RX) \
  launch_rows<G, LZ, RY, RX>(order, s, vol, out, m, nx, ny, nz, ox, oy, oz)
#define WARP(G, TZ, RY, RX) \
  launch_warp<G, TZ, RY, RX>(order, s, vol, out, m, nx, ny, nz, ox, oy, oz)
  switch (variant) {
    case 0: ROWS(0, 8, 16, 2); break;
    case 1: ROWS(0, 32, 4, 2); break;
    case 2: ROWS(0, 32, 2, 2); break;
    case 3: ROWS(0, 32, 8, 1); break;
    case 4: ROWS(0, 16, 8, 2); break;
    case 5: ROWS(0, 64, 2, 2); break;
    case 6: ROWS(0, 32, 4, 1); break;
    case 7: ROWS(0, 8, 16, 1); break;
    case 8: ROWS(0, 16, 16, 2); break;
    case 9: ROWS(0, 4, 32, 2); break;
    case 10: ROWS(0, 8, 8, 2); break;
    case 11: ROWS(0, 8, 32, 2); break;
    case 100: WARP(0, 1, 4, 1); break;
    case 101: WARP(0, 1, 4, 2); break;
    case 102: WARP(0, 2, 4, 1); break;
    case 103: WARP(0, 2, 4, 2); break;
    case 104: WARP(0, 4, 4, 1); break;
    case 105: WARP(0, 2, 8, 1); break;
    case 200: WARP(1, 1, 4, 1); break;
    case 201: WARP(1, 1, 4, 2); break;
    case 202: WARP(1, 2, 4, 1); break;
    case 203: WARP(1, 2, 4, 2); break;
    case 204: WARP(1, 4, 4, 1); break;
    case 205: WARP(1, 2, 8, 1); break;
    case 206: WARP(1, 2, 2, 2); break;
    case 207: WARP(1, 1, 8, 2); break;
    case 208: WARP(1, 4, 2, 1); break;
    case 209: WARP(1, 1, 4, 4); break;
    case 210: WARP(1, 2, 2, 1); break;
    case 211: WARP(1, 2, 16, 1); break;
    case 300: WARP(3, 1, 4, 1); break;
    case 301: WARP(3, 2, 4, 1); break;
    case 302: WARP(3, 1, 4, 2); break;
    case 400: ROWS(1, 8, 16, 2); break;
    case 401: ROWS(1, 16, 8, 2); break;
    case 402: ROWS(1, 4, 32, 2); break;
    case 500: ROWS(2, 8, 16, 2); break;
    case 501: ROWS(2, 16, 8, 2); break;
    case 502: ROWS(2, 4, 32, 2); break;
    case 503: ROWS(2, 8, 8, 2); break;
    case 504: ROWS(2, 8, 32, 2); break;
    case 505: ROWS(2, 8, 16, 1); break;
    case 506: ROWS(2, 8, 16, 3); break;
    case 507: ROWS(2, 32, 4, 2); break;
    case 600: WARP(2, 1, 4, 1); break;
    case 601: WARP(2, 1, 4, 2); break;
    case 602: WARP(2, 2, 4, 1); break;
    case 603: WARP(2, 2, 4, 2); break;
    case 604: WARP(2, 1, 8, 2); break;
    case 605: WARP(2, 1, 8, 1); break;
    case 700: ROWS(4, 8, 16, 2); break;
    case 701: ROWS(4, 16, 8, 2); break;
    case 702: ROWS(4, 8, 16, 1); break;
    case 800: WARP(4, 1, 4, 1); break;
    case 801: WARP(4, 1, 4, 2); break;
    case 802: WARP(4, 2, 4, 1); break;
    case 803: WARP(4, 2, 4, 2); break;
    case 804: WARP(4, 2, 2, 2); break;
    case 900: ROWS(5, 8, 16, 2); break;
    case 901: ROWS(5, 16, 8, 2); break;
    case 1000: WARP(5, 1, 4, 1); break;
    case 1001: WARP(5, 1, 4, 2); break;
    case 1002: WARP(5, 2, 4, 1); break;
    case 1003: WARP(5, 2, 4, 2); break;
    case 1004: WARP(5, 2, 2, 2); break;
    case 1005: WARP(5, 2, 8, 2); break;
    case 1100:
      launch_adapt<2>(order, s, vol, out, m, nx, ny, nz, ox, oy, oz);
      break;
    case 1101:
      launch_adapt_map(order, s, vol, out, m, nx, ny, nz, ox, oy, oz);
      break;
    default: return -1;
  }
#undef ROWS
#undef WARP
  return (int)cudaGetLastError();
}

}  // extern "C"
