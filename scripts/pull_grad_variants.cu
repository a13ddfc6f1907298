// Variants of the pull_grad kernel, timed against the port's by
// scripts/cuda_pull_grad_variants.py. Every variant computes the function of
// unires_torch/csrc/resample.cu's pull_grad_kernel and must equal
// pull_grad_plain to the bit:
//   first   the port's first pull_grad kernel: a 1D launch that splits its
//           index with two divisions, tests every corner in a branch, does
//           6 weight products per corner and stores its three results 12
//           bytes apart;
//   direct  the port's kernel (3D launch grid, interior fast path, 12
//           shared pair products, the three results stored directly) at
//           other block shapes than the port's 16 (z) x 8 (y) x 2 (x);
//   staged  the same arithmetic with the block's results passed through
//           shared memory behind a block barrier, so that each (i, j) row
//           segment is written as consecutive floats by consecutive lanes;
//   warp    the same with one warp per row segment of 32 outputs, staged
//           in the warp's own slice of shared memory behind a warp barrier.
// This file includes the port's source, so the variants share its helpers.

#include "../unires_torch/csrc/resample.cu"

namespace {

__global__ void pull_grad_first(const float* __restrict__ vol,
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

template <int LZ, int RY, int RX>
__global__ void __launch_bounds__(LZ * RY)
    pull_grad_staged(const float* __restrict__ vol, float* __restrict__ out,
                     Map34 M, int nx, int ny, int nz, int ox, int oy,
                     int oz) {
  constexpr int kRow = 3 * LZ;      // floats of one (i, j) row segment
  constexpr int kTile = RY * kRow;  // floats of one i of the block's tile
  __shared__ float stage[RX][kTile];
  const int j0 = blockIdx.y * RY, k0 = blockIdx.x * LZ;
  const int i0 = blockIdx.z * RX;
  const int tid = threadIdx.y * LZ + threadIdx.x;
  // every thread stays for the barrier: one beyond the grid computes its
  // nearest voxel inside, and its result is never stored
  float res[RX][3];
  pull_grad_rows<RX>(vol, M, nx, ny, nz, i0, ox,
                     min(j0 + (int)threadIdx.y, oy - 1),
                     min(k0 + (int)threadIdx.x, oz - 1), res);
#pragma unroll
  for (int q = 0; q < RX; ++q)
#pragma unroll
    for (int d = 0; d < 3; ++d) stage[q][3 * tid + d] = res[q][d];
  __syncthreads();
  const int zlim = 3 * (oz - k0);  // floats of a row segment inside the grid
#pragma unroll
  for (int q = 0; q < RX; ++q) {
    if (i0 + q >= ox) break;
    float* base = out + 3 * (((i0 + q) * oy + j0) * oz + k0);
#pragma unroll
    for (int p = 0; p < 3; ++p) {  // kTile = 3 * LZ * RY floats
      const int e = p * LZ * RY + tid;
      const int r = e / kRow, c = e - r * kRow;
      if ((j0 + r < oy) & (c < zlim)) base[3 * r * oz + c] = stage[q][e];
    }
  }
}

template <int LZ, int RY, int RX>
__global__ void __launch_bounds__(LZ * RY)
    pull_grad_warp(const float* __restrict__ vol, float* __restrict__ out,
                   Map34 M, int nx, int ny, int nz, int ox, int oy, int oz) {
  static_assert(LZ == 32, "a warp is one row segment");
  __shared__ float stage[RY][RX][3 * LZ];
  const int j = blockIdx.y * RY + threadIdx.y;
  if (j >= oy) return;  // the whole warp leaves
  const int k0 = blockIdx.x * LZ, i0 = blockIdx.z * RX;
  const int lane = threadIdx.x;
  float res[RX][3];
  pull_grad_rows<RX>(vol, M, nx, ny, nz, i0, ox, j, min(k0 + lane, oz - 1),
                     res);
#pragma unroll
  for (int q = 0; q < RX; ++q)
#pragma unroll
    for (int d = 0; d < 3; ++d) stage[threadIdx.y][q][3 * lane + d] = res[q][d];
  __syncwarp();
  const int zlim = 3 * (oz - k0);
#pragma unroll
  for (int q = 0; q < RX; ++q) {
    if (i0 + q >= ox) break;
    float* base = out + 3 * (((i0 + q) * oy + j) * oz + k0);
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int c = p * LZ + lane;
      if (c < zlim) base[c] = stage[threadIdx.y][q][c];
    }
  }
}

template <int LZ, int RY, int RX>
dim3 tile_grid(int ox, int oy, int oz) {
  return dim3((unsigned)((oz + LZ - 1) / LZ), (unsigned)((oy + RY - 1) / RY),
              (unsigned)((ox + RX - 1) / RX));
}

#define LAUNCH(kernel, LZ, RY, RX)                                      \
  kernel<LZ, RY, RX><<<tile_grid<LZ, RY, RX>(ox, oy, oz), dim3(LZ, RY), \
                       0, s>>>(vol, out, M, nx, ny, nz, ox, oy, oz)

}  // namespace

extern "C" {

// variant: 0 first; 100 * kind + index, kind 1 direct, 2 staged, 3 warp;
// the index picks a block shape (lanes z, rows y, rows x) as listed in
// scripts/cuda_pull_grad_variants.py. Returns -1 for an unknown variant.
int variant_pull_grad(const float* vol, float* out, const float* m, int nx,
                      int ny, int nz, int ox, int oy, int oz, int variant,
                      void* stream) {
  const Map34 M = load_map(m);
  cudaStream_t s = (cudaStream_t)stream;
  if ((long long)ox * oy * oz == 0) return (int)cudaGetLastError();
  switch (variant) {
    case 0:
      pull_grad_first<<<(unsigned)(((long long)ox * oy * oz + 255) / 256),
                        256, 0, s>>>(vol, out, M, nx, ny, nz, ox, oy, oz);
      break;
    case 100: LAUNCH(pull_grad_kernel, 8, 16, 1); break;
    case 101: LAUNCH(pull_grad_kernel, 8, 16, 2); break;
    case 102: LAUNCH(pull_grad_kernel, 32, 4, 1); break;
    case 103: LAUNCH(pull_grad_kernel, 32, 4, 2); break;
    case 104: LAUNCH(pull_grad_kernel, 32, 4, 4); break;
    case 105: LAUNCH(pull_grad_kernel, 32, 2, 2); break;
    case 106: LAUNCH(pull_grad_kernel, 32, 8, 2); break;
    case 107: LAUNCH(pull_grad_kernel, 64, 2, 2); break;
    case 108: LAUNCH(pull_grad_kernel, 16, 8, 2); break;
    case 109: LAUNCH(pull_grad_kernel, 32, 4, 3); break;
    case 110: LAUNCH(pull_grad_kernel, 64, 4, 2); break;
    case 200: LAUNCH(pull_grad_staged, 8, 16, 1); break;
    case 201: LAUNCH(pull_grad_staged, 8, 16, 2); break;
    case 202: LAUNCH(pull_grad_staged, 16, 8, 2); break;
    case 203: LAUNCH(pull_grad_staged, 32, 4, 1); break;
    case 204: LAUNCH(pull_grad_staged, 32, 4, 2); break;
    case 205: LAUNCH(pull_grad_staged, 32, 8, 2); break;
    case 206: LAUNCH(pull_grad_staged, 16, 16, 2); break;
    case 207: LAUNCH(pull_grad_staged, 8, 32, 2); break;
    case 208: LAUNCH(pull_grad_staged, 64, 4, 1); break;
    case 300: LAUNCH(pull_grad_warp, 32, 4, 1); break;
    case 301: LAUNCH(pull_grad_warp, 32, 4, 2); break;
    case 302: LAUNCH(pull_grad_warp, 32, 8, 2); break;
    case 303: LAUNCH(pull_grad_warp, 32, 2, 2); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
