// Other mappings of a batched launch of pull, push and pull_grad, timed
// against the port's by scripts/cuda_batch_variants.py. Each computes every
// output with the port's tile code (pull_tile, push_tile, pull_grad_tile),
// so each must equal the unbatched launches to the bit:
//   zfold  the batch folded into the grid's z with the volumes slowest:
//          block z = b * zblocks + (x row block), b split off by a division
//          (the port's first batched kernels);
//   inter  the same with the volumes fastest: block z = (x row block) * B
//          + b, so the blocks of one position in the B volumes run side by
//          side (pull and pull_grad; the port's push is this mapping);
//   loop   push: one volume's launch grid, each thread its tile in every
//          volume in turn (the mapping of pull's batched launch).
// The port's batched pull and pull_grad run one volume's launch grid, each
// thread its output position in every volume in turn. This file includes
// the port's source, so the variants share its helpers.

#include "../unires_torch/csrc/resample.cu"

namespace {

template <int ORDER>
__global__ void __launch_bounds__(32 * kPullWarps)
    pull_zfold(const float* __restrict__ vol, float* __restrict__ out,
               const float* __restrict__ mp, int nx, int ny, int nz, int ox,
               int oy, int oz, int batch, long long vstride) {
  const int zblocks = (ox + kPullRX - 1) / kPullRX;
  const int b = blockIdx.z / zblocks;
  pull_tile<ORDER, false>(
      vol + b * vstride, out + b * ((long long)ox * oy * oz), mp + 12 * b,
      nx, ny, nz, ox, oy, oz, Box(), blockIdx.z - b * zblocks);
}

template <int ORDER>
__global__ void __launch_bounds__(32 * kPullWarps)
    pull_inter(const float* __restrict__ vol, float* __restrict__ out,
               const float* __restrict__ mp, int nx, int ny, int nz, int ox,
               int oy, int oz, int batch, long long vstride) {
  const int zb = blockIdx.z / batch;
  const int b = blockIdx.z - zb * batch;
  pull_tile<ORDER, false>(
      vol + b * vstride, out + b * ((long long)ox * oy * oz), mp + 12 * b,
      nx, ny, nz, ox, oy, oz, Box(), zb);
}

// the pull variant at order ORDER: its tile's block, the grid's z times
// the batch
template <int ORDER>
void launch_pull_variant(int variant, cudaStream_t s, const float* vol,
                         float* out, const float* m, int nx, int ny, int nz,
                         int ox, int oy, int oz, int batch,
                         long long vstride) {
  const dim3 block(32, kPullWarps);
  dim3 grid = pull_grid(ox, oy, oz);
  grid.z *= (unsigned)batch;
  if (variant == 0)
    pull_zfold<ORDER><<<grid, block, 0, s>>>(vol, out, m, nx, ny, nz, ox, oy,
                                            oz, batch, vstride);
  else
    pull_inter<ORDER><<<grid, block, 0, s>>>(vol, out, m, nx, ny, nz, ox, oy,
                                            oz, batch, vstride);
}

constexpr int kPushThreads = kPushLanesZ * kPushLanesY * kPushLanesX;

template <int ORDER>
__global__ void __launch_bounds__(kPushThreads)
    push_zfold(const float* __restrict__ vals, float* __restrict__ out,
               const float* __restrict__ plan, int sx, int sy, int sz, int tx,
               int ty, int tz, int batch, long long vstride) {
  const int xblocks =
      (tx + kPushLanesX * kPushTX - 1) / (kPushLanesX * kPushTX);
  const int b = blockIdx.z / xblocks;
  push_tile<ORDER, false, kPushTX, kPushTY, kPushTZ, kPushLanesZ,
            kPushLanesY, kPushLanesX>(
      vals + b * vstride, out + b * ((long long)tx * ty * tz), plan + 32 * b,
      sx, sy, sz, tx, ty, tz, -1, -1, -1, Box(), blockIdx.z - b * xblocks);
}

template <int ORDER>
__global__ void __launch_bounds__(kPushThreads)
    push_loop(const float* __restrict__ vals, float* __restrict__ out,
              const float* __restrict__ plan, int sx, int sy, int sz, int tx,
              int ty, int tz, int batch, long long vstride) {
  for (int b = 0; b < batch; ++b)
    push_tile<ORDER, false, kPushTX, kPushTY, kPushTZ, kPushLanesZ,
              kPushLanesY, kPushLanesX>(
        vals + b * vstride, out + b * ((long long)tx * ty * tz),
        plan + 32 * b, sx, sy, sz, tx, ty, tz, -1, -1, -1, Box(), blockIdx.z);
}

__global__ void __launch_bounds__(kGradLanesZ * kGradRowsY)
    pull_grad_zfold(const float* __restrict__ vol, float* __restrict__ out,
                    const float* __restrict__ mp, int nx, int ny, int nz,
                    int ox, int oy, int oz, int batch, long long vstride) {
  const int zblocks = (ox + kRowsX - 1) / kRowsX;
  const int b = blockIdx.z / zblocks;
  pull_grad_tile<kGradLanesZ, kGradRowsY, kRowsX>(
      vol + b * vstride, out + b * (3LL * ox * oy * oz),
      load_map_dev(mp + 12 * b), nx, ny, nz, ox, oy, oz,
      blockIdx.z - b * zblocks);
}

__global__ void __launch_bounds__(kGradLanesZ * kGradRowsY)
    pull_grad_inter(const float* __restrict__ vol, float* __restrict__ out,
                    const float* __restrict__ mp, int nx, int ny, int nz,
                    int ox, int oy, int oz, int batch, long long vstride) {
  const int zb = blockIdx.z / batch;
  const int b = blockIdx.z - zb * batch;
  pull_grad_tile<kGradLanesZ, kGradRowsY, kRowsX>(
      vol + b * vstride, out + b * (3LL * ox * oy * oz),
      load_map_dev(mp + 12 * b), nx, ny, nz, ox, oy, oz, zb);
}

}  // namespace

extern "C" {

// variant 0: zfold, 1: inter; arguments as unires_pull_batch's
int variant_pull(int variant, const float* vol, float* out, const float* m,
                 int nx, int ny, int nz, int ox, int oy, int oz, int order,
                 int batch, long long vstride, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (order == 0)
    launch_pull_variant<0>(variant, s, vol, out, m, nx, ny, nz, ox, oy, oz,
                           batch, vstride);
  else
    launch_pull_variant<1>(variant, s, vol, out, m, nx, ny, nz, ox, oy, oz,
                           batch, vstride);
  return (int)cudaGetLastError();
}

int variant_push(int variant, const float* vals, float* out,
                 const float* plan, int sx, int sy, int sz, int tx, int ty,
                 int tz, int order, int batch, long long vstride,
                 void* stream) {
  const dim3 block(kPushLanesZ, kPushLanesY, kPushLanesX);
  dim3 grid = push_grid<kPushTX, kPushTY, kPushTZ, kPushLanesZ,
                        kPushLanesY, kPushLanesX>(tx, ty, tz);
  if (variant == 0) grid.z *= (unsigned)batch;
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0 && order == 0)
    push_zfold<0><<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty,
                                        tz, batch, vstride);
  else if (variant == 0)
    push_zfold<1><<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty,
                                        tz, batch, vstride);
  else if (order == 0)
    push_loop<0><<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty,
                                        tz, batch, vstride);
  else
    push_loop<1><<<grid, block, 0, s>>>(vals, out, plan, sx, sy, sz, tx, ty,
                                        tz, batch, vstride);
  return (int)cudaGetLastError();
}

int variant_pull_grad(int variant, const float* vol, float* out,
                      const float* m, int nx, int ny, int nz, int ox, int oy,
                      int oz, int batch, long long vstride, void* stream) {
  const int zb = (ox + kRowsX - 1) / kRowsX;
  const dim3 block(kGradLanesZ, kGradRowsY);
  const dim3 grid((unsigned)((oz + kGradLanesZ - 1) / kGradLanesZ),
                  (unsigned)((oy + kGradRowsY - 1) / kGradRowsY),
                  (unsigned)(zb * batch));
  cudaStream_t s = (cudaStream_t)stream;
  if (variant == 0)
    pull_grad_zfold<<<grid, block, 0, s>>>(vol, out, m, nx, ny, nz, ox, oy, oz,
                                          batch, vstride);
  else
    pull_grad_inter<<<grid, block, 0, s>>>(vol, out, m, nx, ny, nz, ox, oy,
                                           oz, batch, vstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
