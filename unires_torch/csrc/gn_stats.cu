// The rigid Gauss-Newton statistics of the fit for Hopper (sm_90a): the 72
// float64 spatial moments of the three gradient volumes G_d = gr_d * diff and
// the six Hessian weights W_p = (gr_a * gr_b) * ctc, taken in one pass over
// the pulled gradient gr (X, Y, Z, 3), the back-projected residual diff
// (X, Y, Z) and, for super-resolution, ctc (X, Y, Z).
//
// Semantics (unires_torch/ops/gn_stats.py states them plainly, as
// gn_moments_plain: nine products stacked into two volumes, then the float64
// sums of solvers/rigid.py::_moments; no TPU kernel computed them: the JAX
// package leaves the moments to XLA's fused reductions). Over centred voxel
// coordinates ci[i], cj[j], ck[k] (float64 vectors), a volume V has the
// moments (m0, mi, mj, mk) at order 1 and (m0, mi, mj, mk, mii, mjj, mkk,
// mij, mik, mjk) at order 2, m0 = sum V, mi = sum V ci, mij = sum V ci cj,
// ...; the output is G_0..G_2's 4 each, then W_0..W_5's 10 each, W's pairs
// (0,0), (1,1), (2,2), (0,1), (0,2), (1,2). Each product is rounded in
// float32 as the plain chain rounds it, then widened to float64; every sum is
// a float64 sum. Only the order of the float64 sums differs from the plain
// chain's.
//
// Bound: memory. The plain chain writes and reads nine product volumes and
// casts each to float64 once for every marginal it takes, ~850 bytes a voxel;
// the statistics need 20 (gr's 12, diff's 4, ctc's 4; 16 without ctc), read
// once. A warp covers 32 consecutive voxels of a row along z, so its loads
// are coalesced (gr's interleaved triples are three loads of 12-byte stride,
// which L1 serves from the same lines). A thread keeps one column (i, k)
// and walks it along y, holding 24 float64 sums: sum w, sum w cj, sum w cj^2
// of each W and sum g, sum g cj of each G. ci and ck are fixed for the whole
// walk, so the thread folds them in once, at its end, and writes nothing the
// size of a volume. The float64 work (nine float32-to-float64 conversions
// and 24 adds a voxel) stays under the bytes' time.
//
// Determinism: a block of 32 (z) x 4 (y) threads covers one x plane, 32
// columns and up to kMaxRows rows of y. Its threads' sums meet in shared
// memory in a fixed order, warp 0 folds them into its columns' 72 moments,
// and 72 threads each add their moment over the 32 columns in order: one
// float64 partial per moment and block, written to a scratch the wrapper
// allocates. A second launch adds each moment's partials in a fixed order.
// No floating-point atomics: a rerun gives the same moments to the bit.
//
// Batches: B volumes are one launch over a (blocks, X, B) grid, each volume's
// partials apart, so a subject of a batch gets its single fit's moments.
//
// Plain C interface (returning cudaGetLastError() after the launches),
// loaded with ctypes by unires_torch/ops/cuda_build.py. Both kernels launch on
// the caller's stream, never synchronise and allocate nothing; each counts its
// launches in the device counter, as the other kernels of the port do.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;     // threads of a block along z: one warp
constexpr int kWarps = 4;      // threads of a block along y
constexpr int kMaxRows = 128;  // rows of y a block covers at most
constexpr int kSums = 24;      // a column's float64 sums
constexpr int kMoments = 72;   // G's 3 x 4 and W's 6 x 10
constexpr int kPitch = 73;     // shared row of a column's moments (no bank
                               // conflicts between its 32 columns)
constexpr int kReduceThreads = 256;
constexpr int kMaxGrid = 65535;  // grid y (x planes) and z (volumes)

struct Blocks {
  int nk, nj, rows;  // blocks along z and y, rows of y a block
};

Blocks blocks_of(int Y, int Z) {
  Blocks b;
  b.nk = (Z + kLanes - 1) / kLanes;
  b.nj = (Y + kMaxRows - 1) / kMaxRows;
  b.rows = (Y + b.nj - 1) / b.nj;
  return b;
}

__device__ __forceinline__ void count_launch(unsigned long long* cnt) {
  if (cnt != nullptr &&
      (blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y) == 0)
    atomicAdd(cnt, 1ULL);
}

// Block (kc + nk jc, i, b): columns k = 32 kc + lane of plane i, rows
// [jc rows, (jc + 1) rows) of y, volume b. Its 72 partials land at
// partial[(b * 72 + m) * nblk + blk], blk = (i nj + jc) nk + kc.
template <bool CTC>
__global__ void __launch_bounds__(kLanes * kWarps)
    partials_kernel(const float* __restrict__ gr,
                    const float* __restrict__ diff,
                    const float* __restrict__ ctc,
                    const double* __restrict__ ci,
                    const double* __restrict__ cj,
                    const double* __restrict__ ck, int Y, int Z, Blocks nb,
                    long long gstride, long long dstride, long long cstride,
                    double* __restrict__ partial, int nblk,
                    unsigned long long* cnt) {
  __shared__ double sh[kLanes * kPitch];
  count_launch(cnt);
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int kc = blockIdx.x % nb.nk, jc = blockIdx.x / nb.nk;
  const int i = blockIdx.y, b = blockIdx.z;
  const int k = kc * kLanes + lane;
  const int j1 = min((jc + 1) * nb.rows, Y);
  double s[kSums];
#pragma unroll
  for (int t = 0; t < kSums; ++t) s[t] = 0.0;
  if (k < Z) {
    const float* __restrict__ g3 = gr + b * gstride;
    const float* __restrict__ dv = diff + b * dstride;
    const float* __restrict__ cv = CTC ? ctc + b * cstride : nullptr;
#pragma unroll 4
    for (int j = jc * nb.rows + warp; j < j1; j += kWarps) {
      const int v = (i * Y + j) * Z + k;
      float g[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) g[d] = __ldg(g3 + 3 * v + d);
      const float dd = __ldg(dv + v);
      const float cc = CTC ? __ldg(cv + v) : 1.0f;
      const double y1 = __ldg(cj + j), y2 = y1 * y1;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const double p = (double)__fmul_rn(g[d], dd);
        s[2 * d] += p;
        s[2 * d + 1] = fma(p, y1, s[2 * d + 1]);
      }
      // W's pairs, as ops/gn_stats.py's PAIRS
      float wp[6] = {__fmul_rn(g[0], g[0]), __fmul_rn(g[1], g[1]),
                     __fmul_rn(g[2], g[2]), __fmul_rn(g[0], g[1]),
                     __fmul_rn(g[0], g[2]), __fmul_rn(g[1], g[2])};
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        const double p = (double)(CTC ? __fmul_rn(wp[q], cc) : wp[q]);
        s[6 + 3 * q] += p;
        s[6 + 3 * q + 1] = fma(p, y1, s[6 + 3 * q + 1]);
        s[6 + 3 * q + 2] = fma(p, y2, s[6 + 3 * q + 2]);
      }
    }
  }
  // warps 1-3 hand their sums to warp 0 (layout [warp - 1][sum][lane])
  if (warp > 0) {
#pragma unroll
    for (int t = 0; t < kSums; ++t)
      sh[((warp - 1) * kSums + t) * kLanes + lane] = s[t];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int t = 0; t < kSums; ++t)
      for (int u = 0; u < kWarps - 1; ++u)
        s[t] += sh[(u * kSums + t) * kLanes + lane];
    __syncwarp();
    // fold ci and ck into this column's moments (row `lane`, pitch kPitch;
    // a column past the volume's end holds zeros)
    const double x1 = __ldg(ci + i), z1 = k < Z ? __ldg(ck + k) : 0.0;
    double* f = sh + lane * kPitch;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const double s0 = s[2 * d], s1 = s[2 * d + 1];
      f[4 * d] = s0;
      f[4 * d + 1] = x1 * s0;
      f[4 * d + 2] = s1;
      f[4 * d + 3] = z1 * s0;
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const double s0 = s[6 + 3 * q], s1 = s[6 + 3 * q + 1],
                   s2 = s[6 + 3 * q + 2];
      double* m = f + 12 + 10 * q;
      m[0] = s0;
      m[1] = x1 * s0;
      m[2] = s1;
      m[3] = z1 * s0;
      m[4] = (x1 * x1) * s0;
      m[5] = s2;
      m[6] = (z1 * z1) * s0;
      m[7] = x1 * s1;
      m[8] = (x1 * z1) * s0;
      m[9] = z1 * s1;
    }
  }
  __syncthreads();
  const int t = warp * kLanes + lane;
  if (t < kMoments) {
    double acc = 0.0;
    for (int c = 0; c < kLanes; ++c) acc += sh[c * kPitch + t];
    const int blk = (i * nb.nj + jc) * nb.nk + kc;
    partial[((long long)b * kMoments + t) * nblk + blk] = acc;
  }
}

// Block (m, b): moment m of volume b, the sum of its nblk partials, each
// thread's stride in order, then a tree of fixed pairs.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_kernel(const double* __restrict__ partial, int nblk,
                  double* __restrict__ out, unsigned long long* cnt) {
  __shared__ double sh[kReduceThreads];
  count_launch(cnt);
  const int m = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const double* src = partial + ((long long)b * kMoments + m) * nblk;
  double acc = 0.0;
  for (int r = t; r < nblk; r += kReduceThreads) acc += src[r];
  sh[t] = acc;
  __syncthreads();
  for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
    if (t < h) sh[t] += sh[t + h];
    __syncthreads();
  }
  if (t == 0) out[b * kMoments + m] = sh[0];
}

}  // namespace

extern "C" {

// The float64 partials unires_gn_moments needs for each volume of a grid
// (X, Y, Z): 72 a block (< 2^31 for X <= 65535 and X Y Z < 2^31).
int unires_gn_partials(int X, int Y, int Z) {
  const Blocks nb = blocks_of(Y, Z);
  return kMoments * nb.nk * nb.nj * X;
}

// gr: B volumes (X, Y, Z, 3), each C-contiguous, volume b at gr + b *
// gstride; diff (X, Y, Z) at diff + b * dstride; ctc null (no weight) or
// (X, Y, Z) at ctc + b * cstride (0: one volume for all). ci, cj, ck: the
// centred coordinates (X, Y, Z float64). partial: B x unires_gn_partials
// float64 of scratch; out: (B, 72) float64. X Y Z 3 < 2^31: the wrapper
// checks. cnt: null or the device counter (u64).
int unires_gn_moments(const float* gr, const float* diff, const float* ctc,
                      const double* ci, const double* cj, const double* ck,
                      int X, int Y, int Z, int batch, long long gstride,
                      long long dstride, long long cstride, double* partial,
                      double* out, unsigned long long* cnt, void* stream) {
  if (X < 1 || Y < 1 || Z < 1 || batch < 1) return (int)cudaSuccess;
  if (X > kMaxGrid || batch > kMaxGrid)
    return (int)cudaErrorInvalidConfiguration;
  const Blocks nb = blocks_of(Y, Z);
  const int nblk = nb.nk * nb.nj * X;
  const dim3 grid((unsigned)(nb.nk * nb.nj), (unsigned)X, (unsigned)batch);
  const dim3 block(kLanes, kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  if (ctc != nullptr)
    partials_kernel<true><<<grid, block, 0, s>>>(
        gr, diff, ctc, ci, cj, ck, Y, Z, nb, gstride, dstride, cstride,
        partial, nblk, cnt);
  else
    partials_kernel<false><<<grid, block, 0, s>>>(
        gr, diff, ctc, ci, cj, ck, Y, Z, nb, gstride, dstride, cstride,
        partial, nblk, cnt);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  reduce_kernel<<<dim3(kMoments, (unsigned)batch), kReduceThreads, 0, s>>>(
      partial, nblk, out, cnt);
  return (int)cudaGetLastError();
}

}  // extern "C"
