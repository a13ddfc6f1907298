// The forward finite differences of the JTV prior for Hopper (sm_90a): the
// gradient D, its exact adjoint D^T (the divergence) and the membrane
// operator D^T D, each one pass over the volume.
//
// Semantics (unires_torch/ops/finite_diff.py states them plainly, as the
// zero-fill shift chains this file replaces; no TPU kernel computed them:
// the JAX package leaves them to XLA's fusions):
//   gradient    g_d[i]  = s * ((v[i + e_d] - v[i]) / vx_d),   v beyond the
//               last voxel 0 (Dirichlet bound)
//   divergence  out[i]  = s * sum_d (p_d[i - e_d] - p_d[i]) / vx_d,  p_d
//               before the first voxel 0, summed from 0 in axis order
//   membrane    out[i]  = s * divergence(gradient(v))[i]
// where s is an optional per-volume scale read from device memory (so that it
// may change between two replays of a captured CUDA graph). The divide by a
// voxel size is a multiply by its float32 reciprocal, which is how PyTorch's
// CUDA kernel divides a tensor by a Python number, and every product, sum and
// difference is rounded by an explicit _rn intrinsic in the plain chain's
// order (no FMA contraction), so each kernel equals the plain chain on the
// card to the bit.
//
// Bound: memory. A launch needs its input read once and its output written
// once (membrane: 8 bytes a voxel; gradient and divergence: 16); the
// arithmetic is ~20 float operations a voxel. Design, with the rejected
// variants' figures in PERF.md: divergence and membrane march a
// block of 32 (z) x 8 (y) threads along x over kChunkX planes, keeping the
// previous plane's value (membrane: its x difference) in registers, so each
// input voxel comes from device memory once (the chunk's halo plane and the
// y and z neighbours hit L1 or L2). The gradient, whose three outputs
// dominate its bytes, takes one voxel a thread: rows whose length is not a
// multiple of 32 (the fit's 189) split each warp's stores over two lines,
// and a march then keeps too few stores in flight. Nothing intermediate goes
// to device memory. The Dirichlet edges are selects on loads that a thread
// makes or skips as a whole (its y and z are fixed).
//
// Every launch takes a batch of B volumes, each C-contiguous (X, Y, Z); the
// input's volumes lie istride floats apart (any stride: a channel of a
// stacked state), the outputs are contiguous. Each kernel counts its own
// launches in a device counter, as the resampling kernels do.
//
// Plain C interface (one function per entry point, returning
// cudaGetLastError()), loaded with ctypes by unires_torch/ops/cuda_build.py.
// Each kernel launches on the caller's stream, never synchronises and
// allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kLanesZ = 32;
constexpr int kRowsY = 8;
constexpr int kChunkX = 16;

enum Mode { kDivergence, kMembrane };

// 1 / vx per axis, rounded to float32 on the host
struct Inv {
  float x, y, z;
};

__device__ __forceinline__ void count_launch(unsigned long long* cnt) {
  if (cnt != nullptr &&
      (blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y) == 0)
    atomicAdd(cnt, 1ULL);
}

// (next - cur) / vx: one forward difference, as the plain chain rounds it
__device__ __forceinline__ float fdiff(float next, float cur, float inv) {
  return __fmul_rn(__fsub_rn(next, cur), inv);
}

// the divergence's sum from 0 in axis order: 0 + a0 / vx0 turns -0 into +0,
// as the plain chain's zeros_like start does
__device__ __forceinline__ float div_sum(float a0, float a1, float a2,
                                         Inv inv) {
  float d = __fadd_rn(0.0f, __fmul_rn(a0, inv.x));
  d = __fadd_rn(d, __fmul_rn(a1, inv.y));
  return __fadd_rn(d, __fmul_rn(a2, inv.z));
}

// The block's voxel (x, y, z) of volume b = blockIdx.z / nx: g (3, X, Y, Z)
// of the volume's v. scale: null, or the volume's factor at scale[b *
// sstride].
__global__ void __launch_bounds__(kLanesZ * kRowsY)
    gradient_kernel(const float* __restrict__ in, float* __restrict__ out,
                    const float* __restrict__ scale, int sstride, int nx,
                    int ny, int nz, long long istride, Inv inv,
                    unsigned long long* cnt) {
  count_launch(cnt);
  const int z = blockIdx.x * kLanesZ + threadIdx.x;
  const int y = blockIdx.y * kRowsY + threadIdx.y;
  if (z >= nz || y >= ny) return;
  const int b = blockIdx.z / nx;
  const int x = blockIdx.z - b * nx;
  const long long n = (long long)nx * ny * nz;  // < 2^31: the wrapper checks
  const float* __restrict__ v = in + (long long)b * istride;
  float* __restrict__ o = out + 3 * n * b;
  const int i = (x * ny + y) * nz + z;
  const float vc = __ldg(v + i);
  float g0 = fdiff(x + 1 < nx ? __ldg(v + i + ny * nz) : 0.0f, vc, inv.x);
  float g1 = fdiff(y + 1 < ny ? __ldg(v + i + nz) : 0.0f, vc, inv.y);
  float g2 = fdiff(z + 1 < nz ? __ldg(v + i + 1) : 0.0f, vc, inv.z);
  if (scale != nullptr) {
    const float s = __ldg(scale + (long long)b * sstride);
    g0 = __fmul_rn(s, g0);
    g1 = __fmul_rn(s, g1);
    g2 = __fmul_rn(s, g2);
  }
  o[i] = g0;
  o[n + i] = g1;
  o[2 * n + i] = g2;
}

// One thread: the voxels (x, y, z) for x in [x0, min(x0 + kChunkX, nx)) of
// volume b = blockIdx.z / chunks. in: v (membrane) or p, the (3, X, Y, Z)
// field of each volume (divergence); out: (X, Y, Z) a volume. scale as
// gradient_kernel's.
template <int MODE>
__global__ void __launch_bounds__(kLanesZ * kRowsY)
    march_kernel(const float* __restrict__ in, float* __restrict__ out,
                 const float* __restrict__ scale, int sstride, int nx, int ny,
                 int nz, int chunks, long long istride, Inv inv,
                 unsigned long long* cnt) {
  count_launch(cnt);
  const int z = blockIdx.x * kLanesZ + threadIdx.x;
  const int y = blockIdx.y * kRowsY + threadIdx.y;
  if (z >= nz || y >= ny) return;
  const int b = blockIdx.z / chunks;
  const int x0 = (blockIdx.z - b * chunks) * kChunkX;
  const long long n = (long long)nx * ny * nz;  // < 2^31: the wrapper checks
  const int plane = ny * nz;
  const bool ylo = y > 0, yhi = y + 1 < ny, zlo = z > 0, zhi = z + 1 < nz;
  const float s = scale != nullptr ? __ldg(scale + (long long)b * sstride)
                                   : 1.0f;
  const float* __restrict__ v = in + (long long)b * istride;
  float* __restrict__ o = out + n * b;
  int i = (x0 * ny + y) * nz + z;
  // the value (divergence: p_0) or the x difference (membrane: g_0) at the
  // previous plane; 0 before the first (the zero fill)
  float prev;
  float vc = 0.0f;  // membrane: v at the current plane
  if (MODE == kDivergence) {
    prev = x0 > 0 ? __ldg(v + i - plane) : 0.0f;
  } else {
    vc = __ldg(v + i);
    prev = x0 > 0 ? fdiff(vc, __ldg(v + i - plane), inv.x) : 0.0f;
  }
  auto step = [&](int x) {
    float d;
    if (MODE == kDivergence) {
      const float* __restrict__ p1 = v + n;
      const float* __restrict__ p2 = v + 2 * n;
      const float q0 = __ldg(v + i);
      const float q1m = ylo ? __ldg(p1 + i - nz) : 0.0f;
      const float q2m = zlo ? __ldg(p2 + i - 1) : 0.0f;
      d = div_sum(__fsub_rn(prev, q0), __fsub_rn(q1m, __ldg(p1 + i)),
                  __fsub_rn(q2m, __ldg(p2 + i)), inv);
      prev = q0;
    } else {
      const float vn = x + 1 < nx ? __ldg(v + i + plane) : 0.0f;
      const float g0 = fdiff(vn, vc, inv.x);
      const float g1 = fdiff(yhi ? __ldg(v + i + nz) : 0.0f, vc, inv.y);
      const float g2 = fdiff(zhi ? __ldg(v + i + 1) : 0.0f, vc, inv.z);
      const float g1m = ylo ? fdiff(vc, __ldg(v + i - nz), inv.y) : 0.0f;
      const float g2m = zlo ? fdiff(vc, __ldg(v + i - 1), inv.z) : 0.0f;
      d = div_sum(__fsub_rn(prev, g0), __fsub_rn(g1m, g1),
                  __fsub_rn(g2m, g2), inv);
      prev = g0;
      vc = vn;
    }
    o[i] = scale != nullptr ? __fmul_rn(s, d) : d;
    i += plane;
  };
  const int x1 = min(x0 + kChunkX, nx);
#pragma unroll 4
  for (int x = x0; x < x1; ++x) step(x);
}

// grid z above the launch limit (a batch of thousands of volumes): refused
constexpr unsigned kMaxGridZ = 65535;

int launch_gradient(const float* in, float* out, const float* scale,
                    int sstride, int nx, int ny, int nz, int batch,
                    long long istride, Inv inv, unsigned long long* cnt,
                    void* stream) {
  if ((long long)nx * ny * nz * batch == 0) return (int)cudaGetLastError();
  if ((long long)nx * batch > kMaxGridZ)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kLanesZ, kRowsY);
  const dim3 grid((unsigned)((nz + kLanesZ - 1) / kLanesZ),
                  (unsigned)((ny + kRowsY - 1) / kRowsY),
                  (unsigned)(nx * batch));
  gradient_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      in, out, scale, sstride, nx, ny, nz, istride, inv, cnt);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_march(const float* in, float* out, const float* scale,
                 int sstride, int nx, int ny, int nz, int batch,
                 long long istride, Inv inv, unsigned long long* cnt,
                 void* stream) {
  if ((long long)nx * ny * nz * batch == 0) return (int)cudaGetLastError();
  const int chunks = (nx + kChunkX - 1) / kChunkX;
  if ((long long)chunks * batch > kMaxGridZ)
    return (int)cudaErrorInvalidConfiguration;
  const dim3 block(kLanesZ, kRowsY);
  const dim3 grid((unsigned)((nz + kLanesZ - 1) / kLanesZ),
                  (unsigned)((ny + kRowsY - 1) / kRowsY),
                  (unsigned)(chunks * batch));
  march_kernel<MODE><<<grid, block, 0, (cudaStream_t)stream>>>(
      in, out, scale, sstride, nx, ny, nz, chunks, istride, inv, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// v: B volumes (nx, ny, nz), volume b at v + b * vstride -> out (B, 3, nx,
// ny, nz) contiguous. scale: null or a device pointer, volume b's factor at
// scale[b * sstride] (sstride 0: one factor for all). (ix, iy, iz): the
// float32 reciprocals of the voxel sizes. cnt: null or the device counter
// (u64).
int unires_fd_gradient(const float* v, float* out, const float* scale,
                       int sstride, int nx, int ny, int nz, int batch,
                       long long vstride, float ix, float iy, float iz,
                       unsigned long long* cnt, void* stream) {
  return launch_gradient(v, out, scale, sstride, nx, ny, nz, batch, vstride,
                         Inv{ix, iy, iz}, cnt, stream);
}

// p: B fields (3, nx, ny, nz), each C-contiguous, field b at p + b *
// pstride -> out (B, nx, ny, nz) contiguous; other arguments as gradient's.
int unires_fd_divergence(const float* p, float* out, const float* scale,
                         int sstride, int nx, int ny, int nz, int batch,
                         long long pstride, float ix, float iy, float iz,
                         unsigned long long* cnt, void* stream) {
  return launch_march<kDivergence>(p, out, scale, sstride, nx, ny, nz, batch,
                                   pstride, Inv{ix, iy, iz}, cnt, stream);
}

// v as gradient's -> out (B, nx, ny, nz) contiguous: D^T D v, scaled.
int unires_fd_membrane(const float* v, float* out, const float* scale,
                       int sstride, int nx, int ny, int nz, int batch,
                       long long vstride, float ix, float iy, float iz,
                       unsigned long long* cnt, void* stream) {
  return launch_march<kMembrane>(v, out, scale, sstride, nx, ny, nz, batch,
                                 vstride, Inv{ix, iy, iz}, cnt, stream);
}

}  // extern "C"
