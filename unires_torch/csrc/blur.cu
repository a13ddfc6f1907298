// The separable slice-profile blur of the super-resolution forward model for
// Hopper (sm_90a): one pass of the strided blur (VALID correlation at an
// integer stride along one axis) and one pass of its exact adjoint, each one
// launch that reads its input once and writes its output once.
//
// Semantics (unires_torch/ops/conv.py states them plainly, as _down_1d /
// _up_1d, the per-tap strided slice chains this file replaces; no TPU kernel
// computed them: the JAX package leaves the blur to XLA's fusions). A pass
// runs along the middle axis of a volume seen as (P, n, Q):
//   down  out[p, i, q] = sum_{t < K} k[t] * in[p, r i + t, q],
//         i < m = (n - K) / r + 1
//   up    out[p, j, q] = sum_{t < K} k[t] * v(j - t),   j < m = (n - 1) r + K,
//         v(s) = in[p, s / r, q] where r | s and 0 <= s / r < n, else 0
// The up pass is the gather form of the adjoint: it reads what the plain chain
// zero-stuffs and pads, and writes no intermediate. Both sum in increasing t,
// the first term assigned and the others added one by one, every product and
// sum rounded by an explicit _rn intrinsic (no FMA contraction): the plain
// chain's order and rounding, so each pass equals it on the card to the bit.
// The up pass multiplies the zeros of v too, so the signs of zeros match.
//
// Bound: memory. A pass needs ~2K float operations a voxel, against 8 bytes
// (input and output read and written once); a thread computes one output
// voxel, consecutive threads along q (or along i where Q = 1, the innermost
// axis), so a warp's loads and stores are coalesced, and the K taps' re-reads
// of a row hit L1 or L2. The taps (K <= kMaxTaps) and r are launch arguments.
// A thread finds its (p, i, q) by dividing by Q, m and r with a multiply-high
// by a magic number made on the host (FastDiv): a runtime integer division
// costs ~25 instructions, and five of them made the up pass, which computes
// r outputs for every input, bound by its instructions at 15 % of its bound.
//
// Every launch takes a batch of B volumes: the input's volumes lie istride
// floats apart (any stride), the output is contiguous. Each kernel counts its
// own launches in a device counter, as the other kernels of the port do.
//
// Plain C interface (one function per entry point, returning
// cudaGetLastError() after its launch, cudaSuccess where there is nothing to
// launch), loaded with ctypes by unires_torch/ops/cuda_build.py.
// Each kernel launches on the caller's stream, never synchronises and
// allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 64;
// grid y above the launch limit (a batch of thousands of volumes): refused
constexpr int kMaxGridY = 65535;

struct Taps {
  float k[kMaxTaps];
};

// Division of an unsigned n < 2^31 by a divisor d >= 1 fixed at launch:
// n / d = (umulhi(n, magic) + n) >> shift (Granlund and Montgomery; the
// form PyTorch's IntDivider uses). The sum fits 32 bits since n < 2^31.
struct FastDiv {
  unsigned d, magic, shift;
};

FastDiv make_div(unsigned d) {
  unsigned shift = 0;
  while (shift < 32 && (1ULL << shift) < d) ++shift;
  const unsigned long long magic =
      ((1ULL << 32) * ((1ULL << shift) - d)) / d + 1;
  return FastDiv{d, (unsigned)magic, shift};
}

__device__ __forceinline__ int quot(int n, FastDiv f) {
  return (int)((__umulhi((unsigned)n, f.magic) + (unsigned)n) >> f.shift);
}

__device__ __forceinline__ void count_launch(unsigned long long* cnt) {
  if (cnt != nullptr && (blockIdx.x | blockIdx.y | threadIdx.x) == 0)
    atomicAdd(cnt, 1ULL);
}

// One thread: output voxel e = (p, i, q) of volume b = blockIdx.y.
// total = P m Q < 2^31 and P n Q < 2^31: the wrapper checks.
__global__ void __launch_bounds__(kThreads)
    down_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
                FastDiv m, FastDiv nq, int total, int r, int K,
                long long istride, Taps taps, unsigned long long* cnt) {
  count_launch(cnt);
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int pi = quot(e, nq);
  const int q = e - pi * (int)nq.d;
  const int p = quot(pi, m);
  const int i = pi - p * (int)m.d;
  const float* __restrict__ src =
      in + blockIdx.y * istride + (p * n + r * i) * (int)nq.d + q;
  float acc = __fmul_rn(taps.k[0], __ldg(src));
#pragma unroll 4
  for (int t = 1; t < K; ++t)
    acc = __fadd_rn(acc, __fmul_rn(taps.k[t], __ldg(src + t * (int)nq.d)));
  out[(long long)blockIdx.y * total + e] = acc;
}

// One thread: output voxel e = (p, j, q) of volume b = blockIdx.y. The taps
// that meet an input voxel (the data taps) are t = ph + u r at s = sj - u,
// sj = j / r, ph = j - r sj. The plain chain's sum runs over all K taps from
// -0.0 (the additive identity, so the first term is as good as assigned);
// the other taps add a zero, which leaves a nonzero partial sum as it is and
// a zero one a zero, and 0 + x is x. So the sum over the data taps alone,
// in the same order, is the plain chain's wherever it is not zero; where it
// is zero, the signs of all K terms decide the sign of the result, and the
// thread sums them all.
__global__ void __launch_bounds__(kThreads)
    up_kernel(const float* __restrict__ in, float* __restrict__ out, int n,
              FastDiv m, FastDiv nq, int total, FastDiv r, int K,
              long long istride, Taps taps, unsigned long long* cnt) {
  count_launch(cnt);
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const int Q = (int)nq.d, R = (int)r.d;
  const int pj = quot(e, nq);
  const int q = e - pj * Q;
  const int p = quot(pj, m);
  const int j = pj - p * (int)m.d;
  const float* __restrict__ src = in + blockIdx.y * istride + p * n * Q + q;
  const int sj = quot(j, r);
  const int ph = j - sj * R;
  float acc = -0.0f;
#pragma unroll 2
  for (int t = ph, s = sj; t < K; t += R, --s) {
    const float v = (unsigned)s < (unsigned)n ? __ldg(src + s * Q) : 0.0f;
    acc = __fadd_rn(acc, __fmul_rn(taps.k[t], v));
  }
  if (acc == 0.0f) {
    acc = -0.0f;
    for (int t = 0, s = sj, next = ph; t < K; ++t) {
      float v = 0.0f;
      if (t == next) {
        if ((unsigned)s < (unsigned)n) v = __ldg(src + s * Q);
        next += R;
        --s;
      }
      acc = __fadd_rn(acc, __fmul_rn(taps.k[t], v));
    }
  }
  out[(long long)blockIdx.y * total + e] = acc;
}

template <bool UP>
int launch(const float* in, float* out, int pre, int n, int nq, int r,
           const float* k, int K, int batch, long long istride,
           unsigned long long* cnt, void* stream) {
  if (K < 1 || K > kMaxTaps || r < 1) return (int)cudaErrorInvalidValue;
  const long long m = UP ? (long long)(n - 1) * r + K
                         : (n < K ? 0 : (n - K) / r + 1);
  const long long total = (long long)pre * m * nq;
  if (n < 1 || nq < 1 || m < 1 || total * batch == 0)
    return (int)cudaSuccess;  // nothing to launch: no error of this pass
  if (batch > kMaxGridY || total >= (1LL << 31))
    return (int)cudaErrorInvalidConfiguration;
  Taps taps;
  for (int t = 0; t < kMaxTaps; ++t) taps.k[t] = t < K ? k[t] : 0.0f;
  const dim3 grid((unsigned)((total + kThreads - 1) / kThreads),
                  (unsigned)batch);
  const FastDiv dm = make_div((unsigned)m), dq = make_div((unsigned)nq);
  if (UP)
    up_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        in, out, n, dm, dq, (int)total, make_div((unsigned)r), K, istride,
        taps, cnt);
  else
    down_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        in, out, n, dm, dq, (int)total, r, K, istride, taps, cnt);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in: B volumes (pre, n, nq), each C-contiguous, volume b at in + b *
// istride -> out (B, pre, (n - K) / r + 1, nq) contiguous. k: K host floats
// (read during the call). cnt: null or the device counter (u64).
int unires_blur_down(const float* in, float* out, int pre, int n, int nq,
                     int r, const float* k, int K, int batch,
                     long long istride, unsigned long long* cnt,
                     void* stream) {
  return launch<false>(in, out, pre, n, nq, r, k, K, batch, istride, cnt,
                       stream);
}

// The adjoint of unires_blur_down: in (B, pre, n, nq) as down's -> out (B,
// pre, (n - 1) r + K, nq) contiguous.
int unires_blur_up(const float* in, float* out, int pre, int n, int nq, int r,
                   const float* k, int K, int batch, long long istride,
                   unsigned long long* cnt, void* stream) {
  return launch<true>(in, out, pre, n, nq, r, k, K, batch, istride, cnt,
                      stream);
}

}  // extern "C"
