// Static rank weighting of the sorted worker axis: x [B, n, d] -> [B, d].
//
// Replaces the TPU kernel repro/kernels/cwtm/cwtm.py:sorted_weight_kernel
// (launched by sorted_weighted_batched). The coordinate-wise trimmed mean
// (CWTM) and the coordinate-wise median are both this kernel: only the rank
// weights differ (1/(n-2f) on ranks [f, n-f) for CWTM, the middle rank(s)
// for the median).
//
// Bound: device memory. The kernel reads B*n*d values once and writes B*d;
// the sort costs sort_network_compares(N_PAD) min/max pairs per coordinate,
// far below the card's rate for that many bytes. Design for that bound:
//   * one thread per coordinate, grid (ceil(d/threads), B); for each worker
//     row, neighbouring threads read neighbouring addresses, so every load is
//     coalesced. The wrapper picks 256 threads a block, or 128 or 64 where
//     256 would leave SMs idle (the CNN's [1, 13, 11958] is 47 blocks of 256
//     on 132 SMs, 187 of 64), from its launch plan
//     (repro_torch/kernels/cwtm/cwtm.py: sorted_weight_threads);
//   * the n values of a coordinate live in registers, padded with +inf to
//     N_PAD (a power of two, a template parameter) so the padding sorts last;
//   * the bitonic network is unrolled at compile time: no data-dependent
//     branches, no shared memory, no second pass;
//   * the weights (at most 64 floats) travel by value as a kernel argument,
//     from a plan struct the wrapper builds once per shape and weight tuple,
//     so a call converts no weights on the host.
// The sum is taken in rank order in float32, skipping zero weights and
// multiplying only by weights other than one, as the TPU kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxThreads = 256;

struct RankWeights {
  float w[kMaxN];
};

}  // namespace

// The launch plan, built once per (B, n, d, dtype, weights, device) by the
// wrapper (repro_torch/kernels/cwtm/cwtm.py: PlanStruct).
struct SortedWeightPlan {
  long long d;
  int B;
  int n;
  int dtype;    // 0 = float32, 1 = bfloat16
  int threads;  // 64, 128 or 256 a block
  RankWeights weights;  // weights.w[i] scales the i-th smallest value
};

namespace {

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <int N_PAD>
__device__ __forceinline__ void bitonic_sort(float (&v)[N_PAD]) {
#pragma unroll
  for (int k = 2; k <= N_PAD; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N_PAD; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const float lo = fminf(v[i], v[l]);
          const float hi = fmaxf(v[i], v[l]);
          const bool ascending = (i & k) == 0;
          v[i] = ascending ? lo : hi;
          v[l] = ascending ? hi : lo;
        }
      }
    }
  }
}

template <int N_PAD, typename T>
__global__ void __launch_bounds__(kMaxThreads)
sorted_weight_kernel(const T* __restrict__ x, T* __restrict__ out,
                     RankWeights weights, int n, long long d) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const long long b = blockIdx.y;
  const T* col = x + b * n * d + j;
  float v[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i)
    v[i] = i < n ? load_as_float(col + (long long)i * d) : CUDART_INF_F;
  bitonic_sort<N_PAD>(v);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) {
    if (i < n) {
      const float w = weights.w[i];
      if (w != 0.0f) acc += (w == 1.0f) ? v[i] : v[i] * w;
    }
  }
  store_from_float(out + b * d + j, acc);
}

template <typename T>
cudaError_t launch(const void* x, void* out, const SortedWeightPlan& p,
                   cudaStream_t stream) {
  const unsigned t = (unsigned)p.threads;
  const dim3 grid((unsigned)((p.d + t - 1) / t), (unsigned)p.B);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const RankWeights& w = p.weights;
  int n_pad = 2;
  while (n_pad < p.n) n_pad <<= 1;
  switch (n_pad) {
    case 2: sorted_weight_kernel<2, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d); break;
    case 4: sorted_weight_kernel<4, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d); break;
    case 8: sorted_weight_kernel<8, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d); break;
    case 16: sorted_weight_kernel<16, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d); break;
    case 32: sorted_weight_kernel<32, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d); break;
    case 64: sorted_weight_kernel<64, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x: [B, n, d], out: [B, d], both of plan->dtype, contiguous. plan: the
// launch plan (see SortedWeightPlan), weights past n zero. Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream`.
extern "C" int sorted_weight(const void* x, void* out, const void* plan,
                             void* stream) {
  if (x == nullptr || out == nullptr || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const SortedWeightPlan& p = *static_cast<const SortedWeightPlan*>(plan);
  if (p.n < 1 || p.n > kMaxN || p.B < 1 || p.B > 65535 || p.d < 1)
    return (int)cudaErrorInvalidValue;
  if (p.threads != 64 && p.threads != 128 && p.threads != 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.dtype == 0) {
    err = launch<float>(x, out, p, s);
  } else if (p.dtype == 1) {
    err = launch<__nv_bfloat16>(x, out, p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
