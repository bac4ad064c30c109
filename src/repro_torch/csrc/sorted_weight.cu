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
//   * one thread per coordinate, 256 threads per block, grid (ceil(d/256), B);
//     for each worker row, neighbouring threads read neighbouring addresses,
//     so every load is coalesced;
//   * the n values of a coordinate live in registers, padded with +inf to
//     N_PAD (a power of two, a template parameter) so the padding sorts last;
//   * the bitonic network is unrolled at compile time: no data-dependent
//     branches, no shared memory, no second pass;
//   * the weights (at most 64 floats) travel by value as a kernel argument.
// The sum is taken in rank order in float32, skipping zero weights and
// multiplying only by weights other than one, as the TPU kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kThreads = 256;

struct RankWeights {
  float w[kMaxN];
};

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
__global__ void __launch_bounds__(kThreads)
sorted_weight_kernel(const T* __restrict__ x, T* __restrict__ out,
                     RankWeights weights, int n, long long d) {
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
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
cudaError_t launch(const void* x, void* out, const RankWeights& w, int B,
                   int n, long long d, cudaStream_t stream) {
  const dim3 grid((unsigned)((d + kThreads - 1) / kThreads), (unsigned)B);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  int n_pad = 2;
  while (n_pad < n) n_pad <<= 1;
  switch (n_pad) {
    case 2: sorted_weight_kernel<2, T><<<grid, kThreads, 0, stream>>>(xp, op, w, n, d); break;
    case 4: sorted_weight_kernel<4, T><<<grid, kThreads, 0, stream>>>(xp, op, w, n, d); break;
    case 8: sorted_weight_kernel<8, T><<<grid, kThreads, 0, stream>>>(xp, op, w, n, d); break;
    case 16: sorted_weight_kernel<16, T><<<grid, kThreads, 0, stream>>>(xp, op, w, n, d); break;
    case 32: sorted_weight_kernel<32, T><<<grid, kThreads, 0, stream>>>(xp, op, w, n, d); break;
    case 64: sorted_weight_kernel<64, T><<<grid, kThreads, 0, stream>>>(xp, op, w, n, d); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. weights: n host floats. Returns the
// launch's cudaError_t (0 on success); the kernel runs on `stream`.
extern "C" int sorted_weight(const void* x, void* out, const void* weights,
                             int B, int n, long long d, int dtype,
                             void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || d < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B > 65535) return (int)cudaErrorInvalidValue;
  RankWeights w;
  const float* wh = static_cast<const float*>(weights);
  for (int i = 0; i < kMaxN; ++i) w.w[i] = i < n ? wh[i] : 0.0f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, out, w, B, n, d, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, out, w, B, n, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
