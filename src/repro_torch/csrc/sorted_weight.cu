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
//     branches, no shared memory, no second pass. NaN sorts after every
//     number, +inf included, as torch.sort and jnp.sort order it
//     (fminf/fmaxf alone would drop a NaN and repeat another value; a
//     float8 bank's ALIE rows can hold NaN, and CWTM trims it as the plain
//     version does). The network's min and max propagate NaN (min.NaN,
//     max.NaN: one instruction each, as fminf and fmaxf are), so the
//     smallest rank is NaN exactly where a NaN is among the values; only
//     there the coordinate is sorted again with each NaN loaded as +inf,
//     counted, and put back on the top ranks. On an H100 80GB HBM3 at 700
//     W, CWTM at [1, 13, 1048576] read 28.4 µs with no NaN handling, 34.9
//     with a sum on load picking the NaN coordinates, and at [1, 8,
//     416179200] 4.79 ms, 8.79 with a compare-exchange that ordered NaN
//     itself;
//   * the weights (at most 64 floats) travel by value as a kernel argument,
//     from a plan struct the wrapper builds once per shape and weight tuple,
//     so a call converts no weights on the host.
// The sum is taken in rank order in float32, skipping zero weights and
// multiplying only by weights other than one, as the TPU kernel does.
//
// Inputs are float32, bfloat16, float16 or float8_e4m3fn (dtype codes 0-3,
// those of randk.cu), each value widened to float32 on load, as the TPU
// kernel widens it; the result is stored in the input's dtype, rounded to
// nearest even once. A float8 store gives NaN (with the value's sign) past
// 464, for inf and for NaN, as the reference's cast and randk.cu's store
// do (repro_torch/utils/dtypes.py: to_float8). The padding past n is +inf
// in float32 registers, never a float8 value: float8_e4m3fn has no inf (the
// TPU kernel pads in the input's dtype, so its float8 padding is NaN).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
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
  int dtype;    // 0 = float32, 1 = bfloat16, 2 = float16, 3 = float8_e4m3fn
  int threads;  // 64, 128 or 256 a block
  int nan_out;  // 1: NaN wherever a NaN is among the n values (the median)
  RankWeights weights;  // weights.w[i] scales the i-th smallest value
};

namespace {

// float8_e4m3fn values, moved as their bits
struct E4M3 {
  unsigned char x;
};

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_as_float(const __half* p) {
  return __half2float(*p);
}
__device__ __forceinline__ float load_as_float(const E4M3* p) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(p->x, __NV_E4M3)));
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store_from_float(__half* p, float v) {
  *p = __float2half_rn(v);
}
// Nearest even; NaN of v's sign past 464, for +-inf and for NaN; a zero of
// v's sign up to 2^-10 (randk.cu's from_f32<E4M3>).
__device__ __forceinline__ void store_from_float(E4M3* p, float v) {
  const float a = fabsf(v);
  const unsigned char sign = signbit(v) ? 0x80 : 0x00;
  if (!(a <= 464.0f))
    p->x = sign | 0x7F;
  else if (a <= 0x1p-10f)
    p->x = sign;
  else
    p->x = (unsigned char)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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
          const float lo = min_nan(v[i], v[l]);
          const float hi = max_nan(v[i], v[l]);
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
                     RankWeights weights, int n, long long d, int nan_out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  const long long b = blockIdx.y;
  const T* col = x + b * n * d + j;
  float v[N_PAD];
#pragma unroll
  for (int i = 0; i < N_PAD; ++i)
    v[i] = i < n ? load_as_float(col + (long long)i * d) : CUDART_INF_F;
  bitonic_sort<N_PAD>(v);
  if (isnan(v[0])) {
    // a NaN among the values: the median is NaN (jnp.median's quantile
    // gives NaN there); CWTM takes each NaN as +inf, then the top ranks of
    // the n values are the NaNs
    if (nan_out) {
      store_from_float(out + b * d + j, CUDART_NAN_F);
      return;
    }
    int nans = 0;
#pragma unroll
    for (int i = 0; i < N_PAD; ++i) {
      const float xi = i < n ? load_as_float(col + (long long)i * d)
                             : CUDART_INF_F;
      nans += isnan(xi) ? 1 : 0;
      v[i] = isnan(xi) ? CUDART_INF_F : xi;
    }
    bitonic_sort<N_PAD>(v);
#pragma unroll
    for (int i = 0; i < N_PAD; ++i)
      if (i >= n - nans) v[i] = CUDART_NAN_F;
  }
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
    case 2: sorted_weight_kernel<2, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d, p.nan_out); break;
    case 4: sorted_weight_kernel<4, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d, p.nan_out); break;
    case 8: sorted_weight_kernel<8, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d, p.nan_out); break;
    case 16: sorted_weight_kernel<16, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d, p.nan_out); break;
    case 32: sorted_weight_kernel<32, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d, p.nan_out); break;
    case 64: sorted_weight_kernel<64, T><<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d, p.nan_out); break;
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
  } else if (p.dtype == 2) {
    err = launch<__half>(x, out, p, s);
  } else if (p.dtype == 3) {
    err = launch<E4M3>(x, out, p, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
