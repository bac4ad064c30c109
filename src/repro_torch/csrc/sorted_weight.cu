// Static rank weighting of the sorted worker axis: x [B, n, d] -> [B, d].
//
// Replaces the TPU kernel repro/kernels/cwtm/cwtm.py:sorted_weight_kernel
// (launched by sorted_weighted_batched). The coordinate-wise trimmed mean
// (CWTM) and the coordinate-wise median are both this kernel: only the rank
// weights differ (1/(n-2f) on ranks [f, n-f) for CWTM, the middle rank(s)
// for the median).
//
// Bound: device memory. The kernel reads B*n*d values once and writes B*d;
// the sort costs sort_network_compares(N_PAD) min/max pairs per coordinate.
// float32 inputs (sorted_weight_kernel<N_PAD, float>):
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
// bfloat16, float16 and float8_e4m3fn inputs (dtype codes 1-3, those of
// randk.cu; sorted_weight_pairs_kernel). One scalar load and one float32
// sort a value left these classes far from their bytes bound (a first
// port: float8 at [1, 8, 416179200] 4.06 ms against 1.12, float16 3.92
// against 2.24 on an H100 80GB HBM3):
// a warp issued as many requests as at float32 for a quarter or half the
// bytes, and the float32 network cost 48 min/max a coordinate at n = 8.
// So here:
//   * each thread owns V adjacent coordinates (vec_of: 8 at N_PAD 8, 4 at
//     N_PAD 16, so V * N_PAD values fit in 32 registers) and reads each
//     worker row in one load of V * itemsize bytes (16 or 8 at the LLM
//     path's shapes), or in loads of the widest width
//     the row addresses allow (the plan's `width`: a misaligned tensor or a
//     d * itemsize that is no multiple of it); a thread past the last full
//     vector loads element by element;
//   * the values sort two coordinates an instruction: float16 and float8
//     widen exactly to half (float8 in pairs, cvt.rn.f16x2.e4m3x2) and sort
//     in f16x2, bfloat16 in bf16x2, by min.NaN/max.NaN, which order values,
//     infinities and NaN as the float32 network does;
//   * a coordinate whose smallest rank is NaN (a NaN among its values) alone
//     takes the float32 kernel's second sort (its values loaded again, each
//     NaN as +inf, the NaNs put back on the top ranks), or is NaN under
//     nan_out;
//   * where V coordinates a thread would leave an SM fewer than 512 threads
//     (the CNN's [1, 13, 11958]: latency, not bytes, bounds it) the plan
//     takes vec 1, and the float32 kernel runs on the narrow values, a
//     coordinate a thread, as the first port did;
//   * the sorted values widen to float32 and sum in rank order as above, a
//     rank at a time over the V coordinates (each addition and product
//     rounded, as the float32 kernel's), so every result keeps the float32
//     class's bits; the results round to the input's dtype two at a time
//     and store in one vector a row.
//
// The result is stored in the input's dtype, rounded to nearest even once.
// A float8 store gives NaN (with the value's sign) past 464, for inf and for
// NaN, as the reference's cast and randk.cu's store do
// (repro_torch/utils/dtypes.py: to_float8). The padding past n is +inf in
// float32 or half registers, never a float8 value: float8_e4m3fn has no inf
// (the TPU kernel pads in the input's dtype, so its float8 padding is NaN).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxThreads = 256;

// Coordinates a thread of the narrow classes owns: at most a 16-byte load a
// row, and at most 64 values, packed two to a register (32 registers; at
// float8 twice that ran at 1.8x the time at [1, 8, 416179200] on an H100:
// half the threads resident); at least one pair. The wrapper's plan takes
// the same rule (repro_torch/kernels/cwtm/cwtm.py: vec_of).
__host__ __device__ constexpr int vec_of(int n_pad, int esize) {
  return esize >= 4 ? 1
       : (64 / n_pad < 2 ? 2
          : (64 / n_pad > 16 / esize ? 16 / esize : 64 / n_pad));
}

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
  int vec;      // coordinates a thread: 1 at float32, else vec_of(N_PAD, size)
  int width;    // bytes a load: vec * itemsize, or the widest power of two
                // below it that x, out and d * itemsize are aligned to
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

// ---- bfloat16, float16 and float8_e4m3fn: V coordinates a thread ----

// A pair of narrow values as a 32-bit register: f16x2 (float16, and
// float8 widened exactly to half) or bf16x2 (bfloat16). The low half holds
// the even coordinate.
template <typename T>
constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
template <typename T>
constexpr unsigned kInf2 = kBf16<T> ? 0x7F807F80u : 0x7C007C00u;

template <bool BF>
__device__ __forceinline__ unsigned min2_nan(unsigned a, unsigned b) {
  unsigned r;
  if constexpr (BF)
    asm("min.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  else
    asm("min.NaN.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
template <bool BF>
__device__ __forceinline__ unsigned max2_nan(unsigned a, unsigned b) {
  unsigned r;
  if constexpr (BF)
    asm("max.NaN.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  else
    asm("max.NaN.f16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The float32 network's stages on P packed pairs a row.
template <int N_PAD, int P, bool BF>
__device__ __forceinline__ void bitonic_sort_pairs(unsigned (&v)[N_PAD][P]) {
#pragma unroll
  for (int k = 2; k <= N_PAD; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N_PAD; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const bool ascending = (i & k) == 0;
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const unsigned lo = min2_nan<BF>(v[i][q], v[l][q]);
            const unsigned hi = max2_nan<BF>(v[i][q], v[l][q]);
            v[i][q] = ascending ? lo : hi;
            v[l][q] = ascending ? hi : lo;
          }
        }
      }
    }
  }
}

// Lane `hi` of a pair: its 16 bits, as float32 (exact), and whether NaN.
template <bool BF>
__device__ __forceinline__ float lane_float(unsigned pair, bool hi) {
  const unsigned h = hi ? pair >> 16 : pair & 0xFFFFu;
  if constexpr (BF) return __uint_as_float(h << 16);
  return __half2float(__ushort_as_half((unsigned short)h));
}
template <bool BF>
__device__ __forceinline__ bool lane_nan(unsigned pair, bool hi) {
  const unsigned h = hi ? pair >> 16 : pair & 0xFFFFu;
  return (h & 0x7FFFu) > (BF ? 0x7F80u : 0x7C00u);
}

// The raw bytes of V narrow values (BYTES = V * itemsize) in 32-bit words,
// the first value in the low bits (2 bytes: the low half of one word).
template <int BYTES>
struct Raw {
  unsigned w[(BYTES + 3) / 4];
};

// BYTES bytes at p, in loads of W bytes (p aligned to W).
template <int BYTES, int W>
__device__ __forceinline__ void load_raw(const void* p, Raw<BYTES>& r) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
  if constexpr (W == 16) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k) {
      const uint4 q = *reinterpret_cast<const uint4*>(c + 16 * k);
      r.w[4 * k] = q.x, r.w[4 * k + 1] = q.y;
      r.w[4 * k + 2] = q.z, r.w[4 * k + 3] = q.w;
    }
  } else if constexpr (W == 8) {
#pragma unroll
    for (int k = 0; k < BYTES / 8; ++k) {
      const uint2 q = *reinterpret_cast<const uint2*>(c + 8 * k);
      r.w[2 * k] = q.x, r.w[2 * k + 1] = q.y;
    }
  } else if constexpr (W == 4) {
#pragma unroll
    for (int k = 0; k < BYTES / 4; ++k)
      r.w[k] = *reinterpret_cast<const unsigned*>(c + 4 * k);
  } else if constexpr (W == 2) {
#pragma unroll
    for (int k = 0; k < BYTES / 2; ++k) {
      const unsigned h = *reinterpret_cast<const unsigned short*>(c + 2 * k);
      r.w[k / 2] = (k % 2) ? (r.w[k / 2] | (h << 16)) : h;
    }
  } else {
#pragma unroll
    for (int k = 0; k < BYTES; ++k) {
      const unsigned b = c[k];
      r.w[k / 4] = (k % 4) ? (r.w[k / 4] | (b << (8 * (k % 4)))) : b;
    }
  }
}

// The first `left` (< V) values at p, one element load each; zero past them.
template <int BYTES, int ES>
__device__ __forceinline__ void load_raw_tail(const void* p, int left,
                                              Raw<BYTES>& r) {
  const unsigned char* c = static_cast<const unsigned char*>(p);
#pragma unroll
  for (int k = 0; k < (BYTES + 3) / 4; ++k) r.w[k] = 0u;
#pragma unroll
  for (int e = 0; e < BYTES / ES; ++e) {
    if (e < left) {
      const unsigned v = ES == 2
          ? (unsigned)*reinterpret_cast<const unsigned short*>(c + 2 * e)
          : (unsigned)c[e];
      r.w[e * ES / 4] |= v << (8 * ((e * ES) % 4));
    }
  }
}

// Raw bytes -> P packed pairs: 16-bit values as they are, float8 widened
// two at a time to f16x2 (exact).
template <typename T, int BYTES, int P>
__device__ __forceinline__ void to_pairs(const Raw<BYTES>& r,
                                         unsigned (&v)[P]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if constexpr (sizeof(T) == 2) {
      v[q] = r.w[q];
    } else {
      const unsigned short f8x2 =
          (unsigned short)((r.w[q / 2] >> (16 * (q % 2))) & 0xFFFFu);
      unsigned h2;
      asm("cvt.rn.f16x2.e4m3x2 %0, %1;" : "=r"(h2) : "h"(f8x2));
      v[q] = h2;
    }
  }
}

// float32 -> float8_e4m3fn bits, as store_from_float(E4M3*) rounds: `cvt`
// the satfinite conversion's byte for v, which is already the zero of v's
// sign up to 2^-10 (nearest even: 2^-10 is half the least subnormal); past
// 464, for inf and for NaN, the NaN of v's sign.
__device__ __forceinline__ unsigned e4m3_bits(float v, unsigned cvt) {
  return fabsf(v) <= 464.0f ? cvt : (signbit(v) ? 0xFFu : 0x7Fu);
}

// V float32 results -> their narrow bits (rounded to nearest even), two at
// a time.
template <typename T, int V>
__device__ __forceinline__ void pack(const float (&acc)[V],
                                     Raw<V * (int)sizeof(T)>& r) {
#pragma unroll
  for (int k = 0; k < (V * (int)sizeof(T) + 3) / 4; ++k) r.w[k] = 0u;
#pragma unroll
  for (int q = 0; q < V / 2; ++q) {
    const float lo = acc[2 * q], hi = acc[2 * q + 1];
    if constexpr (kBf16<T>) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
      r.w[q] = *reinterpret_cast<const unsigned*>(&b);
    } else if constexpr (sizeof(T) == 2) {
      const __half2 h = __floats2half2_rn(lo, hi);
      r.w[q] = *reinterpret_cast<const unsigned*>(&h);
    } else {
      unsigned short c;
      asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;"
          : "=h"(c) : "f"(hi), "f"(lo));
      const unsigned two = e4m3_bits(lo, c & 0xFFu) |
                           (e4m3_bits(hi, (unsigned)c >> 8) << 8);
      r.w[q / 2] |= two << (16 * (q % 2));
    }
  }
}

// BYTES bytes to p, in stores of W bytes (p aligned to W).
template <int BYTES, int W>
__device__ __forceinline__ void store_raw(void* p, const Raw<BYTES>& r) {
  unsigned char* c = static_cast<unsigned char*>(p);
  if constexpr (W == 16) {
#pragma unroll
    for (int k = 0; k < BYTES / 16; ++k)
      *reinterpret_cast<uint4*>(c + 16 * k) =
          make_uint4(r.w[4 * k], r.w[4 * k + 1], r.w[4 * k + 2],
                     r.w[4 * k + 3]);
  } else if constexpr (W == 8) {
#pragma unroll
    for (int k = 0; k < BYTES / 8; ++k)
      *reinterpret_cast<uint2*>(c + 8 * k) =
          make_uint2(r.w[2 * k], r.w[2 * k + 1]);
  } else if constexpr (W == 4) {
#pragma unroll
    for (int k = 0; k < BYTES / 4; ++k)
      *reinterpret_cast<unsigned*>(c + 4 * k) = r.w[k];
  } else if constexpr (W == 2) {
#pragma unroll
    for (int k = 0; k < BYTES / 2; ++k)
      *reinterpret_cast<unsigned short*>(c + 2 * k) =
          (unsigned short)(r.w[k / 2] >> (16 * (k % 2)));
  } else {
#pragma unroll
    for (int k = 0; k < BYTES; ++k)
      c[k] = (unsigned char)(r.w[k / 4] >> (8 * (k % 4)));
  }
}

// The first `left` values of r to p, one element store each.
template <int BYTES, int ES>
__device__ __forceinline__ void store_raw_tail(void* p, int left,
                                               const Raw<BYTES>& r) {
  unsigned char* c = static_cast<unsigned char*>(p);
#pragma unroll
  for (int e = 0; e < BYTES / ES; ++e) {
    if (e < left) {
      const unsigned v = r.w[e * ES / 4] >> (8 * ((e * ES) % 4));
      if constexpr (ES == 2)
        *reinterpret_cast<unsigned short*>(c + 2 * e) = (unsigned short)v;
      else
        c[e] = (unsigned char)v;
    }
  }
}

// One coordinate whose values hold a NaN, as sorted_weight_kernel's second
// sort: its values loaded again as float32, each NaN as +inf, sorted, the
// NaNs put back on the top ranks; then the rank-weighted sum. The rows are
// read through one pointer stepped by d (indexed as col + i * d, the
// compiler kept the strides i * d live through the pairs kernel and, at
// N_PAD 32 on float8, spilled 8 B of them).
template <int N_PAD, typename T>
__device__ __forceinline__ float nan_last_sum(const T* col, int n, long long d,
                                              const RankWeights& weights) {
  float v[N_PAD];
  int nans = 0;
  const T* row = col;
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) {
    float xi = CUDART_INF_F;
    if (i < n) {
      xi = load_as_float(row);
      row += d;
    }
    nans += isnan(xi) ? 1 : 0;
    v[i] = isnan(xi) ? CUDART_INF_F : xi;
  }
  bitonic_sort<N_PAD>(v);
#pragma unroll
  for (int i = 0; i < N_PAD; ++i)
    if (i >= n - nans) v[i] = CUDART_NAN_F;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) {
    if (i < n) {
      const float w = weights.w[i];
      if (w != 0.0f) acc += (w == 1.0f) ? v[i] : v[i] * w;
    }
  }
  return acc;
}

// V coordinates a thread, read W bytes a load (module comment). The grid
// is (ceil(ceil(d / V) / threads), B).
template <int N_PAD, int V, int W, typename T>
__global__ void __launch_bounds__(kMaxThreads)
sorted_weight_pairs_kernel(const T* __restrict__ x, T* __restrict__ out,
                           RankWeights weights, int n, long long d,
                           int nan_out) {
  constexpr int ES = sizeof(T);
  constexpr int BYTES = V * ES;
  constexpr int P = V / 2;
  constexpr bool BF = kBf16<T>;
  const long long j0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (j0 >= d) return;
  const long long b = blockIdx.y;
  const T* col = x + b * n * d + j0;
  const bool full = j0 + V <= d;
  const int left = full ? V : (int)(d - j0);
  unsigned v[N_PAD][P];
  if (full) {
#pragma unroll
    for (int i = 0; i < N_PAD; ++i) {
      if (i < n) {
        Raw<BYTES> r;
        load_raw<BYTES, W>(col + (long long)i * d, r);
        to_pairs<T, BYTES, P>(r, v[i]);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) v[i][q] = kInf2<T>;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N_PAD; ++i) {
      if (i < n) {
        Raw<BYTES> r;
        load_raw_tail<BYTES, ES>(col + (long long)i * d, left, r);
        to_pairs<T, BYTES, P>(r, v[i]);
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) v[i][q] = kInf2<T>;
      }
    }
  }
  bitonic_sort_pairs<N_PAD, P, BF>(v);
  // a NaN among a coordinate's values sorts to its rank 0 (min.NaN); the
  // max.NaN of the rank-0 pairs tells whether any lane holds one
  unsigned any = v[0][0];
#pragma unroll
  for (int q = 1; q < P; ++q) any = max2_nan<BF>(any, v[0][q]);
  unsigned nan_mask = 0u;
  if (lane_nan<BF>(any, false) || lane_nan<BF>(any, true)) {
#pragma unroll
    for (int c = 0; c < V; ++c)
      if (lane_nan<BF>(v[0][c / 2], c & 1)) nan_mask |= 1u << c;
  }
  // the float32 kernel's sum, a rank at a time over the V coordinates (its
  // weight's tests uniform): acc + v, or acc + v * w, each rounded
  float acc[V];
#pragma unroll
  for (int c = 0; c < V; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < N_PAD; ++i) {
    if (i < n) {
      const float w = weights.w[i];
      if (w == 1.0f) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          acc[c] = __fadd_rn(acc[c], lane_float<BF>(v[i][c / 2], c & 1));
      } else if (w != 0.0f) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          acc[c] = __fadd_rn(
              acc[c], __fmul_rn(lane_float<BF>(v[i][c / 2], c & 1), w));
      }
    }
  }
  if (nan_mask) {
    // a NaN among these values: only its coordinate takes the second sort
#pragma unroll 1
    for (int c = 0; c < V; ++c) {
      if (!((nan_mask >> c) & 1u)) continue;
      const float s = nan_out ? CUDART_NAN_F
                              : nan_last_sum<N_PAD, T>(col + c, n, d, weights);
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (k == c) acc[k] = s;
    }
  }
  Raw<BYTES> r;
  pack<T, V>(acc, r);
  if (full)
    store_raw<BYTES, W>(out + b * d + j0, r);
  else
    store_raw_tail<BYTES, ES>(out + b * d + j0, left, r);
}

template <typename T, int N_PAD>
cudaError_t launch_pairs(const void* x, void* out, const SortedWeightPlan& p,
                         cudaStream_t stream) {
  constexpr int ES = sizeof(T);
  constexpr int V = vec_of(N_PAD, ES);
  constexpr int BYTES = V * ES;
  const unsigned t = (unsigned)p.threads;
  const long long threads = (p.d + V - 1) / V;
  const dim3 grid((unsigned)((threads + t - 1) / t), (unsigned)p.B);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const RankWeights& w = p.weights;
  switch (p.width) {
#define SW_PAIRS_CASE(WIDTH)                                                 \
    case WIDTH:                                                              \
      if constexpr (BYTES >= WIDTH && WIDTH >= ES) {                         \
        sorted_weight_pairs_kernel<N_PAD, V, WIDTH, T>                       \
            <<<grid, t, 0, stream>>>(xp, op, w, p.n, p.d, p.nan_out);        \
        return cudaGetLastError();                                           \
      }                                                                      \
      break;
    SW_PAIRS_CASE(16)
    SW_PAIRS_CASE(8)
    SW_PAIRS_CASE(4)
    SW_PAIRS_CASE(2)
    SW_PAIRS_CASE(1)
#undef SW_PAIRS_CASE
    default: break;
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const void* x, void* out, const SortedWeightPlan& p,
                   cudaStream_t stream);

// vec 1: the float32 kernel on narrow values, a coordinate a thread (the
// plan takes it where V coordinates a thread would leave an SM fewer than
// 512 threads: at [1, 13, 11958] on an H100 it read 1.8 µs of device time,
// V = 4 5.3); else the pairs kernel.
template <typename T>
cudaError_t launch_narrow(const void* x, void* out, const SortedWeightPlan& p,
                          cudaStream_t stream) {
  int n_pad = 2;
  while (n_pad < p.n) n_pad <<= 1;
  if (p.vec == 1) return launch<T>(x, out, p, stream);
  if (p.vec != vec_of(n_pad, (int)sizeof(T))) return cudaErrorInvalidValue;
  switch (n_pad) {
    case 2: return launch_pairs<T, 2>(x, out, p, stream);
    case 4: return launch_pairs<T, 4>(x, out, p, stream);
    case 8: return launch_pairs<T, 8>(x, out, p, stream);
    case 16: return launch_pairs<T, 16>(x, out, p, stream);
    case 32: return launch_pairs<T, 32>(x, out, p, stream);
    case 64: return launch_pairs<T, 64>(x, out, p, stream);
    default: return cudaErrorInvalidValue;
  }
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

// x: [B, n, d], out: [B, d], both of plan->dtype, contiguous, aligned to
// plan->width. plan: the launch plan (see SortedWeightPlan), weights past n
// zero. Returns the
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
  if (p.dtype < 0 || p.dtype > 3) return (int)cudaErrorInvalidValue;
  // the load width: a power of two the addresses and rows are aligned to
  const int es = p.dtype == 0 ? 4 : (p.dtype == 3 ? 1 : 2);
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) |
                      reinterpret_cast<uintptr_t>(out);
  if (p.width < es || p.width > 16 || (p.width & (p.width - 1)) ||
      a % p.width || (p.d * es) % p.width)
    return (int)cudaErrorInvalidValue;
  if (p.vec == 1 && p.width != es) return (int)cudaErrorInvalidValue;
  if (p.dtype == 0 && p.vec != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p.dtype == 0) {
    err = launch<float>(x, out, p, s);
  } else if (p.dtype == 1) {
    err = launch_narrow<__nv_bfloat16>(x, out, p, s);
  } else if (p.dtype == 2) {
    err = launch_narrow<__half>(x, out, p, s);
  } else {
    err = launch_narrow<E4M3>(x, out, p, s);
  }
  return (int)err;
}
