// Block-RandK compress, decompress and the fused RoSDHB momentum update
// over an [n, d] bank of worker rows.
//
// Replaces the TPU kernels repro/kernels/randk/randk.py:_compress_kernel
// (launched by block_compress), :_decompress_kernel (launched by
// block_decompress) and :_momentum_kernel (launched by momentum_scatter).
// The reference runs them one row at a time; here one launch covers all n
// rows.
//
//   compress:   payload[r, j*bs + t] = cast(alpha * float(g[r, ids[j]*bs + t]))
//   decompress: dense[r, i*bs + t]   = slot >= 0 ? payload[r, slot*bs + t] : 0
//   momentum:   m[r, i*bs + t] = cast(fmaf(beta, m, omb * p))     (f32 bank)
//               m[r, i*bs + t] = cast(fmaf(omb, p, beta * m))     (bf16 bank)
//               with p = slot >= 0 ? payload[r, slot*bs + t] : 0.0f,
//               slot = slots[r][i] (-1 = block i not selected),
//               omb = (float)(1 - beta), everything in float32
//
// Ids are one [kb] vector shared by every row (a global mask, row stride 0)
// or [n, kb] (local masks, row stride kb); the slot map likewise [nb] or
// [n, nb].
//
// Bound: device memory. Compress reads the kb selected blocks of each row
// and writes the payload; decompress reads the payload and writes the whole
// dense bank; the momentum update reads the bank and the payload and writes
// the bank (and the float32 copy, if asked). No arithmetic to speak of.
// Design for that bound:
//   * each thread moves one 16-byte vector along a block (4 float32, 8
//     bfloat16 or float16, 16 float8 values), so every load and store is a
//     coalesced 16-byte access: a block of 512 values is 128 threads in
//     float32, 64 in 16-bit types, 32 in float8;
//   * a thread block of decompress takes as many destination blocks of
//     one row as fill kThreads = 256 threads, and one of compress as many
//     selected blocks where a block is fewer than 64 vectors; grid
//     (ceil(blocks / group), n). With one 512-wide block a thread block,
//     1- and 2-byte types are bound by the rate at which the card starts
//     thread blocks, not by bytes: on an H100 80GB HBM3 at 700 W,
//     decompress of [8, 416179200] takes ~3.98 ms so in float16 and
//     float8 alike (bounds 2.09 and 1.04 ms), 2.46 and 1.26 grouped; and
//     compress 0.199 ms in float8 (bound 0.099), 0.141 grouped. Compress
//     reads scattered blocks: grouped, it is ~1.5% slower at 64 vectors
//     a block and more (float32, bfloat16, float16 at 512 values);
//   * decompress writes every destination block exactly once: the selected
//     ones from the payload, the others with zeros; no memset pass first.
// Compress multiplies in float32 and rounds once to the payload's type, as
// the TPU kernel does (randk.py:36).
//
// Banks and payloads are float32, bfloat16, float16 or float8_e4m3fn
// (dtype codes 0-3). Every value is widened to float32 for the arithmetic
// and rounded once to nearest even on store. float8_e4m3fn has no inf: the
// store gives NaN (with the value's sign) past the largest finite value
// after rounding (|x| > 464), for inf and for NaN, as the reference's cast
// does (PyTorch's own cast saturates to 448 instead; the port's plain
// versions round with utils/dtypes.py:to_float8, which this store matches
// bit for bit). A 16-byte vector holds 4 float32, 8 bfloat16 or float16 and
// 16 float8 values.
//
// The momentum update is RoSDHB's step 5 on the wire payload instead of a
// dense wire: every destination block of the bank is read once and written
// once (decayed, plus (1-beta) * payload where selected), in one thread
// block per (destination block, row), four values a thread. It rounds as
// the dense step does with wire = 0 off the selected blocks: one product,
// then one fused multiply-add; on a float32 bank `(wire * omb).add_(m,
// alpha=beta)` (float16 and float8 banks too), on a bfloat16 bank `(m *
// beta).add_(wire, alpha=omb)`, the products XLA contracts in the
// reference's compiled round. Off the
// blocks the fused add of a +0.0 product stays, not a bare beta * m, so
// that a -0.0 momentum gives +0.0 as the dense step's does. A bank
// narrower than float32 is updated in float32 and rounded once on store;
// the unrounded float32 result can be written to a second output too (the
// aggregation reads that one, as the reference aggregates the float32
// momentum and stores its rounding).
//
// A launch covers a window [b0, b1) of destination blocks (the whole bank
// is [0, nb)): only those are decayed and fed, block b0 + j reading
// slots[b0 + j], and the float32 result goes to an [n, (b1 - b0) * bs]
// output of row stride out_stride. The RoSDHB round at an LLM's width runs
// window after window into one reused float32 slice, aggregating each
// before the next (a float32 [n, d] copy of a bank of 2.1e9 columns would
// not fit the card); every value's arithmetic is the same in any window.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

// float8_e4m3fn values, moved as their bits
struct E4M3 {
  unsigned char x;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(E4M3 v) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(v.x, __NV_E4M3)));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
// Nearest even; NaN of v's sign past 464 (the rounding would pass 448),
// for +-inf and for NaN; a zero of v's sign up to 2^-10 (half the least
// subnormal, a tie that goes to even): the hardware conversion is left
// only the values in between, float32 subnormals never reach it.
template <>
__device__ __forceinline__ E4M3 from_f32<E4M3>(float v) {
  const float a = fabsf(v);
  const unsigned char sign = signbit(v) ? 0x80 : 0x00;
  E4M3 r;
  if (!(a <= 464.0f))
    r.x = sign | 0x7F;
  else if (a <= 0x1p-10f)
    r.x = sign;
  else
    r.x = (unsigned char)__nv_cvt_float_to_fp8(v, __NV_SATFINITE, __NV_E4M3);
  return r;
}

template <typename T>
__device__ __forceinline__ uint4 scale_vec(uint4 v, float alpha) {
  T* h = reinterpret_cast<T*>(&v);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i)
    h[i] = from_f32<T>(to_f32(h[i]) * alpha);
  return v;
}

constexpr int kThreads = 256;

// Blocks of `vecs` 16-byte vectors a thread block takes: one for a block
// of `alone` vectors or more, else enough to fill kThreads threads.
int group_of(int vecs, int alone) {
  return vecs >= alone ? 1 : kThreads / vecs;
}

// grid (ceil(kb / group), n), block (group * vecs): thread t moves vector
// t % vecs of selected block blockIdx.x * group + t / vecs
template <typename T>
__global__ void compress_kernel(const T* __restrict__ g,
                                const int* __restrict__ ids,
                                T* __restrict__ payload, long long d, int kb,
                                int bs, int ids_stride, float alpha,
                                int vecs) {
  const int j = blockIdx.x * (blockDim.x / vecs) + threadIdx.x / vecs;
  const int t = threadIdx.x % vecs;
  if (j >= kb) return;
  const long long r = blockIdx.y;
  const long long src_block = ids[r * ids_stride + j];
  const uint4* src = reinterpret_cast<const uint4*>(g + r * d + src_block * bs);
  uint4* dst = reinterpret_cast<uint4*>(payload + (r * kb + j) * (long long)bs);
  dst[t] = scale_vec<T>(src[t], alpha);
}

// grid (ceil(nb / group), n), block (group * vecs): thread t writes vector
// t % vecs of destination block blockIdx.x * group + t / vecs
template <typename T>
__global__ void decompress_kernel(const T* __restrict__ payload,
                                  const int* __restrict__ slots,
                                  T* __restrict__ dense, int nb, int kb,
                                  int bs, int slots_stride, int vecs) {
  const long long i = (long long)blockIdx.x * (blockDim.x / vecs) +
                      threadIdx.x / vecs;
  const int t = threadIdx.x % vecs;
  if (i >= nb) return;
  const long long r = blockIdx.y;
  const int slot = slots[r * slots_stride + i];
  uint4* dst = reinterpret_cast<uint4*>(dense + (r * nb + i) * bs);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (slot >= 0)
    v = reinterpret_cast<const uint4*>(payload + (r * kb + slot) *
                                       (long long)bs)[t];
  dst[t] = v;
}

// four values of T in one aligned access
template <int Bytes>
struct Word;
template <>
struct Word<16> {
  using type = uint4;
};
template <>
struct Word<8> {
  using type = uint2;
};
template <>
struct Word<4> {
  using type = uint32_t;
};

template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  using W = typename Word<4 * sizeof(T)>::type;
  const W w = *reinterpret_cast<const W*>(p);
  const T* h = reinterpret_cast<const T*>(&w);
  return make_float4(to_f32(h[0]), to_f32(h[1]), to_f32(h[2]), to_f32(h[3]));
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v) {
  using W = typename Word<4 * sizeof(T)>::type;
  W w;
  T* h = reinterpret_cast<T*>(&w);
  h[0] = from_f32<T>(v.x);
  h[1] = from_f32<T>(v.y);
  h[2] = from_f32<T>(v.z);
  h[3] = from_f32<T>(v.w);
  *reinterpret_cast<W*>(p) = w;
}

// grid (b1 - b0, n), block (bs / 4): thread t owns values 4t .. 4t+3 of
// destination block b0 + blockIdx.x
template <typename TM, typename TP>
__global__ void momentum_kernel(TM* __restrict__ m,
                                const TP* __restrict__ payload,
                                const int* __restrict__ slots,
                                float* __restrict__ out32, int nb, int b0,
                                int kb, int bs, int slots_stride,
                                long long out_stride, float beta,
                                float omb) {
  const long long j = blockIdx.x;
  const long long i = b0 + j;
  const long long r = blockIdx.y;
  const int slot = slots[r * slots_stride + i];
  const long long at = (r * nb + i) * bs + 4 * threadIdx.x;
  const float4 mv = load4(m + at);
  float4 o;
  // The dense step's rounding, chosen by the bank's dtype as XLA contracts
  // the reference's compiled round: fma(1-beta, p, beta m) on a bfloat16
  // bank, fma(beta, m, (1-beta) p) on the others. Off the selected blocks p
  // is +0.0, which turns a -0.0 momentum into +0.0 as there.
  constexpr bool kBf16Bank = std::is_same<TM, __nv_bfloat16>::value;
  float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (slot >= 0)
    p = load4(payload + (r * kb + slot) * (long long)bs + 4 * threadIdx.x);
  if (kBf16Bank) {
    o = make_float4(fmaf(omb, p.x, beta * mv.x), fmaf(omb, p.y, beta * mv.y),
                    fmaf(omb, p.z, beta * mv.z), fmaf(omb, p.w, beta * mv.w));
  } else {
    o = make_float4(fmaf(beta, mv.x, omb * p.x), fmaf(beta, mv.y, omb * p.y),
                    fmaf(beta, mv.z, omb * p.z), fmaf(beta, mv.w, omb * p.w));
  }
  store4(m + at, o);
  if (out32 != nullptr)
    store4(out32 + r * out_stride + j * bs + 4 * threadIdx.x, o);
}

// Calls f with a value of the type of dtype code 0-3; false for another.
template <typename F>
bool with_dtype(int dtype, F&& f) {
  switch (dtype) {
    case 0: f(float()); return true;
    case 1: f(__nv_bfloat16()); return true;
    case 2: f(__half()); return true;
    case 3: f(E4M3()); return true;
    default: return false;
  }
}

int itemsize_of(int dtype) {
  return dtype == 0 ? 4 : dtype == 3 ? 1 : 2;
}

bool shape_ok(int n, int bs, int itemsize, int blocks) {
  const long long bytes = (long long)bs * itemsize;
  return n >= 1 && n <= 65535 && bs >= 1 && bytes % 16 == 0 &&
         bytes / 16 <= 1024 && blocks >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16, 3 = float8_e4m3fn. g [n,
// d], ids int32 [kb] (ids_stride 0) or [n, kb] (ids_stride kb), payload [n,
// kb*bs]. Returns the launch's cudaError_t.
extern "C" int block_compress(const void* g, const void* ids, void* payload,
                              int n, long long d, int kb, int bs,
                              int ids_stride, float alpha, int dtype,
                              void* stream) {
  if (dtype < 0 || dtype > 3 || !shape_ok(n, bs, itemsize_of(dtype), kb) ||
      d % bs != 0)
    return (int)cudaErrorInvalidValue;
  const int vecs = bs * itemsize_of(dtype) / 16;
  const int group = group_of(vecs, 64);
  const dim3 grid((unsigned)((kb + group - 1) / group), (unsigned)n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idp = static_cast<const int*>(ids);
  with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    compress_kernel<T><<<grid, group * vecs, 0, s>>>(
        static_cast<const T*>(g), idp, static_cast<T*>(payload), d, kb, bs,
        ids_stride, alpha, vecs);
  });
  return (int)cudaGetLastError();
}

// payload [n, kb*bs], slots int32 [nb] (slots_stride 0) or [n, nb]
// (slots_stride nb), dense [n, nb*bs]; dtype as block_compress's. Returns
// the launch's cudaError_t.
extern "C" int block_decompress(const void* payload, const void* slots,
                                void* dense, int n, int nb, int kb, int bs,
                                int slots_stride, int dtype, void* stream) {
  if (dtype < 0 || dtype > 3 || !shape_ok(n, bs, itemsize_of(dtype), nb) ||
      kb < 1)
    return (int)cudaErrorInvalidValue;
  const int vecs = bs * itemsize_of(dtype) / 16;
  const int group = group_of(vecs, kThreads);
  const dim3 grid((unsigned)((nb + group - 1) / group), (unsigned)n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(slots);
  with_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    decompress_kernel<T><<<grid, group * vecs, 0, s>>>(
        static_cast<const T*>(payload), sp, static_cast<T*>(dense), nb, kb,
        bs, slots_stride, vecs);
  });
  return (int)cudaGetLastError();
}

// m [n, nb*bs] (updated in place on blocks b0 .. b1-1), payload [n,
// kb*bs], slots int32 [nb] (slots_stride 0) or [n, nb] (slots_stride nb),
// out32 float [n, (b1-b0)*bs] of row stride out_stride (a multiple of 4,
// at least (b1-b0)*bs) or null. m_dtype and p_dtype as block_compress's
// dtype. beta and omb = (float)(1 - beta) are the float32 constants.
// Returns the launch's cudaError_t.
extern "C" int momentum_scatter(void* m, const void* payload,
                                const void* slots, void* out32, int n, int nb,
                                int b0, int b1, int kb, int bs,
                                int slots_stride, long long out_stride,
                                float beta, float omb, int m_dtype,
                                int p_dtype, void* stream) {
  if (m_dtype < 0 || m_dtype > 3 || p_dtype < 0 || p_dtype > 3 ||
      n < 1 || n > 65535 || nb < 1 || kb < 1 || bs < 4 || bs % 4 != 0 ||
      bs / 4 > 1024 || b0 < 0 || b1 <= b0 || b1 > nb ||
      (out32 != nullptr &&
       (out_stride < (long long)(b1 - b0) * bs || out_stride % 4 != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(slots);
  float* o = static_cast<float*>(out32);
  const dim3 grid((unsigned)(b1 - b0), (unsigned)n);
  with_dtype(m_dtype, [&](auto tm) {
    with_dtype(p_dtype, [&](auto tp) {
      using TM = decltype(tm);
      using TP = decltype(tp);
      momentum_kernel<TM, TP><<<grid, bs / 4, 0, s>>>(
          static_cast<TM*>(m), static_cast<const TP*>(payload), sp, o, nb, b0,
          kb, bs, slots_stride, out_stride, beta, omb);
    });
  });
  return (int)cudaGetLastError();
}
