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
//   * one thread block per (selected block, row) for compress and per
//     (destination block, row) for decompress, grid (blocks, n);
//   * each thread moves one 16-byte vector along the block (4 float32 or 8
//     bfloat16 values), so a block of 512 float32 values is 128 threads and
//     every load and store is a coalesced 16-byte access;
//   * decompress writes every destination block exactly once: the selected
//     ones from the payload, the others with zeros; no memset pass first.
// Compress multiplies in float32 and rounds once to the payload's type, as
// the TPU kernel does (randk.py:36).
//
// The momentum update is RoSDHB's step 5 on the wire payload instead of a
// dense wire: every destination block of the bank is read once and written
// once (decayed, plus (1-beta) * payload where selected), in one thread
// block per (destination block, row), four values a thread. It rounds as
// the dense step does with wire = 0 off the selected blocks: one product,
// then one fused multiply-add; on a float32 bank `(wire * omb).add_(m,
// alpha=beta)`, on a bfloat16 bank `(m * beta).add_(wire, alpha=omb)`, the
// two products XLA contracts in the reference's compiled round. Off the
// blocks the fused add of a +0.0 product stays, not a bare beta * m, so
// that a -0.0 momentum gives +0.0 as the dense step's does. A
// bfloat16 bank is updated in float32 and rounded once to nearest even;
// the unrounded float32 result can be written to a second [n, d] output
// too (the aggregation reads that one, as the reference aggregates the
// float32 momentum and stores its bfloat16 rounding).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint4 scale_vec(uint4 v, float alpha, float) {
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x *= alpha; f.y *= alpha; f.z *= alpha; f.w *= alpha;
  return *reinterpret_cast<uint4*>(&f);
}

__device__ __forceinline__ uint4 scale_vec(uint4 v, float alpha,
                                           __nv_bfloat16) {
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = __float2bfloat16(__bfloat162float(h[i]) * alpha);
  return v;
}

// grid (kb, n), block (vectors per block)
template <typename T>
__global__ void compress_kernel(const T* __restrict__ g,
                                const int* __restrict__ ids,
                                T* __restrict__ payload, long long d, int kb,
                                int bs, int ids_stride, float alpha) {
  const int j = blockIdx.x;
  const long long r = blockIdx.y;
  const long long src_block = ids[r * ids_stride + j];
  const uint4* src = reinterpret_cast<const uint4*>(g + r * d + src_block * bs);
  uint4* dst = reinterpret_cast<uint4*>(payload + (r * kb + j) * (long long)bs);
  dst[threadIdx.x] = scale_vec(src[threadIdx.x], alpha, T());
}

// grid (nb, n), block (vectors per block)
template <typename T>
__global__ void decompress_kernel(const T* __restrict__ payload,
                                  const int* __restrict__ slots,
                                  T* __restrict__ dense, int nb, int kb,
                                  int bs, int slots_stride) {
  const long long i = blockIdx.x;
  const long long r = blockIdx.y;
  const int slot = slots[r * slots_stride + i];
  uint4* dst = reinterpret_cast<uint4*>(dense + (r * nb + i) * bs);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (slot >= 0)
    v = reinterpret_cast<const uint4*>(payload + (r * kb + slot) *
                                       (long long)bs)[threadIdx.x];
  dst[threadIdx.x] = v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
  h[0] = __float2bfloat16_rn(v.x);
  h[1] = __float2bfloat16_rn(v.y);
  h[2] = __float2bfloat16_rn(v.z);
  h[3] = __float2bfloat16_rn(v.w);
  *reinterpret_cast<uint2*>(p) = u;
}

// grid (nb, n), block (bs / 4): thread t owns values 4t .. 4t+3 of the
// destination block
template <typename TM, typename TP>
__global__ void momentum_kernel(TM* __restrict__ m,
                                const TP* __restrict__ payload,
                                const int* __restrict__ slots,
                                float* __restrict__ out32, int nb, int kb,
                                int bs, int slots_stride, float beta,
                                float omb) {
  const long long i = blockIdx.x;
  const long long r = blockIdx.y;
  const int slot = slots[r * slots_stride + i];
  const long long at = (r * nb + i) * bs + 4 * threadIdx.x;
  const float4 mv = load4(m + at);
  float4 o;
  // The dense step's rounding, chosen by the bank's dtype as XLA contracts
  // the reference's compiled round: fma(beta, m, (1-beta) p) on a float32
  // bank, fma(1-beta, p, beta m) on a bfloat16 one. Off the selected
  // blocks p is +0.0, which turns a -0.0 momentum into +0.0 as there.
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
  if (out32 != nullptr) store4(out32 + at, o);
}

template <typename TM, typename TP>
void launch_momentum(void* m, const void* payload, const int* slots,
                     float* out32, int n, int nb, int kb, int bs,
                     int slots_stride, float beta, float omb,
                     cudaStream_t s) {
  const dim3 grid((unsigned)nb, (unsigned)n);
  momentum_kernel<TM, TP><<<grid, bs / 4, 0, s>>>(
      static_cast<TM*>(m), static_cast<const TP*>(payload), slots, out32, nb,
      kb, bs, slots_stride, beta, omb);
}

bool shape_ok(int n, int bs, int itemsize, int blocks) {
  const long long bytes = (long long)bs * itemsize;
  return n >= 1 && n <= 65535 && bs >= 1 && bytes % 16 == 0 &&
         bytes / 16 <= 1024 && blocks >= 1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. g [n, d], ids int32 [kb] (ids_stride 0)
// or [n, kb] (ids_stride kb), payload [n, kb*bs]. Returns the launch's
// cudaError_t.
extern "C" int block_compress(const void* g, const void* ids, void* payload,
                              int n, long long d, int kb, int bs,
                              int ids_stride, float alpha, int dtype,
                              void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !shape_ok(n, bs, itemsize, kb) ||
      d % bs != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)kb, (unsigned)n);
  const int threads = bs * itemsize / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idp = static_cast<const int*>(ids);
  if (dtype == 0)
    compress_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(g), idp, static_cast<float*>(payload), d,
        kb, bs, ids_stride, alpha);
  else
    compress_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), idp,
        static_cast<__nv_bfloat16*>(payload), d, kb, bs, ids_stride, alpha);
  return (int)cudaGetLastError();
}

// payload [n, kb*bs], slots int32 [nb] (slots_stride 0) or [n, nb]
// (slots_stride nb), dense [n, nb*bs]. Returns the launch's cudaError_t.
extern "C" int block_decompress(const void* payload, const void* slots,
                                void* dense, int n, int nb, int kb, int bs,
                                int slots_stride, int dtype, void* stream) {
  const int itemsize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !shape_ok(n, bs, itemsize, nb) || kb < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nb, (unsigned)n);
  const int threads = bs * itemsize / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(slots);
  if (dtype == 0)
    decompress_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(payload), sp, static_cast<float*>(dense),
        nb, kb, bs, slots_stride);
  else
    decompress_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(payload), sp,
        static_cast<__nv_bfloat16*>(dense), nb, kb, bs, slots_stride);
  return (int)cudaGetLastError();
}

// m [n, nb*bs] (updated in place), payload [n, kb*bs], slots int32 [nb]
// (slots_stride 0) or [n, nb] (slots_stride nb), out32 float [n, nb*bs] or
// null. m_dtype and p_dtype: 0 = float32, 1 = bfloat16. beta and omb =
// (float)(1 - beta) are the float32 constants. Returns the launch's
// cudaError_t.
extern "C" int momentum_scatter(void* m, const void* payload,
                                const void* slots, void* out32, int n, int nb,
                                int kb, int bs, int slots_stride, float beta,
                                float omb, int m_dtype, int p_dtype,
                                void* stream) {
  if (m_dtype < 0 || m_dtype > 1 || p_dtype < 0 || p_dtype > 1 ||
      n < 1 || n > 65535 || nb < 1 || kb < 1 || bs < 4 || bs % 4 != 0 ||
      bs / 4 > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(slots);
  float* o = static_cast<float*>(out32);
  if (m_dtype == 0 && p_dtype == 0)
    launch_momentum<float, float>(m, payload, sp, o, n, nb, kb, bs,
                                  slots_stride, beta, omb, s);
  else if (m_dtype == 0)
    launch_momentum<float, __nv_bfloat16>(m, payload, sp, o, n, nb, kb, bs,
                                          slots_stride, beta, omb, s);
  else if (p_dtype == 0)
    launch_momentum<__nv_bfloat16, float>(m, payload, sp, o, n, nb, kb, bs,
                                          slots_stride, beta, omb, s);
  else
    launch_momentum<__nv_bfloat16, __nv_bfloat16>(m, payload, sp, o, n, nb,
                                                  kb, bs, slots_stride, beta,
                                                  omb, s);
  return (int)cudaGetLastError();
}
