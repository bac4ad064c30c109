// Block-RandK compress and decompress over an [n, d] bank of worker rows.
//
// Replaces the TPU kernels repro/kernels/randk/randk.py:_compress_kernel
// (launched by block_compress) and :_decompress_kernel (launched by
// block_decompress). The reference runs them one row at a time under
// lax.map; here one launch covers all n rows.
//
//   compress:   payload[r, j*bs + t] = cast(alpha * float(g[r, ids[j]*bs + t]))
//   decompress: dense[r, i*bs + t]   = slot >= 0 ? payload[r, slot*bs + t] : 0
//               with slot = slots[r][i] (-1 = block i not selected)
//
// Ids are one [kb] vector shared by every row (a global mask, row stride 0)
// or [n, kb] (local masks, row stride kb); the slot map likewise [nb] or
// [n, nb].
//
// Bound: device memory. Compress reads the kb selected blocks of each row
// and writes the payload; decompress reads the payload and writes the whole
// dense bank. No arithmetic to speak of. Design for that bound:
//   * one thread block per (selected block, row) for compress and per
//     (destination block, row) for decompress, grid (blocks, n);
//   * each thread moves one 16-byte vector along the block (4 float32 or 8
//     bfloat16 values), so a block of 512 float32 values is 128 threads and
//     every load and store is a coalesced 16-byte access;
//   * decompress writes every destination block exactly once: the selected
//     ones from the payload, the others with zeros; no memset pass first.
// Compress multiplies in float32 and rounds once to the payload's type, as
// the TPU kernel does (randk.py:36).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
