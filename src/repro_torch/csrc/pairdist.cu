// Pairwise squared distances over the worker axis: x [B, n, d] -> [B, n, n].
//
// Replaces the TPU kernel repro/kernels/pairdist/pairdist.py:pairdist_kernel
// (launched by pairdist_pallas_batched). It feeds NNM's neighbour ranking and
// Krum's scores.
//
// Bound: device memory. The function reads B*n*d values once; the Gram matrix
// costs n(n+1)/2 multiply-adds per coordinate, well below the card's float32
// rate for those bytes. The TPU kernel walks d sequentially, carrying the Gram
// block from one grid step to the next; Hopper's blocks run in parallel and in
// no order, so the reduction over d takes two passes:
//   Pass 1, grid (S, B): block s owns a contiguous chunk of d. It stages
//     [n_pad, 128] tiles in shared memory (coalesced loads along d, rows past n
//     zero) and accumulates the upper triangle of the Gram partial in float32
//     FMA: each thread owns one 4x4 block of (i, j) pairs and a stride of the
//     tile's columns, so each shared-memory load feeds two FMAs. No TF32 and
//     no tensor cores (TF32 misses the 1e-5 parity bar). The threads' sums are
//     reduced in shared memory in a fixed order and written to a float32
//     scratch [B, n_pad, n_pad, S] that the caller allocates.
//   Pass 2, grid (B): one warp per upper entry sums its S partials (lanes
//     stride over s, then a butterfly), and the block finalises
//     max(G_ii + G_jj - 2 G_ij, 0). The squared norms are G's own diagonal, so
//     the diagonal of the result is exactly 0 and the result is symmetric.
// There are no atomics: every launch with the same inputs and S gives the
// same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kTile = 128;
constexpr int kThreads = 256;
constexpr int kFinalizeThreads = 1024;

__device__ __forceinline__ float load_as_float(const float* p) { return *p; }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Upper-triangle block pair number p -> (bi, bj), bi <= bj < nb.
__device__ __forceinline__ void block_pair(int p, int nb, int* bi, int* bj) {
  int i = 0;
  while (p >= nb - i) {
    p -= nb - i;
    ++i;
  }
  *bi = i;
  *bj = i + p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int n, int n_pad, long long d, int tiles_per_split,
                    int n_splits) {
  extern __shared__ float smem[];
  constexpr int stride = kTile + 1;  // odd row stride: rows fall on other banks
  float* tile = smem;                // [n_pad][stride]
  const int nb = n_pad / 4;
  const int nbp = nb * (nb + 1) / 2;
  const int phases = kThreads / nbp;
  float* red = smem + n_pad * stride;  // [phases][nbp][16]

  const int tid = threadIdx.x;
  const int bp = tid % nbp;
  const int ph = tid / nbp;
  const bool active = ph < phases;
  int bi, bj;
  block_pair(bp, nb, &bi, &bj);

  const int s = blockIdx.x;
  const long long b = blockIdx.y;
  const T* xb = x + b * n * d;
  const long long c_begin = (long long)s * tiles_per_split * kTile;
  long long c_end = c_begin + (long long)tiles_per_split * kTile;
  if (c_end > d) c_end = d;

  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;

  for (long long c0 = c_begin; c0 < c_end; c0 += kTile) {
    __syncthreads();
    for (int e = tid; e < n_pad * kTile; e += kThreads) {
      const int r = e / kTile;
      const int c = e % kTile;
      const long long col = c0 + c;
      tile[r * stride + c] =
          (r < n && col < c_end) ? load_as_float(xb + (long long)r * d + col)
                                 : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int c = ph; c < kTile; c += phases) {
        float a[4], v[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = tile[(bi * 4 + r) * stride + c];
          v[r] = tile[(bj * 4 + r) * stride + c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r * 4 + q] = fmaf(a[r], v[q], acc[r * 4 + q]);
        }
      }
    }
  }

  if (active) {
#pragma unroll
    for (int k = 0; k < 16; ++k) red[(ph * nbp + bp) * 16 + k] = acc[k];
  }
  __syncthreads();
  for (int e = tid; e < nbp * 16; e += kThreads) {
    const int p = e / 16;
    const int k = e % 16;
    float g = 0.0f;
    for (int q = 0; q < phases; ++q) g += red[(q * nbp + p) * 16 + k];
    int pi, pj;
    block_pair(p, nb, &pi, &pj);
    const int i = pi * 4 + k / 4;
    const int j = pj * 4 + k % 4;
    partial[((b * n_pad + i) * n_pad + j) * n_splits + s] = g;
  }
}

__global__ void __launch_bounds__(kFinalizeThreads)
gram_finalize_kernel(const float* __restrict__ partial,
                     float* __restrict__ out, int n, int n_pad,
                     int n_splits) {
  __shared__ float g[kMaxN * kMaxN];
  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_upper = n * (n + 1) / 2;
  for (int e = warp; e < n_upper; e += n_warps) {
    int i = 0, rem = e;
    while (rem >= n - i) {
      rem -= n - i;
      ++i;
    }
    const int j = i + rem;
    const float* p = partial + ((b * n_pad + i) * n_pad + j) * n_splits;
    float sum = 0.0f;
    for (int k = lane; k < n_splits; k += 32) sum += p[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) g[i * n + j] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n;
    const int j = e % n;
    const float gij = i <= j ? g[i * n + j] : g[j * n + i];
    out[b * n * n + e] = fmaxf(g[i * n + i] + g[j * n + j] - 2.0f * gij, 0.0f);
  }
}

template <typename T>
cudaError_t launch(const void* x, float* partial, float* out, int B, int n,
                   int n_pad, long long d, int n_splits, int tiles_per_split,
                   cudaStream_t stream) {
  const int nb = n_pad / 4;
  const int nbp = nb * (nb + 1) / 2;
  const int phases = kThreads / nbp;
  const size_t smem =
      sizeof(float) * ((size_t)n_pad * (kTile + 1) + (size_t)phases * nbp * 16);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gram_partial_kernel<T><<<dim3((unsigned)n_splits, (unsigned)B), kThreads,
                           smem, stream>>>(static_cast<const T*>(x), partial,
                                           n, n_pad, d, tiles_per_split,
                                           n_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gram_finalize_kernel<<<(unsigned)B, kFinalizeThreads, 0, stream>>>(
      partial, out, n, n_pad, n_splits);
  return cudaGetLastError();
}

}  // namespace

// x: [B, n, d] (dtype 0 = float32, 1 = bfloat16), contiguous.
// partial: float32 scratch of B * n_pad * n_pad * n_splits values, n_pad the
// multiple of 4 at or above n. out: float32 [B, n, n].
// The d axis is cut into n_splits chunks of tiles_per_split * 128 columns.
// Returns the launches' cudaError_t (0 on success); both run on `stream`.
extern "C" int pairdist(const void* x, void* partial, void* out, int B, int n,
                        long long d, int n_splits, int tiles_per_split,
                        int dtype, void* stream) {
  if (n < 1 || n > kMaxN || B < 1 || B > 65535 || d < 1 || n_splits < 1 ||
      tiles_per_split < 1 ||
      (long long)n_splits * tiles_per_split * kTile < d)
    return (int)cudaErrorInvalidValue;
  const int n_pad = (n + 3) / 4 * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, p, o, B, n, n_pad, d, n_splits, tiles_per_split, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, p, o, B, n, n_pad, d, n_splits,
                                tiles_per_split, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
