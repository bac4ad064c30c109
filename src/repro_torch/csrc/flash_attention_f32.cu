// Causal / sliding-window GQA flash attention in float32, forward and
// backward, on the CUDA cores (FFMA) of Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash.py:_flash_kernel
// (launched by flash_attention) on float32 inputs: that kernel casts q, k and
// v to float32, computes in float32 and writes q's dtype. The bf16 kernels of
// flash_attention.cu run their products on wgmma; tf32 wgmma would round
// every input to a 10-bit mantissa and miss the reference's float32, so
// these kernels use no mma, wgmma or tf32 instruction: every product is an
// FFMA. The backward is the FlashAttention-2 recomputation, as in the bf16
// file: a delta = rowsum(dO * O) pass, dk/dv per block of keys summed over
// the query heads of its kv head, dq per block of query rows.
//
// Layouts are the bf16 kernels': q, o, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, KV, D]; lse and delta [B, H, Sq]; all float32. Query row i sits at
// absolute position q_offset + i; key j is visible to it when j < Sk, j <=
// q_offset + i (causal) and j > q_offset + i - window (window > 0). Rows
// with no visible key are refused by the Python wrapper. The softmax scale is
// the caller's (1/sqrt of its own head dim where it zero-pads D).
//
// Bound: operations. At the train path's [1, 4096, 32, 80] the forward does
// 4*D flops per visible (query, key) pair, about 86 GFLOP on 84 MB of inputs
// and outputs: far above the card's 20 float32 operations per byte, so the
// FFMA rate (67 TFLOP/s) sets the floor. The design:
//   * 256 threads as a 16 x 16 grid. Every product is a tile of rows
//     (ty + 16 i) by columns (tx + 16 j) summed by FFMA from shared memory
//     into registers: dot_tile (S = Q K^T, dP = dO V^T: float4 loads along
//     D) and pv_tile (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K:
//     a thread holds D/16 output columns of each of its rows). Shared rows
//     are padded to D + 4 floats, so the 16-byte loads of 8 rows fall in
//     distinct banks.
//   * Forward: a block owns 64 query rows of one head, Q in shared memory;
//     key tiles of 64 keys (32 at D = 256) of K and V are double-buffered by
//     cp.async. The online softmax runs on the S fragment: row max across the
//     16 threads of a row by warp shuffles, each thread's partial row sum
//     rescaled with the row's max and summed once at the end; P goes through
//     shared memory into O += P V. O stays in registers until the epilogue
//     writes o and lse (natural log).
//   * Tiles no row of the block can see are never loaded; masks only on the
//     tiles that need them. Masked logits are -1e30 (the reference's NEG_INF)
//     and their probabilities exactly 0. Causal grids run the heaviest query
//     blocks first.
//   * Backward: delta a thread a row; dk/dv per 64 keys (32 at D = 256) of a
//     kv head, tiles of Q and dO (with their lse and delta) streamed over
//     every query head of the group; dq per 64 query rows, tiles of K and V
//     streamed. Every sum stays in one thread block, in a fixed order: no
//     atomics, two runs are bitwise equal. A streamed tile's products are
//     summed from zero and then added to the running sum, so a sum over S
//     keys or rows rounds as S / 64 sums of 64 terms.
// exp and log are the accurate expf and logf, divisions IEEE: the kernels'
// results differ from the float32 plain version only in summation order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kSide = 16;
constexpr int kRows = 64;      // query rows of a forward or dq block
constexpr float kNegInf = -1e30f;

// Tile sizes of head dim D: up to 128 a forward or dq stage streams 64 keys,
// a dk/dv block owns 64 keys and streams 64 query rows a tile; at 256 (whose
// shared rows are 1 KiB) 32 of each, so that a block's tiles fit the 227 KiB
// of shared memory it may use.
template <int D>
struct Tiles {
  static constexpr int kLd = D + 4;                  // floats a shared row
  static constexpr int kKeys = D > 128 ? 32 : 64;    // keys a stage or block
  static constexpr int kBwdRows = D > 128 ? 32 : 64; // query rows a dk/dv tile
};

struct Problem {
  int B, Sq, Sk, H, KV, causal, window, q_offset;
  float scale;
};

// Query row i (0 <= i) and key j visible, both in range.
__device__ __forceinline__ bool visible(const Problem& p, int i, int j) {
  if (i >= p.Sq || j >= p.Sk) return false;
  const int qpos = p.q_offset + i;
  if (p.causal && j > qpos) return false;
  if (p.window > 0 && j <= qpos - p.window) return false;
  return true;
}

// True when every pair of query rows [i0, i0 + rows) and keys [j0, j0 +
// keys) is visible and in range: no mask needed.
__device__ __forceinline__ bool all_visible(const Problem& p, int i0,
                                            int rows, int j0, int keys) {
  if (i0 + rows > p.Sq || j0 + keys > p.Sk) return false;
  const int qlo = p.q_offset + i0, qhi = qlo + rows - 1;
  if (p.causal && j0 + keys - 1 > qlo) return false;
  if (p.window > 0 && j0 <= qhi - p.window) return false;
  return true;
}

// First key (aligned down to `tile`) and end key of the keys some row of
// [i0, i0 + rows) can see.
__device__ __forceinline__ void key_range(const Problem& p, int i0, int rows,
                                          int tile, int* begin, int* end) {
  const int qlo = p.q_offset + i0;
  const int qhi = p.q_offset + min(i0 + rows, p.Sq) - 1;
  int e = p.Sk;
  if (p.causal) e = min(e, qhi + 1);
  int b = 0;
  if (p.window > 0) b = max(0, qlo - p.window + 1);
  *begin = (b / tile) * tile;
  *end = e;
}

// First query row (aligned down to `tile`) and end row of the rows that can
// see some key of [j0, j0 + keys).
__device__ __forceinline__ void query_range(const Problem& p, int j0,
                                            int keys, int tile, int* begin,
                                            int* end) {
  const int jlast = min(j0 + keys, p.Sk) - 1;
  int b = 0, e = p.Sq;
  if (p.causal) b = max(0, j0 - p.q_offset);
  if (p.window > 0) e = min(e, jlast + p.window - p.q_offset);
  *begin = (b / tile) * tile;
  *end = e;
}

__device__ __forceinline__ int tiles_between(int begin, int end, int tile) {
  return end > begin ? (end - begin + tile - 1) / tile : 0;
}

// ------------------------------------------------------------------------
// cp.async and warp sums
// ------------------------------------------------------------------------

// 16 bytes global -> shared; an invalid source (a row past S) writes zeros
// and reads nothing.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Max and sum over the 16 threads of a row (lanes tx = 0..15 of a half
// warp), in a fixed butterfly order.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// Rows [s0, s0 + ROWS) of head `hd` of a [B, S, heads, D] tensor into a
// shared [ROWS][D + 4] tile (rows past S zero-filled), issued by cp.async.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int s0, int S, int heads, int hd) {
  constexpr int kVec = D / 4;
  for (int c = threadIdx.x; c < ROWS * kVec; c += kThreads) {
    const int r = c / kVec, col = (c % kVec) * 4;
    const int s = s0 + r;
    const bool ok = s < S;
    const float* g =
        ok ? src + (((long long)b * S + s) * heads + hd) * D + col : src;
    cp_async16(dst + r * Tiles<D>::kLd + col, g, ok);
  }
}

// Per-row values of a [B, H, Sq] tensor for rows [i0, i0 + rows) into shared
// memory (0 past Sq); the caller synchronises before use.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          const Problem& p, int b, int h,
                                          int i0, int rows) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int i = i0 + r;
    dst[r] = i < p.Sq ? src[((long long)b * p.H + h) * p.Sq + i] : 0.0f;
  }
}

// ------------------------------------------------------------------------
// the two FFMA products
// ------------------------------------------------------------------------

// acc[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d], A and B [.][D + 4].
template <int D, int NI, int NJ>
__device__ __forceinline__ void dot_tile(float (&acc)[NI][NJ],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int kLd = Tiles<D>::kLd;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[NI], b[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + kSide * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + kSide * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][c] += sum_k P[ty + 16 i][k] * V[k][tx + 16 c] for k < K; P is
// [.][K + 16] (rows 16 floats apart in banks), V [K][D + 4]. The tile's sum
// starts from zero and is added to acc once: over S keys or rows a sum is
// rounded as S / K sums of K terms, not as one running sum of S.
template <int D, int NI, int K>
__device__ __forceinline__ void pv_tile(float (&acc)[NI][D / kSide],
                                        const float* P, const float* V,
                                        int ty, int tx) {
  constexpr int kLd = Tiles<D>::kLd, kPs = K + 16, NC = D / kSide;
  float part[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) part[i][c] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 pr[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      pr[i] = *reinterpret_cast<const float4*>(P + (ty + kSide * i) * kPs + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float vc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vc[c] = V[(k + kk) * kLd + tx + kSide * c];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float pik = kk == 0 ? pr[i].x : kk == 1 ? pr[i].y
                          : kk == 2 ? pr[i].z : pr[i].w;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          part[i][c] = fmaf(pik, vc[c], part[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] += part[i][c];
}

// ------------------------------------------------------------------------
// forward
// ------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kKeys = Tiles<D>::kKeys, kLd = Tiles<D>::kLd;
  static constexpr int kFloats =
      kRows * kLd + 4 * kKeys * kLd + kRows * (kKeys + 16);
  static constexpr int kBytes = kFloats * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Problem p) {
  constexpr int kKeys = Tiles<D>::kKeys, kLd = Tiles<D>::kLd;
  constexpr int NI = kRows / kSide, NJ = kKeys / kSide, NC = D / kSide;
  constexpr int kPs = kKeys + 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [64][kLd]
  float* sK = sQ + kRows * kLd;                  // [2][kKeys][kLd]
  float* sV = sK + 2 * kKeys * kLd;              // [2][kKeys][kLd]
  float* sP = sV + 2 * kKeys * kLd;              // [64][kPs]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int i0 = qb * kRows;
  const int kvh = h / (p.H / p.KV);
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;

  int kbeg, kend;
  key_range(p, i0, kRows, kKeys, &kbeg, &kend);
  const int ntiles = tiles_between(kbeg, kend, kKeys);
  load_tile<D, kRows>(sQ, q, b, i0, p.Sq, p.H, h);
  if (ntiles > 0) {
    load_tile<D, kKeys>(sK, k, b, kbeg, p.Sk, p.KV, kvh);
    load_tile<D, kKeys>(sV, v, b, kbeg, p.Sk, p.KV, kvh);
  }
  cp_commit();

  float m[NI], l[NI], acc[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int st = t & 1;
    const int j0 = kbeg + t * kKeys;
    if (t + 1 < ntiles) {
      // the other stage was last read in tile t - 1, before its closing
      // barrier
      load_tile<D, kKeys>(sK + (st ^ 1) * kKeys * kLd, k, b, j0 + kKeys,
                          p.Sk, p.KV, kvh);
      load_tile<D, kKeys>(sV + (st ^ 1) * kKeys * kLd, v, b, j0 + kKeys,
                          p.Sk, p.KV, kvh);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();

    float s[NI][NJ];
    dot_tile<D, NI, NJ>(s, sQ, sK + st * kKeys * kLd, ty, tx);
    const bool masked = !all_visible(p, i0, kRows, j0, kKeys);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int row = i0 + ty + kSide * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[i][j] *= p.scale;
        if (masked && !visible(p, row, j0 + tx + kSide * j))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mnew = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - mnew);
      m[i] = mnew;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float pr = s[i][j] == kNegInf ? 0.0f : expf(s[i][j] - mnew);
        sum += pr;
        sP[(ty + kSide * i) * kPs + tx + kSide * j] = pr;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    pv_tile<D, NI, kKeys>(acc, sP, sV + st * kKeys * kLd, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const float total = row_sum(l[i]);
    const int row = i0 + ty + kSide * i;
    if (row < p.Sq) {
      float* out = o + (((long long)b * p.Sq + row) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) out[tx + kSide * c] = acc[i][c] / total;
      if (tx == 0)
        lse[((long long)b * p.H + h) * p.Sq + row] = m[i] + logf(total);
    }
  }
}

// ------------------------------------------------------------------------
// backward
// ------------------------------------------------------------------------

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d]: a thread a row
// (rows in memory order, h fastest).
template <int D>
__global__ void flash_bwd_ffma_delta_kernel(const float* __restrict__ o,
                                           const float* __restrict__ dout,
                                           float* __restrict__ delta,
                                           Problem p) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= (long long)p.B * p.Sq * p.H) return;
  const float4* a = reinterpret_cast<const float4*>(o + row * D);
  const float4* g = reinterpret_cast<const float4*>(dout + row * D);
  float sum = 0.0f;
#pragma unroll 4
  for (int c = 0; c < D / 4; ++c) {
    const float4 x = a[c], y = g[c];
    sum = fmaf(x.x, y.x, sum);
    sum = fmaf(x.y, y.y, sum);
    sum = fmaf(x.z, y.z, sum);
    sum = fmaf(x.w, y.w, sum);
  }
  const int h = (int)(row % p.H);
  const long long bi = row / p.H;
  const int i = (int)(bi % p.Sq);
  const long long b = bi / p.Sq;
  delta[(b * p.H + h) * p.Sq + i] = sum;
}

template <int D>
struct DkdvSmem {
  static constexpr int kKeys = Tiles<D>::kKeys, kLd = Tiles<D>::kLd;
  static constexpr int kBq = Tiles<D>::kBwdRows;
  static constexpr int kFloats =
      2 * kKeys * kLd + 2 * kBq * kLd + 2 * kKeys * (kBq + 16) + 2 * kBq;
  static constexpr int kBytes = kFloats * 4;
};

// dK and dV of one block of keys of one kv head: tiles of query rows of every
// query head of the group stream through shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_ffma_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          Problem p) {
  constexpr int kKeys = Tiles<D>::kKeys, kLd = Tiles<D>::kLd;
  constexpr int kBq = Tiles<D>::kBwdRows;
  constexpr int NI = kKeys / kSide, NJ = kBq / kSide, NC = D / kSide;
  constexpr int kPs = kBq + 16;
  extern __shared__ float4 smem4[];
  float* sK = reinterpret_cast<float*>(smem4);  // [kKeys][kLd]
  float* sV = sK + kKeys * kLd;                  // [kKeys][kLd]
  float* sQ = sV + kKeys * kLd;                  // [kBq][kLd]
  float* sdO = sQ + kBq * kLd;                   // [kBq][kLd]
  float* sP = sdO + kBq * kLd;                   // P^T [kKeys][kPs]
  float* sdS = sP + kKeys * kPs;                 // dS^T [kKeys][kPs]
  float* sL = sdS + kKeys * kPs;                 // lse [kBq]
  float* sD = sL + kBq;                          // delta [kBq]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * kKeys;
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;
  const int rep = p.H / p.KV;

  load_tile<D, kKeys>(sK, k, b, j0, p.Sk, p.KV, kvh);
  load_tile<D, kKeys>(sV, v, b, j0, p.Sk, p.KV, kvh);
  cp_commit();

  float acc_dk[NI][NC], acc_dv[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_dk[i][c] = acc_dv[i][c] = 0.0f;

  int qbeg, qend;
  query_range(p, j0, kKeys, kBq, &qbeg, &qend);
  const int ntiles = tiles_between(qbeg, qend, kBq);
  for (int g = 0; g < rep; ++g) {
    const int h = kvh * rep + g;
    for (int t = 0; t < ntiles; ++t) {
      const int i0 = qbeg + t * kBq;
      load_tile<D, kBq>(sQ, q, b, i0, p.Sq, p.H, h);
      load_tile<D, kBq>(sdO, dout, b, i0, p.Sq, p.H, h);
      cp_commit();
      load_rows(sL, lse, p, b, h, i0, kBq);
      load_rows(sD, delta, p, b, h, i0, kBq);
      cp_wait<0>();
      __syncthreads();

      // S^T = K Q^T, P^T = exp(scale S^T - lse) on visible pairs
      float s[NI][NJ];
      dot_tile<D, NI, NJ>(s, sK, sQ, ty, tx);
      const bool masked = !all_visible(p, i0, kBq, j0, kKeys);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = tx + kSide * j;
          float pr = expf(s[i][j] * p.scale - sL[r]);
          if (masked && !visible(p, i0 + r, j0 + ty + kSide * i)) pr = 0.0f;
          s[i][j] = pr;
          sP[(ty + kSide * i) * kPs + r] = pr;
        }
      // dP^T = V dO^T, dS^T = P^T (dP^T - delta)
      float dp[NI][NJ];
      dot_tile<D, NI, NJ>(dp, sV, sdO, ty, tx);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int r = tx + kSide * j;
          sdS[(ty + kSide * i) * kPs + r] = s[i][j] * (dp[i][j] - sD[r]);
        }
      __syncthreads();
      pv_tile<D, NI, kBq>(acc_dv, sP, sdO, ty, tx);   // dV += P^T dO
      pv_tile<D, NI, kBq>(acc_dk, sdS, sQ, ty, tx);   // dK += dS^T Q
      __syncthreads();
    }
  }
  cp_wait<0>();  // no tile streamed: the K and V loads are still in flight

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int key = j0 + ty + kSide * i;
    if (key < p.Sk) {
      const long long off = (((long long)b * p.Sk + key) * p.KV + kvh) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        dk[off + tx + kSide * c] = acc_dk[i][c] * p.scale;
        dv[off + tx + kSide * c] = acc_dv[i][c];
      }
    }
  }
}

template <int D>
struct DqSmem {
  static constexpr int kKeys = Tiles<D>::kKeys, kLd = Tiles<D>::kLd;
  static constexpr int kFloats =
      2 * kRows * kLd + 2 * kKeys * kLd + kRows * (kKeys + 16) + 2 * kRows;
  static constexpr int kBytes = kFloats * 4;
};

// dQ of one block of 64 query rows of one head: tiles of keys of K and V
// stream through shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_ffma_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Problem p) {
  constexpr int kKeys = Tiles<D>::kKeys, kLd = Tiles<D>::kLd;
  constexpr int NI = kRows / kSide, NJ = kKeys / kSide, NC = D / kSide;
  constexpr int kPs = kKeys + 16;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [64][kLd]
  float* sdO = sQ + kRows * kLd;                 // [64][kLd]
  float* sK = sdO + kRows * kLd;                 // [kKeys][kLd]
  float* sV = sK + kKeys * kLd;                  // [kKeys][kLd]
  float* sdS = sV + kKeys * kLd;                 // [64][kPs]
  float* sL = sdS + kRows * kPs;                 // lse [64]
  float* sD = sL + kRows;                        // delta [64]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int i0 = qb * kRows;
  const int kvh = h / (p.H / p.KV);
  const int ty = threadIdx.x / kSide, tx = threadIdx.x % kSide;

  load_tile<D, kRows>(sQ, q, b, i0, p.Sq, p.H, h);
  load_tile<D, kRows>(sdO, dout, b, i0, p.Sq, p.H, h);
  cp_commit();
  load_rows(sL, lse, p, b, h, i0, kRows);
  load_rows(sD, delta, p, b, h, i0, kRows);

  float acc[NI][NC];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;

  int kbeg, kend;
  key_range(p, i0, kRows, kKeys, &kbeg, &kend);
  const int ntiles = tiles_between(kbeg, kend, kKeys);
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = kbeg + t * kKeys;
    load_tile<D, kKeys>(sK, k, b, j0, p.Sk, p.KV, kvh);
    load_tile<D, kKeys>(sV, v, b, j0, p.Sk, p.KV, kvh);
    cp_commit();
    cp_wait<0>();
    __syncthreads();

    float s[NI][NJ], dp[NI][NJ];
    dot_tile<D, NI, NJ>(s, sQ, sK, ty, tx);
    dot_tile<D, NI, NJ>(dp, sdO, sV, ty, tx);
    const bool masked = !all_visible(p, i0, kRows, j0, kKeys);
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int r = ty + kSide * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float pr = expf(s[i][j] * p.scale - sL[r]);
        if (masked && !visible(p, i0 + r, j0 + tx + kSide * j)) pr = 0.0f;
        sdS[r * kPs + tx + kSide * j] = pr * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();
    pv_tile<D, NI, kKeys>(acc, sdS, sK, ty, tx);  // dQ += dS K
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int row = i0 + ty + kSide * i;
    if (row < p.Sq) {
      float* out = dq + (((long long)b * p.Sq + row) * p.H + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) out[tx + kSide * c] = acc[i][c] * p.scale;
    }
  }
}

// ------------------------------------------------------------------------
// host: launchers
// ------------------------------------------------------------------------

// scale > 0: the softmax scale of the caller's head dim; else 1/sqrt(D).
Problem make_problem(int B, int Sq, int Sk, int H, int KV, int D, int causal,
                     int window, int q_offset, float scale) {
  Problem p;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale > 0.0f ? scale : 1.0f / sqrtf((float)D);
  return p;
}

bool problem_ok(const Problem& p) {
  return p.B >= 1 && p.B <= 65535 && p.Sq >= 1 && p.Sk >= 1 && p.KV >= 1 &&
         p.H >= p.KV && p.H % p.KV == 0 && p.H <= 65535 &&
         (p.Sq + kRows - 1) / kRows <= 65535 && (p.Sk + 31) / 32 <= 65535;
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Problem& p, cudaStream_t s) {
  const int smem = FwdSmem<D>::kBytes;
  cudaError_t err = allow_smem(flash_fwd_ffma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.H, (unsigned)p.B,
                  (unsigned)((p.Sq + kRows - 1) / kRows));
  flash_fwd_ffma_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, const Problem& p, cudaStream_t s) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* dof = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const long long rows = (long long)p.B * p.Sq * p.H;
  flash_bwd_ffma_delta_kernel<D><<<(unsigned)((rows + 255) / 256), 256, 0,
                                  s>>>(static_cast<const float*>(o), dof,
                                       static_cast<float*>(delta), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* df = static_cast<const float*>(delta);

  err = allow_smem(flash_bwd_ffma_dkdv_kernel<D>, DkdvSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  constexpr int kKeys = Tiles<D>::kKeys;
  const dim3 grid_kv((unsigned)p.KV, (unsigned)p.B,
                     (unsigned)((p.Sk + kKeys - 1) / kKeys));
  flash_bwd_ffma_dkdv_kernel<D><<<grid_kv, kThreads, DkdvSmem<D>::kBytes, s>>>(
      qf, kf, vf, dof, lf, df, static_cast<float*>(dk),
      static_cast<float*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = allow_smem(flash_bwd_ffma_dq_kernel<D>, DqSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)p.H, (unsigned)p.B,
                    (unsigned)((p.Sq + kRows - 1) / kRows));
  flash_bwd_ffma_dq_kernel<D><<<grid_q, kThreads, DqSmem<D>::kBytes, s>>>(
      qf, kf, vf, dof, lf, df, static_cast<float*>(dq), p);
  return cudaGetLastError();
}

}  // namespace

// All tensors float32 and 16-byte aligned; lse and delta [B, H, Sq].
// window <= 0: no sliding window. D in {64, 80, 128, 256}. scale <= 0: the
// softmax scale 1/sqrt(D). Returns the launches' cudaError_t
// (cudaErrorInvalidValue for a shape or pointer the kernels do not take).
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int Sq, int Sk, int H,
                             int KV, int D, int causal, int window,
                             int q_offset, float scale, void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset, scale);
  if (!problem_ok(p) || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)fwd<64>(q, k, v, o, lse, p, s);
    case 80: return (int)fwd<80>(q, k, v, o, lse, p, s);
    case 128: return (int)fwd<128>(q, k, v, o, lse, p, s);
    case 256: return (int)fwd<256>(q, k, v, o, lse, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// delta: float32 scratch [B, H, Sq] the caller allocates.
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv, int B,
                             int Sq, int Sk, int H, int KV, int D, int causal,
                             int window, int q_offset, float scale,
                             void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset, scale);
  if (!problem_ok(p) || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(o) || !aligned(dout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    case 80: return (int)bwd<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    case 128: return (int)bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    case 256: return (int)bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
