// Causal / sliding-window GQA flash attention, forward and backward, bf16
// in and out, float32 inside.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash.py:_flash_kernel
// (launched by flash_attention, wrapped by ops.attention). That kernel is
// forward-only; the backward here is the FlashAttention-2 recomputation
// (dq, dk, dv from q, k, v, o, dO and the saved per-row log-sum-exp).
//
// Layouts are the reference's: q, o, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, KV, D]; lse and delta [B, H, Sq] float32. Query row i sits at
// absolute position q_offset + i; key j is visible to it when j < Sk, j <=
// q_offset + i (causal) and j > q_offset + i - window (window > 0). Rows
// with no visible key are refused by the Python wrapper.
//
// Bound: operations. At the train path's [1, 4096, 32, 80] the forward
// does 4*Sq*Sk*D/2 multiply-adds per head (about 86 GFLOP) on 168 MB of
// inputs, far above the card's ratio of 295 operations per byte in bf16, so
// the tensor cores set the floor. Design for that, kept simple:
//   * one thread block of 4 warps per (64-row tile, head, batch); each warp
//     owns 16 rows (forward, dq) or 16 keys (dk/dv);
//   * the products run on the tensor cores through WMMA 16x16x16 bf16
//     fragments with float32 accumulation; the tiles of q, k, v, dO come
//     from device memory once per tile as 16-byte vectors into shared
//     memory;
//   * the online softmax works on float32 logits that each warp stores to
//     shared memory (two lanes per row, 32 columns each); probabilities and
//     dS go back to the tensor cores rounded to bf16, as the reference's
//     probs.astype(q.dtype) does;
//   * tiles that no row can see (past the causal diagonal, before the
//     window) are skipped;
//   * dk and dv of a kv head sum over its H/KV query heads inside one
//     block, and dq over the key tiles inside one block: no atomics, so
//     runs are deterministic.
// The softmax scale is the true 1/sqrt(D) (the TPU wrapper's padding of D
// to 128 lanes is not carried over).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;    // query rows and keys per tile
constexpr int kWarps = 4;    // 16 rows (or keys) per warp
constexpr int kThreads = kWarps * 32;
// Row strides of the float logits tile and the bf16 probability tile,
// padded past 64 so the lanes of the softmax stage (two per row) spread
// over the shared-memory banks instead of all hitting one.
constexpr int kSld = 68;
constexpr int kPld = 72;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Problem {
  int B, Sq, Sk, H, KV, causal, window, q_offset;
  float scale;  // 1/sqrt(D)
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  if (kpos >= p.Sk) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// Rows [s0, s0 + 64) of one head of a [B, S, heads, D] tensor into a
// [64][D] shared tile, zeros past S.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int s0, int S, int heads,
                                          int head) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < kTile * kVec; v += kThreads) {
    const int r = v / kVec, c = v % kVec;
    const int s = s0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s < S)
      val = reinterpret_cast<const uint4*>(
          src + (((long long)b * S + s) * heads + head) * D)[c];
    reinterpret_cast<uint4*>(dst + r * D)[c] = val;
  }
}

// Rows of one head of a [B, H, Sq] float vector into shared memory;
// `fill` past Sq.
__device__ __forceinline__ void load_rowvec(float* dst, const float* src,
                                            int b, int h, int H, int Sq,
                                            int q0, float mul, float fill) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int s = q0 + r;
    dst[r] = s < Sq ? src[((long long)b * H + h) * Sq + s] * mul : fill;
  }
}

// C[16 x 64] = A[16 x D] . B^T where B is a [64][D] row-major tile (so B^T
// is column-major with leading dimension D); result to shared float with
// row stride kSld.
template <int D>
__device__ __forceinline__ void mm_abt(float* c, const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int nt = 0; nt < kTile / 16; ++nt) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + kk * 16, D);
      wmma::load_matrix_sync(fb, b + nt * 16 * D + kk * 16, D);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + nt * 16, acc, kSld, wmma::mem_row_major);
  }
}

// acc[dt] += A[16 x 64] . B[64 x D], A row-major with leading dim kPld.
template <int D>
__device__ __forceinline__ void mm_ab_acc(FragC (&acc)[D / 16],
                                          const bf16* a, const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, kPld);
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * D + dt * 16, D);
      wmma::mma_sync(acc[dt], fa, fb, acc[dt]);
    }
  }
}

// Write a warp's 16 x D accumulators, times `mul`, as bf16 rows of a
// [B, S, heads, D] tensor, through a 16x16 float scratch of the warp.
template <int D>
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16],
                                           float* scratch, bf16* dst, int b,
                                           int s0, int S, int heads, int head,
                                           float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    wmma::store_matrix_sync(scratch, acc[dt], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16;
      const int s = s0 + r;
      if (s < S)
        dst[(((long long)b * S + s) * heads + head) * D + dt * 16 + c] =
            __float2bfloat16(scratch[e] * mul);
    }
    __syncwarp();
  }
}

// First key tile and end key of the keys some row of [q0, q0+64) can see.
__device__ __forceinline__ void key_range(const Problem& p, int q0, int* k0,
                                          int* k_end) {
  const int qlo = p.q_offset + q0;
  const int qhi = p.q_offset + min(q0 + kTile, p.Sq) - 1;
  int end = p.Sk;
  if (p.causal) end = min(end, qhi + 1);
  int begin = 0;
  if (p.window > 0) begin = max(0, qlo - p.window + 1);
  *k0 = (begin / kTile) * kTile;
  *k_end = end;
}

// ------------------------------------------------------------------------
// forward: o, lse
// ------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem_bytes() {
  return 3 * kTile * D * 2 + kTile * kSld * 4 + kTile * D * 4 +
         kTile * kPld * 2 + 3 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);        // [64][D]
  bf16* Ks = Qs + kTile * D;                       // [64][D]
  bf16* Vs = Ks + kTile * D;                       // [64][D]
  float* Ss = reinterpret_cast<float*>(Vs + kTile * D);  // [64][kSld]
  float* Os = Ss + kTile * kSld;                   // [64][D]
  bf16* Ps = reinterpret_cast<bf16*>(Os + kTile * D);    // [64][kPld]
  float* row_m = reinterpret_cast<float*>(Ps + kTile * kPld);
  float* row_l = row_m + kTile;
  float* row_a = row_l + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale2 = p.scale * kLog2e;  // logits in base-2 units

  load_tile<D>(Qs, q, b, q0, p.Sq, p.H, h);
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    row_m[i] = -CUDART_INF_F;
    row_l[i] = 0.0f;
  }
  int k0, k_end;
  key_range(p, q0, &k0, &k_end);
  __syncthreads();

  const int r = warp * 16 + lane / 2;  // this lane's row in the softmax
  const int half = lane % 2;           // and its 32 columns
  const int qpos = p.q_offset + q0 + r;
  for (; k0 < k_end; k0 += kTile) {
    load_tile<D>(Ks, k, b, k0, p.Sk, p.KV, kvh);
    load_tile<D>(Vs, v, b, k0, p.Sk, p.KV, kvh);
    __syncthreads();
    mm_abt<D>(Ss + warp * 16 * kSld, Qs + warp * 16 * D, Ks);
    __syncwarp();
    {
      const float* srow = Ss + r * kSld + half * 32;
      float s2[32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kpos = k0 + half * 32 + j;
        s2[j] = visible(p, qpos, kpos) ? srow[j] * scale2 : -CUDART_INF_F;
        mx = fmaxf(mx, s2[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.0f : m_new;
      bf16* prow = Ps + r * kPld + half * 32;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float pj = exp2f(s2[j] - m_use);
        prow[j] = __float2bfloat16(pj);
        sum += pj;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = exp2f(m_old - m_use);
      __syncwarp();
      if (half == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
        row_a[r] = alpha;
      }
    }
    __syncwarp();
    float* Ow = Os + warp * 16 * D;
    for (int e = lane; e < 16 * D; e += 32) Ow[e] *= row_a[warp * 16 + e / D];
    __syncwarp();
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      FragC acc;
      wmma::load_matrix_sync(acc, Ow + dt * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        FragA fa;
        FragBRow fb;
        wmma::load_matrix_sync(fa, Ps + warp * 16 * kPld + kk * 16, kPld);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * D + dt * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(Ow + dt * 16, acc, D, wmma::mem_row_major);
    }
    __syncthreads();
  }

  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = warp * 16 + e / D, c = e % D;
    const int s = q0 + rr;
    if (s < p.Sq)
      o[(((long long)b * p.Sq + s) * p.H + h) * D + c] =
          __float2bfloat16(Os[rr * D + c] / row_l[rr]);
  }
  if (lane < 16) {
    const int rr = warp * 16 + lane;
    const int s = q0 + rr;
    if (s < p.Sq)
      lse[((long long)b * p.H + h) * p.Sq + s] =
          (row_m[rr] + log2f(row_l[rr])) * kLn2;
  }
}

// ------------------------------------------------------------------------
// backward, step 1: delta = rowsum(dO * O), one warp per row
// ------------------------------------------------------------------------

template <int D>
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o,
                                       const bf16* __restrict__ dout,
                                       float* __restrict__ delta, Problem p) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long rows = (long long)p.B * p.Sq * p.H;
  if (row >= rows) return;
  // row indexes [B, Sq, H]
  const bf16* op = o + row * D;
  const bf16* dp = dout + row * D;
  float acc = 0.0f;
  for (int c = lane; c < D; c += 32)
    acc += __bfloat162float(op[c]) * __bfloat162float(dp[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long h = row % p.H;
    const long long s = (row / p.H) % p.Sq;
    const long long b = row / ((long long)p.H * p.Sq);
    delta[(b * p.H + h) * p.Sq + s] = acc;
  }
}

// ------------------------------------------------------------------------
// backward, step 2: dk, dv per (key tile, kv head, batch)
// ------------------------------------------------------------------------

template <int D>
constexpr int bwd_smem_bytes() {
  return 4 * kTile * D * 2 + kTile * kSld * 4 + kTile * kPld * 2 +
         2 * kTile * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // [64 keys][D]
  bf16* Vs = Ks + kTile * D;
  bf16* Qs = Vs + kTile * D;                 // [64 rows][D]
  bf16* dOs = Qs + kTile * D;
  float* Ss = reinterpret_cast<float*>(dOs + kTile * D);  // [64 keys][kSld]
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kTile * kSld);  // [64 keys][kPld]
  float* lse_s = reinterpret_cast<float*>(Ps + kTile * kPld);  // base 2
  float* delta_s = lse_s + kTile;

  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int rep = p.H / p.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale2 = p.scale * kLog2e;

  load_tile<D>(Ks, k, b, k0, p.Sk, p.KV, kvh);
  load_tile<D>(Vs, v, b, k0, p.Sk, p.KV, kvh);

  // query rows that can see some key of [k0, k_last]
  const int k_last = min(k0 + kTile, p.Sk) - 1;
  int i_begin = 0, i_end = p.Sq;
  if (p.causal) i_begin = max(0, k0 - p.q_offset);
  if (p.window > 0) i_end = min(p.Sq, k_last + p.window - p.q_offset);
  i_begin = (i_begin / kTile) * kTile;

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    wmma::fill_fragment(dk_acc[dt], 0.0f);
    wmma::fill_fragment(dv_acc[dt], 0.0f);
  }

  const int r = warp * 16 + lane / 2;  // this lane's key row
  const int half = lane % 2;           // and its 32 query columns
  const int kpos = k0 + r;
  float* Sw = Ss + warp * 16 * kSld;
  bf16* Pw = Ps + warp * 16 * kPld;
  for (int hh = 0; hh < rep; ++hh) {
    const int h = kvh * rep + hh;
    for (int q0 = i_begin; q0 < i_end; q0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<D>(Qs, q, b, q0, p.Sq, p.H, h);
      load_tile<D>(dOs, dout, b, q0, p.Sq, p.H, h);
      load_rowvec(lse_s, lse, b, h, p.H, p.Sq, q0, kLog2e, CUDART_INF_F);
      load_rowvec(delta_s, delta, b, h, p.H, p.Sq, q0, 1.0f, 0.0f);
      __syncthreads();
      // S^T = K_w Q^T, then P^T = exp2(S^T * scale2 - lse2)
      mm_abt<D>(Sw, Ks + warp * 16 * D, Qs);
      __syncwarp();
      float pr[32];
      {
        const float* srow = Ss + r * kSld + half * 32;
        bf16* prow = Ps + r * kPld + half * 32;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int c = half * 32 + j;
          const int qpos = p.q_offset + q0 + c;
          pr[j] = visible(p, qpos, kpos)
                      ? exp2f(srow[j] * scale2 - lse_s[c]) : 0.0f;
          prow[j] = __float2bfloat16(pr[j]);
        }
      }
      __syncwarp();
      // dV += P^T dO
      mm_ab_acc<D>(dv_acc, Pw, dOs);
      // dP^T = V_w dO^T
      mm_abt<D>(Sw, Vs + warp * 16 * D, dOs);
      __syncwarp();
      {
        const float* dprow = Ss + r * kSld + half * 32;
        bf16* dsrow = Ps + r * kPld + half * 32;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          dsrow[j] = __float2bfloat16(
              pr[j] * (dprow[j] - delta_s[half * 32 + j]));
      }
      __syncwarp();
      // dK += dS^T Q
      mm_ab_acc<D>(dk_acc, Pw, Qs);
    }
  }
  __syncwarp();
  store_rows<D>(dk_acc, Sw, dk, b, k0 + warp * 16, p.Sk, p.KV, kvh, p.scale);
  store_rows<D>(dv_acc, Sw, dv, b, k0 + warp * 16, p.Sk, p.KV, kvh, 1.0f);
}

// ------------------------------------------------------------------------
// backward, step 3: dq per (query tile, head, batch)
// ------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [64 rows][D]
  bf16* dOs = Qs + kTile * D;
  bf16* Ks = dOs + kTile * D;                // [64 keys][D]
  bf16* Vs = Ks + kTile * D;
  float* Ss = reinterpret_cast<float*>(Vs + kTile * D);  // [64 rows][kSld]
  bf16* Ps = reinterpret_cast<bf16*>(Ss + kTile * kSld);  // [64 rows][kPld]
  float* lse_s = reinterpret_cast<float*>(Ps + kTile * kPld);  // base 2
  float* delta_s = lse_s + kTile;

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float scale2 = p.scale * kLog2e;

  load_tile<D>(Qs, q, b, q0, p.Sq, p.H, h);
  load_tile<D>(dOs, dout, b, q0, p.Sq, p.H, h);
  load_rowvec(lse_s, lse, b, h, p.H, p.Sq, q0, kLog2e, CUDART_INF_F);
  load_rowvec(delta_s, delta, b, h, p.H, p.Sq, q0, 1.0f, 0.0f);
  int k0, k_end;
  key_range(p, q0, &k0, &k_end);

  FragC dq_acc[D / 16];
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) wmma::fill_fragment(dq_acc[dt], 0.0f);

  const int r = warp * 16 + lane / 2;
  const int half = lane % 2;
  const int qpos = p.q_offset + q0 + r;
  float* Sw = Ss + warp * 16 * kSld;
  bf16* Pw = Ps + warp * 16 * kPld;
  for (; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k, b, k0, p.Sk, p.KV, kvh);
    load_tile<D>(Vs, v, b, k0, p.Sk, p.KV, kvh);
    __syncthreads();
    mm_abt<D>(Sw, Qs + warp * 16 * D, Ks);
    __syncwarp();
    float pr[32];
    {
      const float* srow = Ss + r * kSld + half * 32;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int kpos = k0 + half * 32 + j;
        pr[j] = visible(p, qpos, kpos)
                    ? exp2f(srow[j] * scale2 - lse_s[r]) : 0.0f;
      }
    }
    __syncwarp();
    // dP = dO_w V^T
    mm_abt<D>(Sw, dOs + warp * 16 * D, Vs);
    __syncwarp();
    {
      const float* dprow = Ss + r * kSld + half * 32;
      bf16* dsrow = Ps + r * kPld + half * 32;
      const float dl = delta_s[r];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        dsrow[j] = __float2bfloat16(pr[j] * (dprow[j] - dl));
    }
    __syncwarp();
    // dQ += dS K
    mm_ab_acc<D>(dq_acc, Pw, Ks);
  }
  __syncwarp();
  store_rows<D>(dq_acc, Sw, dq, b, q0 + warp * 16, p.Sq, p.H, h, p.scale);
}

// ------------------------------------------------------------------------
// launchers
// ------------------------------------------------------------------------

Problem make_problem(int B, int Sq, int Sk, int H, int KV, int D, int causal,
                     int window, int q_offset) {
  Problem p;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = 1.0f / sqrtf((float)D);
  return p;
}

bool problem_ok(const Problem& p) {
  return p.B >= 1 && p.B <= 65535 && p.Sq >= 1 && p.Sk >= 1 && p.KV >= 1 &&
         p.H >= p.KV && p.H % p.KV == 0 && p.H <= 65535;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Problem& p, cudaStream_t s) {
  const int smem = fwd_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((p.Sq + kTile - 1) / kTile), (unsigned)p.H,
                  (unsigned)p.B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, const Problem& p, cudaStream_t s) {
  const long long rows = (long long)p.B * p.Sq * p.H;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + kWarps - 1) / kWarps),
                              kThreads, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = bwd_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)((p.Sk + kTile - 1) / kTile), (unsigned)p.KV,
                     (unsigned)p.B);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)((p.Sq + kTile - 1) / kTile), (unsigned)p.H,
                    (unsigned)p.B);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), p);
  return cudaGetLastError();
}

}  // namespace

// All tensors bf16 except lse/delta (float32 [B, H, Sq]). window <= 0: no
// sliding window. D in {64, 80, 128}. Returns the launches' cudaError_t.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Sk, int H, int KV,
                         int D, int causal, int window, int q_offset,
                         void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset);
  if (!problem_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)fwd<64>(q, k, v, o, lse, p, s);
    case 80: return (int)fwd<80>(q, k, v, o, lse, p, s);
    case 128: return (int)fwd<128>(q, k, v, o, lse, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// delta: float32 scratch [B, H, Sq] the caller allocates.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int B,
                         int Sq, int Sk, int H, int KV, int D, int causal,
                         int window, int q_offset, void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset);
  if (!problem_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    case 80: return (int)bwd<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    case 128: return (int)bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
