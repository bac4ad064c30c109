// Causal / sliding-window GQA flash attention in float32, forward and
// backward, on the CUDA cores (FFMA) of Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash.py:_flash_kernel
// (launched by flash_attention) on float32 inputs: that kernel casts q, k and
// v to float32, computes in float32 and writes q's dtype. The bf16 kernels of
// flash_attention.cu run their products on wgmma; tf32 wgmma would round
// every input to a 10-bit mantissa and miss the reference's float32, so
// these kernels use no mma, wgmma or tf32 instruction: every product is an
// FFMA. The backward is the FlashAttention-2 recomputation: a delta =
// rowsum(dO * O) pass, dk/dv per block of keys, dq per block of query rows.
//
// Layouts are the bf16 kernels': q, o, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, KV, D]; lse and delta [B, H, Sq]; all float32. Query row i sits at
// absolute position q_offset + i; key j is visible to it when j < Sk, j <=
// q_offset + i (causal) and j > q_offset + i - window (window > 0). Rows
// with no visible key are refused by the Python wrapper. The softmax scale is
// the caller's. Head dims 64, 80, 112, 128 and 256 (112 unpadded).
//
// Bound: operations. At the train path's [1, 4096, 32, 80] the forward does
// 4*D flops per visible (query, key) pair, about 86 GFLOP on 84 MB: far above
// the card's 20 float32 operations per byte, so the FFMA rate (67 TFLOP/s)
// sets the floor, and what keeps a kernel from it is every instruction that
// is not an FFMA (a scheduler issues one a cycle) and every cycle a warp
// waits. What holds each kernel (PERF.md): the forward at D = 80 issues ~78%
// FFMAs a tile (the accurate expf of 40 probabilities, 13 loads a 160-FFMA
// step of S, 4 a 40-FFMA step of O += P V); dk/dv and dq do 7 products
// where the bound counts 5 (dq recomputes S and dP); at D = 256 a 1 KiB row
// leaves stages of 16 rows. The design:
//   * Six products, two shapes. Each block holds a resident tile of NG RM
//     rows (q rows in the forward and dq, keys in dk/dv) and streams tiles of
//     16 KW rows (keys, or query rows in dk/dv). Consumer threads are NG row
//     groups of 16 lanes (half a warp); a thread owns resident rows ry + NG i.
//     - Row products (S = Q K^T, dP = dO V^T and their transposes in dk/dv):
//       rowdot, an RM x KW register tile from float4 loads along D of both
//       rows, 4 RM KW FFMAs per RM + KW LDS.128 (10.7 to 12.3). At D = 256
//       four lanes split D and add their sums by shuffles (a stage there
//       holds 16 or 32 rows).
//     - Accumulating products (O += P V, dV += P^T dO, dK += dS^T Q, dQ +=
//       dS K): accum, the thread's RM rows by D/16 columns (a float4 run,
//       then a float2 and a float where D is not a multiple of 64, so no
//       pad at 112): per streamed row RM/4 LDS.128 of P, stored transposed
//       so one load gives 4 rows at one key, and 1-4 loads of the row's
//       columns: 8 to 21 FFMAs a load, no scalar load of V but D % 64's.
//     - Shared rows padded to D + 4 floats (D + 16 where four lanes split
//       D), P buffers to NG RM + 4: every 16-byte load of a warp takes the
//       fewest wavefronts its distinct addresses allow.
//   * Registers: a producer warpgroup keeps 24 of its registers
//     (setmaxnreg) and the two consumer warpgroups take up to 240, so an
//     8 x 5 tile of S beside 8 x 5 of O and its tile sum never spills.
//   * Copies the consumers do not wait on: one warp of the producer
//     warpgroup fills the resident tile and a ring of 3-4 stages with
//     cp.async.bulk (a row a copy; rows past S zeroed, lse and delta beside
//     the dk/dv stages), each stage's full mbarrier counting its bytes;
//     consumer warps wait on the stage they need and release it by an
//     empty mbarrier. A row group writes and reads only its own rows of the
//     P buffer, so consumers meet at no block barrier: a warp syncs its own
//     lanes around P.
//   * dk/dv grids that fill the card: where KV * B * key blocks is under
//     2 x the SMs, each block's loop over (query head, query tile) is split
//     into `nsplit` contiguous runs (the wrapper's plan, flash.dkdv_plan),
//     written to float32 scratch and added in split order by
//     flash_bwd_ffma_dkdv_sum_kernel. Causal grids launch the heaviest
//     blocks first.
//   * At D = 256 (kDsPath) dk/dv also writes dS^T to scratch and
//     flash_bwd_ffma_dq_ds_kernel forms dQ = dS K from it: a resident Q and
//     dO would leave dq stages of 16 keys, and recomputing S and dP there
//     costs more than moving dS through memory (B H Sk Sq floats).
//   * Tiles no row of the block can see are never loaded; masks only on the
//     tiles that need them. Masked logits are -1e30 (the reference's
//     NEG_INF) and their probabilities exactly 0. The forward's online
//     softmax keeps each thread's partial row sum, rescaled by the row max
//     (shared by shuffles over the row group), summed once at the end.
//   * Every sum stays in one block or the fixed-order sum pass: no atomics,
//     two runs are bitwise equal. A streamed tile's accumulating products
//     are summed from zero and then added to the running sum, so a sum over S
//     keys or rows rounds as S / (16 KW) sums of 16 KW terms.
// exp and log are the accurate expf and logf, divisions IEEE: the kernels'
// results differ from the float32 plain version only in summation order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSide = 16;                  // lanes of a row group
constexpr int kProducerRegs = 24;          // a producer thread's registers
constexpr int kBarBytes = 128;             // the mbarriers, before the tiles
constexpr float kNegInf = -1e30f;

// Tiles of one kernel at one head dim: a producer warpgroup (one warp of it
// copies) and NG = 16 row groups of 16 consumer lanes (two warpgroups); RM
// resident rows a thread (rows ry + NG i of the block's NG RM), KW streamed
// rows a thread in the row products (a stage holds 16 KW), DG lanes that
// split D in the row products, SLOTS stages in the ring, NPB P buffers
// (two let the forward and dq write a tile's P while the last is read),
// NCH column chunks of the accumulating products (a chunk's tile sum lives
// in registers beside the running sums).
template <int D_, int RM_, int KW_, int DG_, int SLOTS_, int NPB_, int NCH_>
struct Tile {
  static constexpr int D = D_, RM = RM_, KW = KW_, DG = DG_, SLOTS = SLOTS_;
  static constexpr int NPB = NPB_, NCH = NCH_, NG = 16;
  static constexpr int kConsumers = kSide * NG;
  static constexpr int kWarps = kConsumers / 32;       // consumer warps
  static constexpr int kThreads = kConsumers + 128;    // and the producers
  // registers a thread starts with (a scheduler's 16,384 over the warps it
  // may hold, in steps of 8), and those a consumer thread takes once the
  // producer warpgroup has given up all but kProducerRegs of its own:
  // setmaxnreg.inc waits until the registers released cover it, so it asks
  // for no more than those
  static constexpr int kLaunchRegs =
      16384 / (32 * ((kThreads / 32 + 3) / 4)) / 8 * 8;
  static constexpr int kMoreRegs =
      128 * (kLaunchRegs - kProducerRegs) / kConsumers / 8 * 8;
  static constexpr int kConsumerRegs =
      kLaunchRegs + kMoreRegs > 240 ? 240 : kLaunchRegs + kMoreRegs;
  static constexpr int LD = DG == 1 ? D + 4 : D + 16;  // floats a shared row
  static constexpr int BM = NG * RM;                   // resident rows
  static constexpr int BN = kSide * KW;                // streamed rows
  static constexpr int PLD = BM + 4;                   // floats a P row
  static constexpr int CW = D / kSide;                 // columns a thread
  static constexpr int UA = 4;  // streamed rows an unrolled step of accum
};

template <int D> struct FwdTile;
template <> struct FwdTile<64> : Tile<64, 8, 4, 1, 4, 2, 1> {};
template <> struct FwdTile<80> : Tile<80, 8, 5, 1, 3, 2, 1> {
  static constexpr int UA = 2;
};
template <> struct FwdTile<112> : Tile<112, 8, 4, 1, 3, 2, 1> {};
template <> struct FwdTile<128> : Tile<128, 8, 4, 1, 3, 1, 1> {};
template <> struct FwdTile<256> : Tile<256, 4, 2, 4, 3, 2, 1> {};

// dk/dv: resident K and V of 16 RM keys, stages of Q or dO of 16 KW query
// rows with their lse or delta; one buffer that holds P, then dS (NPB is
// not read).
template <int D> struct DkdvTile;
template <> struct DkdvTile<64> : Tile<64, 8, 4, 1, 4, 1, 1> {};
template <> struct DkdvTile<80> : Tile<80, 8, 4, 1, 4, 1, 1> {};
template <> struct DkdvTile<112> : Tile<112, 8, 3, 1, 3, 1, 1> {};
template <> struct DkdvTile<128> : Tile<128, 4, 4, 1, 4, 1, 1> {};
template <> struct DkdvTile<256> : Tile<256, 4, 1, 4, 4, 1, 2> {};

template <int D> struct DqTile;
template <> struct DqTile<64> : Tile<64, 8, 4, 1, 4, 2, 1> {};
template <> struct DqTile<80> : Tile<80, 8, 4, 1, 3, 2, 1> {};
template <> struct DqTile<112> : Tile<112, 8, 3, 1, 3, 1, 1> {};
template <> struct DqTile<128> : Tile<128, 4, 4, 1, 4, 1, 1> {};
template <> struct DqTile<256> : Tile<256, 4, 1, 4, 4, 2, 1> {};

// Head dims whose dq reads the dS^T that dk/dv wrote to scratch rather than
// recomputing S and dP: at 256 a resident Q and dO take 139 KB of shared
// memory and leave stages of 16 keys, where the recomputation costs more
// than moving dS through memory.
template <int D>
constexpr bool kDsPath = D == 256;

// dq from dS^T: 16 RM = 128 query rows a block (row ry RM + i of a thread,
// the natural order of dS^T's rows), stages of 32 keys of K and of dS^T.
template <int D>
struct DqDsTile : Tile<D, 8, 2, 1, 4, 1, (D / kSide > 8 ? 2 : 1)> {};

template <typename T>
struct FwdSmem {
  static constexpr int kFloats =
      T::BM * T::LD + T::SLOTS * T::BN * T::LD + T::NPB * T::BN * T::PLD;
  static constexpr int kBytes = kBarBytes + 4 * kFloats;
};

template <typename T>
struct DkdvSmem {
  static constexpr int kSlot = T::BN * T::LD + T::BN;  // rows, lse or delta
  static constexpr int kFloats =
      2 * T::BM * T::LD + T::SLOTS * kSlot + T::BN * T::PLD;
  static constexpr int kBytes = kBarBytes + 4 * kFloats;
};

template <typename T>
struct DqDsSmem {
  static constexpr int kStage = T::BN * T::LD + T::BN * T::PLD;  // K, dS^T
  static constexpr int kBytes = kBarBytes + 4 * T::SLOTS * kStage;
};

// Floats of a dS^T row in scratch: Sq rounded up to whole dq blocks, so that
// a block's copy of its rows never leaves the row.
template <int D>
__host__ __device__ __forceinline__ long long ds_row(int sq) {
  constexpr int bm = DqDsTile<D>::BM;
  return (long long)(sq + bm - 1) / bm * bm;
}

template <typename T>
struct DqSmem {
  static constexpr int kFloats = 2 * T::BM * T::LD +
                                 T::SLOTS * T::BN * T::LD +
                                 T::NPB * T::BN * T::PLD;
  static constexpr int kBytes = kBarBytes + 4 * kFloats;
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
// see some key of [j0, j0 + keys). flash.dkdv_plan computes the same.
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
// PTX: mbarriers, bulk copies, the consumers' barrier
// ------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) global -> shared, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Registers a thread holds: the producer warpgroup gives some up, the
// consumer warpgroups take them (every thread of a warpgroup executes it).
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// The lanes of a warp meet, its two row groups among them. A row group's
// P buffer entries (its rows, every streamed row) are written and read by
// its own 16 lanes only, so no consumer waits on another warp.
__device__ __forceinline__ void row_group_sync() { __syncwarp(); }

// A consumer warp is done with a stage.
__device__ __forceinline__ void release(uint32_t bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(bar);
}

// Max and sum over the 16 lanes of a row group, in a fixed butterfly order.
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ------------------------------------------------------------------------
// the producer warp
// ------------------------------------------------------------------------

// Rows [s0, s0 + R) of head `hd` of one or two [B, S, heads, D] tensors
// (src0, and src1 when dst1 is set) into shared tiles of row stride LD, by
// bulk copies that complete on `bar`; rows past S zeroed. With `xsrc`, also
// the per-row values of head `xh` of a [B, H, S] tensor into xdst[0, R) (0
// past S). Called by all 32 lanes of the producer warp.
template <int D, int LD>
__device__ __forceinline__ void fill_rows(
    float* dst0, const float* src0, float* dst1, const float* src1, int b,
    int s0, int R, int S, int heads, int hd, uint32_t bar, int lane,
    const float* xsrc = nullptr, float* xdst = nullptr, int H = 0,
    int xh = 0) {
  const int nv = max(0, min(R, S - s0));
  for (int r = nv + lane; r < R; r += 32) {
    float4* z0 = reinterpret_cast<float4*>(dst0 + r * LD);
    float4* z1 = reinterpret_cast<float4*>(dst1 + r * LD);
    for (int c = 0; c < D / 4; ++c) {
      z0[c] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (dst1) z1[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if (xdst) {
    const float* x = xsrc + ((long long)b * H + xh) * S;
    for (int r = lane; r < R; r += 32)
      xdst[r] = s0 + r < S ? x[s0 + r] : 0.0f;
  }
  // the stage's earlier contents were written or read by the generic proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_expect_tx(bar, nv * D * 4 * (dst1 ? 2 : 1));
  __syncwarp();
  for (int r = lane; r < nv; r += 32) {
    const long long off = (((long long)b * S + s0 + r) * heads + hd) * D;
    bulk_copy(dst0 + r * LD, src0 + off, D * 4, bar);
    if (dst1) bulk_copy(dst1 + r * LD, src1 + off, D * 4, bar);
  }
}

// Slot of the n-th streamed tile, and the parity of its use.
template <int SLOTS>
__device__ __forceinline__ int slot_of(int n) { return n % SLOTS; }

template <int SLOTS>
__device__ __forceinline__ int phase_of(int n) { return (n / SLOTS) & 1; }

// Wait until the n-th tile's stage is free (its use n - SLOTS released).
template <int SLOTS>
__device__ __forceinline__ void wait_free(uint32_t empty0, int n) {
  if (n >= SLOTS)
    mbar_wait(empty0 + 8 * slot_of<SLOTS>(n), phase_of<SLOTS>(n) ^ 1);
}

// ------------------------------------------------------------------------
// the two FFMA products
// ------------------------------------------------------------------------

__device__ __forceinline__ void fma4(float& acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// Streamed row of the lane's w-th value after rowdot: kx(lane) + 16 w.
template <int DG>
__device__ __forceinline__ int row_lane(int lane) {
  return DG == 1 ? lane : (lane >> 2) + 4 * (lane & 3);
}

// acc[i][w] = sum_d A[ry + NG i][d] * B[row_lane(lane) + 16 w][d]: A the
// resident tile, B a stage, both of row stride T::LD. DG = 4: lane (cg, dg)
// = (lane / 4, lane % 4) sums the float4 columns dg, dg + 4, ... of the rows
// cg + 4 w' (w' < 4 KW), the four lanes of a cg add their sums by shuffles
// (xor 1 then xor 2: every lane the same bits), and the lane keeps w' = 4 w
// + dg.
template <typename T>
__device__ __forceinline__ void rowdot(float (&acc)[T::RM][T::KW],
                                       const float* A, const float* B,
                                       int ry, int lane) {
  constexpr int RM = T::RM, KW = T::KW, DG = T::DG, LD = T::LD, D = T::D;
  constexpr int KP = KW * DG;    // rows a lane sums over its columns
  constexpr int RS = kSide / DG; // the lane's rows: (lane / DG) + RS w'
  float part[RM][KP];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int w = 0; w < KP; ++w) part[i][w] = 0.0f;
  const int dg = DG == 1 ? 0 : lane & (DG - 1);
  const float* a0 = A + ry * LD + 4 * dg;
  const float* b0 = B + (lane / DG) * LD + 4 * dg;
#pragma unroll 2
  for (int d = 0; d < D; d += 4 * DG) {
    if constexpr (KP <= RM) {
      float4 b[KP];
#pragma unroll
      for (int w = 0; w < KP; ++w) b[w] = ld4(b0 + RS * w * LD + d);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = ld4(a0 + T::NG * i * LD + d);
#pragma unroll
        for (int w = 0; w < KP; ++w) fma4(part[i][w], a, b[w]);
      }
    } else {
      float4 a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = ld4(a0 + T::NG * i * LD + d);
#pragma unroll
      for (int w = 0; w < KP; ++w) {
        const float4 b = ld4(b0 + RS * w * LD + d);
#pragma unroll
        for (int i = 0; i < RM; ++i) fma4(part[i][w], a[i], b);
      }
    }
  }
  if constexpr (DG == 1) {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KW; ++w) acc[i][w] = part[i][w];
  } else {
    static_assert(DG == 4, "four lanes split D, or one");
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KP; ++w) {
        part[i][w] += __shfl_xor_sync(0xffffffffu, part[i][w], 1);
        part[i][w] += __shfl_xor_sync(0xffffffffu, part[i][w], 2);
      }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        const float* x = part[i] + 4 * w;
        acc[i][w] = dg == 0 ? x[0] : dg == 1 ? x[1] : dg == 2 ? x[2] : x[3];
      }
  }
}

// The lane's columns of a row of D: float4 runs at 64 s + 4 lane, then (D
// % 64 >= 32) a float2 at 2 lane, then (D % 32 == 16) a float at lane of
// the tail; D / 16 values. `c` counts them.
template <int D>
struct Cols {
  static constexpr int n4 = D / 64, n2 = (D % 64) / 32, n1 = (D % 32) / 16;
  static_assert(D % 16 == 0, "head dim a multiple of 16");
};

// v[c - C0] = the lane's column c of the row, for c in [C0, C0 + N), by the widest
// loads the columns allow (C0 and N cover whole runs).
template <int D, int C0, int N>
__device__ __forceinline__ void load_cols(const float* row, int lane,
                                          float (&v)[N]) {
  constexpr int n4 = Cols<D>::n4, n2 = Cols<D>::n2, n1 = Cols<D>::n1;
#pragma unroll
  for (int s = 0; s < n4; ++s) {
    if (4 * s >= C0 && 4 * s + 4 <= C0 + N) {
      const float4 t = ld4(row + 64 * s + 4 * lane);
      v[4 * s - C0] = t.x;
      v[4 * s - C0 + 1] = t.y;
      v[4 * s - C0 + 2] = t.z;
      v[4 * s - C0 + 3] = t.w;
    }
  }
  if constexpr (n2 > 0 && 4 * n4 >= C0 && 4 * n4 + 2 <= C0 + N) {
    const float2 t =
        *reinterpret_cast<const float2*>(row + 64 * n4 + 2 * lane);
    v[4 * n4 - C0] = t.x;
    v[4 * n4 - C0 + 1] = t.y;
  }
  if constexpr (n1 > 0 && 4 * n4 + 2 * n2 >= C0 &&
                4 * n4 + 2 * n2 + 1 <= C0 + N)
    v[4 * n4 + 2 * n2 - C0] = row[64 * n4 + 32 * n2 + lane];
}

// The lane's columns of a row of D = v, by the widest stores they allow.
template <int D>
__device__ __forceinline__ void store_cols(float* out, int lane,
                                           const float (&v)[D / kSide]) {
  constexpr int n4 = Cols<D>::n4, n2 = Cols<D>::n2, n1 = Cols<D>::n1;
#pragma unroll
  for (int s = 0; s < n4; ++s)
    *reinterpret_cast<float4*>(out + 64 * s + 4 * lane) =
        make_float4(v[4 * s], v[4 * s + 1], v[4 * s + 2], v[4 * s + 3]);
  if constexpr (n2 > 0)
    *reinterpret_cast<float2*>(out + 64 * n4 + 2 * lane) =
        make_float2(v[4 * n4], v[4 * n4 + 1]);
  if constexpr (n1 > 0) out[64 * n4 + 32 * n2 + lane] = v[4 * n4 + 2 * n2];
}

// acc[i][c] = fmaf(acc[i][c], alpha[i], sum_{k < BN} P[k][ry RM + i] *
// V[k][the lane's column c]) for the columns c in [C0, C0 + CW / NCH): P a
// buffer [BN][PLD] whose row k holds the k-th streamed row's values for
// resident rows ry + 16 i at ry RM + i; V a stage. The tile's sum starts
// from zero and is added to acc once.
template <typename T, int C0>
__device__ __forceinline__ void accum_cols(float (&acc)[T::RM][T::CW],
                                           const float (&alpha)[T::RM],
                                           const float* P, const float* V,
                                           int ry, int lane) {
  constexpr int RM = T::RM, CC = T::CW / T::NCH;
  const float* p0 = P + ry * RM;
  float part[RM][CC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c) part[i][c] = 0.0f;
  static_assert(T::BN % T::UA == 0, "whole unrolled steps");
  // pointers stepped by UA rows, the rows of a step at constant offsets
  const float* pk = p0;
  const float* vk = V;
#pragma unroll 1
  for (int k0 = 0; k0 < T::BN;
       k0 += T::UA, pk += T::UA * T::PLD, vk += T::UA * T::LD)
#pragma unroll
  for (int u = 0; u < T::UA; ++u) {
    float pv[RM];
#pragma unroll
    for (int q = 0; q < RM / 4; ++q) {
      const float4 t = ld4(pk + u * T::PLD + 4 * q);
      pv[4 * q] = t.x;
      pv[4 * q + 1] = t.y;
      pv[4 * q + 2] = t.z;
      pv[4 * q + 3] = t.w;
    }
    float v[CC];
    load_cols<T::D, C0>(vk + u * T::LD, lane, v);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int c = 0; c < CC; ++c) part[i][c] = fmaf(pv[i], v[c], part[i][c]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c)
      acc[i][C0 + c] = fmaf(acc[i][C0 + c], alpha[i], part[i][c]);
}

// All the columns, in NCH chunks (one chunk's tile sum in registers at a
// time).
template <typename T>
__device__ __forceinline__ void accum(float (&acc)[T::RM][T::CW],
                                      const float (&alpha)[T::RM],
                                      const float* P, const float* V, int ry,
                                      int lane) {
  static_assert(T::NCH == 1 || T::NCH == 2, "one or two column chunks");
  accum_cols<T, 0>(acc, alpha, P, V, ry, lane);
  if constexpr (T::NCH == 2)
    accum_cols<T, T::CW / 2>(acc, alpha, P, V, ry, lane);
}

// P[(row_lane + 16 w) * PLD + ry RM + i] = s[i][w]: the thread's values,
// RM contiguous floats a streamed row.
template <typename T>
__device__ __forceinline__ void store_p(float* P, const float (&s)[T::RM][T::KW],
                                        int ry, int lane) {
  const int kx = row_lane<T::DG>(lane);
#pragma unroll
  for (int w = 0; w < T::KW; ++w) {
    float* dst = P + (kx + kSide * w) * T::PLD + ry * T::RM;
#pragma unroll
    for (int q = 0; q < T::RM / 4; ++q)
      *reinterpret_cast<float4*>(dst + 4 * q) =
          make_float4(s[4 * q][w], s[4 * q + 1][w], s[4 * q + 2][w],
                      s[4 * q + 3][w]);
  }
}

template <int RM>
__device__ __forceinline__ void ones(float (&a)[RM]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) a[i] = 1.0f;
}

template <int RM, int C>
__device__ __forceinline__ void zero(float (&a)[RM][C]) {
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) a[i][c] = 0.0f;
}

// Barriers at the head of the dynamic shared memory: full[SLOTS],
// empty[SLOTS], then the resident tile's.
template <typename T>
__device__ __forceinline__ void init_barriers(uint32_t bars) {
  constexpr int SLOTS = T::SLOTS;
  static_assert(8 * (2 * SLOTS + 1) <= kBarBytes, "barriers fit");
  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (SLOTS + s), T::kWarps);
    }
    mbar_init(bars + 16 * SLOTS, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// x[i][w] = fill where query row i0 + ry + NG i cannot see key j0 + kx +
// 16 w (the forward's logits, -1e30; dq's probabilities, 0).
template <typename T>
__device__ __forceinline__ void mask_tile(float (&x)[T::RM][T::KW],
                                       const Problem& p, int i0, int ry,
                                       int j0, int kx, float fill = kNegInf) {
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int w = 0; w < T::KW; ++w)
      if (!visible(p, i0 + ry + T::NG * i, j0 + kx + kSide * w))
        x[i][w] = fill;
}

// dk/dv's transposed tile: x[i][w] = 0 where query row i0 + kx + 16 w
// cannot see key j0 + ry + NG i.
template <typename T>
__device__ __forceinline__ void mask_tile_t(float (&x)[T::RM][T::KW],
                                         const Problem& p, int i0, int ry,
                                         int j0, int kx) {
#pragma unroll
  for (int i = 0; i < T::RM; ++i)
#pragma unroll
    for (int w = 0; w < T::KW; ++w)
      if (!visible(p, i0 + kx + kSide * w, j0 + ry + T::NG * i))
        x[i][w] = 0.0f;
}

// ------------------------------------------------------------------------
// forward
// ------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(FwdTile<D>::kThreads, 1)
flash_fwd_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, Problem p) {
  using T = FwdTile<D>;
  constexpr int RM = T::RM, KW = T::KW, LD = T::LD, BM = T::BM, BN = T::BN;
  constexpr int SLOTS = T::SLOTS, CW = T::CW, kSlot = BN * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * SLOTS;
  const uint32_t res = full0 + 16 * SLOTS;
  float* sQ = reinterpret_cast<float*>(smem + kBarBytes);  // [BM][LD]
  float* ring = sQ + BM * LD;                               // K, V stages
  float* sP = ring + SLOTS * kSlot;                         // [NPB][BN][PLD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int i0 = qb * BM;
  const int kvh = h / (p.H / p.KV);
  int kbeg, kend;
  key_range(p, i0, BM, BN, &kbeg, &kend);
  const int ntiles = tiles_between(kbeg, kend, BN);
  init_barriers<T>(full0);

  if (threadIdx.x < 128) {  // the producer warpgroup: warp 0 copies
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    fill_rows<D, LD>(sQ, q, nullptr, nullptr, b, i0, BM, p.Sq, p.H, h, res,
                     lane);
    for (int n = 0; n < 2 * ntiles; ++n) {
      wait_free<SLOTS>(empty0, n);
      const int s = slot_of<SLOTS>(n);
      fill_rows<D, LD>(ring + s * kSlot, n & 1 ? v : k, nullptr, nullptr, b,
                       kbeg + (n >> 1) * BN, BN, p.Sk, p.KV, kvh,
                       full0 + 8 * s, lane);
    }
    return;
  }

  setmaxnreg_inc<T::kConsumerRegs>();
  const int ry = (threadIdx.x - 128) / kSide;
  const int lane = (threadIdx.x - 128) % kSide;
  const int kx = row_lane<T::DG>(lane);
  float m[RM], l[RM], acc[RM][CW];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  zero(acc);
  mbar_wait(res, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = kbeg + t * BN;
    const int nk = 2 * t, nv = 2 * t + 1;
    mbar_wait(full0 + 8 * slot_of<SLOTS>(nk), phase_of<SLOTS>(nk));
    float s[RM][KW];
    rowdot<T>(s, sQ, ring + slot_of<SLOTS>(nk) * kSlot, ry, lane);
    release(empty0 + 8 * slot_of<SLOTS>(nk));

#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KW; ++w) s[i][w] *= p.scale;
    // one uniform branch: the mask only on the tiles that need it
    if (!all_visible(p, i0, BM, j0, BN)) mask_tile<T>(s, p, i0, ry, j0, kx);
    float alpha[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < KW; ++w) mx = fmaxf(mx, s[i][w]);
      const float mnew = fmaxf(m[i], row_max(mx));
      alpha[i] = expf(m[i] - mnew);
      m[i] = mnew;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < KW; ++w) {
        // a masked logit's probability is exactly 0: expf(-inf), no branch
        const float pr = expf(s[i][w] == kNegInf ? -INFINITY
                                                 : s[i][w] - mnew);
        sum += pr;
        s[i][w] = pr;
      }
      l[i] = l[i] * alpha[i] + sum;
    }
    // one P buffer: the last tile's O += P V must be done with it
    if (T::NPB == 1) row_group_sync();
    float* P = sP + (t % T::NPB) * BN * T::PLD;
    store_p<T>(P, s, ry, lane);
    row_group_sync();
    mbar_wait(full0 + 8 * slot_of<SLOTS>(nv), phase_of<SLOTS>(nv));
    accum<T>(acc, alpha, P, ring + slot_of<SLOTS>(nv) * kSlot, ry, lane);
    release(empty0 + 8 * slot_of<SLOTS>(nv));
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float total = row_sum(l[i]);
    const int row = i0 + ry + T::NG * i;
    if (row < p.Sq) {
      float out[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) out[c] = acc[i][c] / total;
      store_cols<D>(o + (((long long)b * p.Sq + row) * p.H + h) * D, lane,
                    out);
      if (lane == 0)
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

// dK and dV of one block of 16 RM keys of one kv head, over the units
// [u0, u1) of its (query head, query tile) list (head-major; the split
// `split` of `nsplit`, flash.dkdv_plan's formula): Q and dO tiles with their
// lse and delta stream through the ring. With nsplit > 1 the sums go
// unscaled to part[0][split] (dK) and part[1][split] (dV), each [B, Sk, KV,
// D], for flash_bwd_ffma_dkdv_sum_kernel.
template <int D>
__global__ void __launch_bounds__(DkdvTile<D>::kThreads, 1)
flash_bwd_ffma_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv,
                          float* __restrict__ part, int nsplit, Problem p) {
  using T = DkdvTile<D>;
  constexpr int RM = T::RM, KW = T::KW, LD = T::LD, BM = T::BM, BN = T::BN;
  constexpr int SLOTS = T::SLOTS, CW = T::CW;
  constexpr int kSlot = DkdvSmem<T>::kSlot;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * SLOTS;
  const uint32_t res = full0 + 16 * SLOTS;
  float* sK = reinterpret_cast<float*>(smem + kBarBytes);  // [BM][LD]
  float* sV = sK + BM * LD;                                 // [BM][LD]
  float* ring = sV + BM * LD;  // Q or dO [BN][LD], then lse or delta [BN]
  float* sP = ring + SLOTS * kSlot;                         // [BN][PLD]

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kb = blockIdx.z / nsplit, split = blockIdx.z % nsplit;
  const int j0 = kb * BM;
  const int rep = p.H / p.KV;
  int qbeg, qend;
  query_range(p, j0, BM, BN, &qbeg, &qend);
  const int ntq = tiles_between(qbeg, qend, BN);
  const long long units = (long long)rep * ntq;
  const long long plane = (long long)p.B * p.Sk * p.KV * D;
  const int u0 = (int)(units * split / nsplit);
  const int u1 = (int)(units * (split + 1) / nsplit);
  init_barriers<T>(full0);

  if (threadIdx.x < 128) {  // the producer warpgroup: warp 0 copies
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    fill_rows<D, LD>(sK, k, sV, v, b, j0, BM, p.Sk, p.KV, kvh, res, lane);
    for (int n = 0; n < 2 * (u1 - u0); ++n) {
      wait_free<SLOTS>(empty0, n);
      const int u = u0 + (n >> 1), h = kvh * rep + u / ntq;
      const int i0 = qbeg + (u % ntq) * BN;
      float* slot = ring + slot_of<SLOTS>(n) * kSlot;
      fill_rows<D, LD>(slot, n & 1 ? dout : q, nullptr, nullptr, b, i0, BN,
                       p.Sq, p.H, h, full0 + 8 * slot_of<SLOTS>(n), lane,
                       n & 1 ? delta : lse, slot + BN * LD, p.H, h);
    }
    return;
  }

  setmaxnreg_inc<T::kConsumerRegs>();
  const int ry = (threadIdx.x - 128) / kSide;
  const int lane = (threadIdx.x - 128) % kSide;
  const int kx = row_lane<T::DG>(lane);
  float acc_dk[RM][CW], acc_dv[RM][CW], one[RM];
  zero(acc_dk);
  zero(acc_dv);
  ones(one);
  mbar_wait(res, 0);  // also where no unit is left: the copies land first

  for (int u = u0; u < u1; ++u) {
    const int n = 2 * (u - u0);
    const int i0 = qbeg + (u % ntq) * BN;
    const float* sQ = ring + slot_of<SLOTS>(n) * kSlot;
    const float* sdO = ring + slot_of<SLOTS>(n + 1) * kSlot;
    const float* sL = sQ + BN * LD;
    const float* sD = sdO + BN * LD;

    // S^T = K Q^T, P^T = exp(scale S^T - lse) on visible pairs
    mbar_wait(full0 + 8 * slot_of<SLOTS>(n), phase_of<SLOTS>(n));
    float pt[RM][KW];
    rowdot<T>(pt, sK, sQ, ry, lane);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KW; ++w)
        pt[i][w] = expf(pt[i][w] * p.scale - sL[kx + kSide * w]);
    if (!all_visible(p, i0, BN, j0, BM))
      mask_tile_t<T>(pt, p, i0, ry, j0, kx);
    // dP^T = V dO^T, dS^T = P^T (dP^T - delta)
    mbar_wait(full0 + 8 * slot_of<SLOTS>(n + 1), phase_of<SLOTS>(n + 1));
    float ds[RM][KW];
    rowdot<T>(ds, sV, sdO, ry, lane);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KW; ++w)
        ds[i][w] = pt[i][w] * (ds[i][w] - sD[kx + kSide * w]);
    if constexpr (kDsPath<D>) {
      // dS^T for dq: [B, H, Sk, ds_row(Sq)] after the partial sums
      const long long ld = ds_row<D>(p.Sq);
      float* out = part + (nsplit > 1 ? 2LL * nsplit * plane : 0) +
                   ((long long)b * p.H + kvh * rep + u / ntq) * p.Sk * ld;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int key = j0 + ry + T::NG * i;
#pragma unroll
        for (int w = 0; w < KW; ++w) {
          const int row = i0 + kx + kSide * w;
          if (key < p.Sk && row < p.Sq) out[key * ld + row] = ds[i][w];
        }
      }
    }

    // the last unit's products are done with the buffers
    row_group_sync();
    store_p<T>(sP, pt, ry, lane);
    row_group_sync();
    accum<T>(acc_dv, one, sP, sdO, ry, lane);  // dV += P^T dO
    release(empty0 + 8 * slot_of<SLOTS>(n + 1));
    row_group_sync();
    store_p<T>(sP, ds, ry, lane);
    row_group_sync();
    accum<T>(acc_dk, one, sP, sQ, ry, lane);  // dK += dS^T Q
    release(empty0 + 8 * slot_of<SLOTS>(n));
  }

  float* out_k = nsplit > 1 ? part + split * plane : dk;
  float* out_v = nsplit > 1 ? part + (nsplit + split) * plane : dv;
  const float sk = nsplit > 1 ? 1.0f : p.scale;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = j0 + ry + T::NG * i;
    if (key < p.Sk) {
      const long long off = (((long long)b * p.Sk + key) * p.KV + kvh) * D;
      float x[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) x[c] = acc_dk[i][c] * sk;
      store_cols<D>(out_k + off, lane, x);
      store_cols<D>(out_v + off, lane, acc_dv[i]);
    }
  }
}

// dk = sum_s scale * part[0][s], dv = sum_s part[1][s], s = 0, 1, ...,
// nsplit - 1 in that order (a fused multiply-add a partial): n floats of
// each, 4 a thread.
template <int D>
__global__ void flash_bwd_ffma_dkdv_sum_kernel(const float* __restrict__ part,
                                              float* __restrict__ dk,
                                              float* __restrict__ dv,
                                              long long n, int nsplit,
                                              float scale) {
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int s = 0; s < nsplit; ++s) {
    const float4 x = ld4(part + s * n + e);
    const float4 y = ld4(part + (nsplit + s) * n + e);
    a.x = fmaf(x.x, scale, a.x); a.y = fmaf(x.y, scale, a.y);
    a.z = fmaf(x.z, scale, a.z); a.w = fmaf(x.w, scale, a.w);
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  *reinterpret_cast<float4*>(dk + e) = a;
  *reinterpret_cast<float4*>(dv + e) = c;
}

// dQ of one block of 16 RM query rows of one head: K and V tiles stream
// through the ring.
template <int D>
__global__ void __launch_bounds__(DqTile<D>::kThreads, 1)
flash_bwd_ffma_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, Problem p) {
  using T = DqTile<D>;
  constexpr int RM = T::RM, KW = T::KW, LD = T::LD, BM = T::BM, BN = T::BN;
  constexpr int SLOTS = T::SLOTS, CW = T::CW, kSlot = BN * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * SLOTS;
  const uint32_t res = full0 + 16 * SLOTS;
  float* sQ = reinterpret_cast<float*>(smem + kBarBytes);  // [BM][LD]
  float* sdO = sQ + BM * LD;                                // [BM][LD]
  float* ring = sdO + BM * LD;                              // K, V stages
  float* sP = ring + SLOTS * kSlot;                         // [NPB][BN][PLD]

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int i0 = qb * BM;
  const int kvh = h / (p.H / p.KV);
  int kbeg, kend;
  key_range(p, i0, BM, BN, &kbeg, &kend);
  const int ntiles = tiles_between(kbeg, kend, BN);
  init_barriers<T>(full0);

  if (threadIdx.x < 128) {  // the producer warpgroup: warp 0 copies
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    fill_rows<D, LD>(sQ, q, sdO, dout, b, i0, BM, p.Sq, p.H, h, res, lane);
    for (int n = 0; n < 2 * ntiles; ++n) {
      wait_free<SLOTS>(empty0, n);
      const int s = slot_of<SLOTS>(n);
      fill_rows<D, LD>(ring + s * kSlot, n & 1 ? v : k, nullptr, nullptr, b,
                       kbeg + (n >> 1) * BN, BN, p.Sk, p.KV, kvh,
                       full0 + 8 * s, lane);
    }
    return;
  }

  setmaxnreg_inc<T::kConsumerRegs>();
  const int ry = (threadIdx.x - 128) / kSide;
  const int lane = (threadIdx.x - 128) % kSide;
  const int kx = row_lane<T::DG>(lane);
  float lr[RM], dr[RM], acc[RM][CW], one[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = i0 + ry + T::NG * i;
    const long long at = ((long long)b * p.H + h) * p.Sq + row;
    lr[i] = row < p.Sq ? lse[at] : 0.0f;
    dr[i] = row < p.Sq ? delta[at] : 0.0f;
  }
  zero(acc);
  ones(one);
  mbar_wait(res, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int j0 = kbeg + t * BN;
    const int nk = 2 * t, nv = 2 * t + 1;
    const float* sK = ring + slot_of<SLOTS>(nk) * kSlot;
    mbar_wait(full0 + 8 * slot_of<SLOTS>(nk), phase_of<SLOTS>(nk));
    float pr[RM][KW];
    rowdot<T>(pr, sQ, sK, ry, lane);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KW; ++w) pr[i][w] = expf(pr[i][w] * p.scale - lr[i]);
    if (!all_visible(p, i0, BM, j0, BN)) mask_tile<T>(pr, p, i0, ry, j0, kx, 0.0f);
    mbar_wait(full0 + 8 * slot_of<SLOTS>(nv), phase_of<SLOTS>(nv));
    float ds[RM][KW];
    rowdot<T>(ds, sdO, ring + slot_of<SLOTS>(nv) * kSlot, ry, lane);
    release(empty0 + 8 * slot_of<SLOTS>(nv));
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int w = 0; w < KW; ++w) ds[i][w] = pr[i][w] * (ds[i][w] - dr[i]);

    if (T::NPB == 1) row_group_sync();  // the last tile's dQ += dS K is done
    float* P = sP + (t % T::NPB) * BN * T::PLD;
    store_p<T>(P, ds, ry, lane);
    row_group_sync();
    accum<T>(acc, one, P, sK, ry, lane);  // dQ += dS K
    release(empty0 + 8 * slot_of<SLOTS>(nk));
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = i0 + ry + T::NG * i;
    if (row < p.Sq) {
      float x[CW];
#pragma unroll
      for (int c = 0; c < CW; ++c) x[c] = acc[i][c] * p.scale;
      store_cols<D>(dq + (((long long)b * p.Sq + row) * p.H + h) * D, lane, x);
    }
  }
}

// Rows [j0, j0 + R) of K (head kvh) and of dS^T (head h, columns [i0, i0 +
// BM) of rows of ds_row floats) into a stage, by bulk copies that complete
// on `bar`; rows past Sk zeroed. All 32 lanes of the producer warp.
template <typename T>
__device__ __forceinline__ void fill_ds_stage(float* stage, const float* k,
                                              const float* ds, const Problem& p,
                                              int b, int kvh, int h, int j0,
                                              int i0, uint32_t bar, int lane) {
  constexpr int D = T::D, LD = T::LD, BN = T::BN, BM = T::BM, PLD = T::PLD;
  float* sK = stage;
  float* sS = stage + BN * LD;
  const int nv = max(0, min(BN, p.Sk - j0));
  for (int r = nv + lane; r < BN; r += 32) {
    for (int c = 0; c < D / 4; ++c)
      reinterpret_cast<float4*>(sK + r * LD)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c = 0; c < BM / 4; ++c)
      reinterpret_cast<float4*>(sS + r * PLD)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) mbar_expect_tx(bar, nv * (D + BM) * 4);
  __syncwarp();
  const long long ld = ds_row<D>(p.Sq);
  const float* dsh = ds + ((long long)b * p.H + h) * p.Sk * ld + i0;
  for (int r = lane; r < nv; r += 32) {
    const long long j = j0 + r;
    bulk_copy(sK + r * LD, k + ((b * (long long)p.Sk + j) * p.KV + kvh) * D,
              D * 4, bar);
    bulk_copy(sS + r * PLD, dsh + j * ld, BM * 4, bar);
  }
}

// dQ of 128 query rows of one head as dQ += dS K from the dS^T that dk/dv
// wrote (kDsPath): stages of K and dS^T stream through the ring; entries
// of a stage for pairs that cannot see each other, which dk/dv did not
// write, are zeroed first on the tiles that hold any.
template <int D>
__global__ void __launch_bounds__(DqDsTile<D>::kThreads, 1)
flash_bwd_ffma_dq_ds_kernel(const float* __restrict__ k,
                           const float* __restrict__ ds,
                           float* __restrict__ dq, Problem p) {
  using T = DqDsTile<D>;
  constexpr int RM = T::RM, BM = T::BM, BN = T::BN, SLOTS = T::SLOTS;
  constexpr int CW = T::CW, kStage = DqDsSmem<T>::kStage;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t full0 = smem_u32(smem), empty0 = full0 + 8 * SLOTS;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qb = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int i0 = qb * BM;
  const int kvh = h / (p.H / p.KV);
  int kbeg, kend;
  key_range(p, i0, BM, BN, &kbeg, &kend);
  const int ntiles = tiles_between(kbeg, kend, BN);
  init_barriers<T>(full0);

  if (threadIdx.x < 128) {  // the producer warpgroup: warp 0 copies
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x >= 32) return;
    for (int n = 0; n < ntiles; ++n) {
      wait_free<SLOTS>(empty0, n);
      fill_ds_stage<T>(ring + slot_of<SLOTS>(n) * kStage, k, ds, p, b, kvh,
                       h, kbeg + n * BN, i0, full0 + 8 * slot_of<SLOTS>(n),
                       threadIdx.x);
    }
    return;
  }

  setmaxnreg_inc<T::kConsumerRegs>();
  const int ry = (threadIdx.x - 128) / kSide;
  const int lane = (threadIdx.x - 128) % kSide;
  float acc[RM][CW], one[RM];
  zero(acc);
  ones(one);
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = kbeg + t * BN;
    float* sK = ring + slot_of<SLOTS>(t) * kStage;
    float* sS = sK + BN * T::LD;
    mbar_wait(full0 + 8 * slot_of<SLOTS>(t), phase_of<SLOTS>(t));
    if (!all_visible(p, i0, BM, j0, BN)) {  // a uniform branch
      // each row group zeroes its own rows' entries, which only it reads
#pragma unroll 1
      for (int i = 0; i < RM; ++i)
#pragma unroll 1
        for (int w = 0; w < BN / kSide; ++w) {
          const int r = ry * RM + i, key = lane + kSide * w;
          if (!visible(p, i0 + r, j0 + key)) sS[key * T::PLD + r] = 0.0f;
        }
      row_group_sync();
    }
    accum<T>(acc, one, sS, sK, ry, lane);  // dQ += dS K
    release(empty0 + 8 * slot_of<SLOTS>(t));
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = i0 + ry * RM + i;
    if (row < p.Sq) {
      float x[CW];
#pragma unroll
      for (int cc = 0; cc < CW; ++cc) x[cc] = acc[i][cc] * p.scale;
      store_cols<D>(dq + (((long long)b * p.Sq + row) * p.H + h) * D, lane, x);
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
         (p.Sq + 63) / 64 <= 65535 && (p.Sk + 63) / 64 <= 65535;
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
  using T = FwdTile<D>;
  const int smem = FwdSmem<T>::kBytes;
  cudaError_t err = allow_smem(flash_fwd_ffma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.H, (unsigned)p.B,
                  (unsigned)((p.Sq + T::BM - 1) / T::BM));
  flash_fwd_ffma_kernel<D><<<grid, T::kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, void* part, int nsplit, const Problem& p,
                cudaStream_t s) {
  using TK = DkdvTile<D>;
  using TQ = DqTile<D>;
  const long long nkb = (p.Sk + TK::BM - 1) / TK::BM;
  if (nsplit < 1 || nkb * nsplit > 65535 ||
      ((nsplit > 1 || kDsPath<D>) && (!part || !aligned(part))))
    return cudaErrorInvalidValue;
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

  const int smem_kv = DkdvSmem<TK>::kBytes;
  err = allow_smem(flash_bwd_ffma_dkdv_kernel<D>, smem_kv);
  if (err != cudaSuccess) return err;
  // z = key block * nsplit + split: key block 0 (the heaviest under a causal
  // mask) first
  const dim3 grid_kv((unsigned)p.KV, (unsigned)p.B,
                     (unsigned)(nkb * nsplit));
  flash_bwd_ffma_dkdv_kernel<D><<<grid_kv, TK::kThreads, smem_kv, s>>>(
      qf, kf, vf, dof, lf, df, static_cast<float*>(dk),
      static_cast<float*>(dv), static_cast<float*>(part), nsplit, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nsplit > 1) {
    const long long n = (long long)p.B * p.Sk * p.KV * D;
    flash_bwd_ffma_dkdv_sum_kernel<D><<<(unsigned)((n / 4 + 255) / 256), 256,
                                       0, s>>>(
        static_cast<const float*>(part), static_cast<float*>(dk),
        static_cast<float*>(dv), n, nsplit, p.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }

  // each head dim builds the one dq kernel it takes
  if constexpr (kDsPath<D>) {
    using TS = DqDsTile<D>;
    const int smem_s = DqDsSmem<TS>::kBytes;
    err = allow_smem(flash_bwd_ffma_dq_ds_kernel<D>, smem_s);
    if (err != cudaSuccess) return err;
    const dim3 grid_s((unsigned)p.H, (unsigned)p.B,
                      (unsigned)((p.Sq + TS::BM - 1) / TS::BM));
    const long long parts =
        nsplit > 1 ? 2LL * nsplit * p.B * p.Sk * p.KV * D : 0;
    flash_bwd_ffma_dq_ds_kernel<D><<<grid_s, TS::kThreads, smem_s, s>>>(
        kf, static_cast<const float*>(part) + parts, static_cast<float*>(dq),
        p);
    return cudaGetLastError();
  } else {
    const int smem_q = DqSmem<TQ>::kBytes;
    err = allow_smem(flash_bwd_ffma_dq_kernel<D>, smem_q);
    if (err != cudaSuccess) return err;
    const dim3 grid_q((unsigned)p.H, (unsigned)p.B,
                      (unsigned)((p.Sq + TQ::BM - 1) / TQ::BM));
    flash_bwd_ffma_dq_kernel<D><<<grid_q, TQ::kThreads, smem_q, s>>>(
        qf, kf, vf, dof, lf, df, static_cast<float*>(dq), p);
    return cudaGetLastError();
  }
}

}  // namespace

// All tensors float32 and 16-byte aligned; lse and delta [B, H, Sq].
// window <= 0: no sliding window. D in {64, 80, 112, 128, 256}. scale <= 0:
// the softmax scale 1/sqrt(D). Returns the launches' cudaError_t
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
    case 112: return (int)fwd<112>(q, k, v, o, lse, p, s);
    case 128: return (int)fwd<128>(q, k, v, o, lse, p, s);
    case 256: return (int)fwd<256>(q, k, v, o, lse, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// delta: float32 scratch [B, H, Sq] the caller allocates. nsplit: the dk/dv
// blocks' split (flash.dkdv_plan). part: float32 scratch the caller
// allocates (flash.bwd_scratch bytes): with nsplit > 1 the partial sums [2,
// nsplit, B, Sk, KV, D], then at D = 256 dS^T [B, H, Sk, Sq rounded up to
// 128]; null where neither is needed.
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv,
                             void* part, int nsplit, int B, int Sq, int Sk,
                             int H, int KV, int D, int causal, int window,
                             int q_offset, float scale, void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset, scale);
  if (!problem_ok(p) || !aligned(q) || !aligned(k) || !aligned(v) ||
      !aligned(o) || !aligned(dout))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return (int)bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                          nsplit, p, s);
    case 80:
      return (int)bwd<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                          nsplit, p, s);
    case 112:
      return (int)bwd<112>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                           nsplit, p, s);
    case 128:
      return (int)bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                           nsplit, p, s);
    case 256:
      return (int)bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, part,
                           nsplit, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
