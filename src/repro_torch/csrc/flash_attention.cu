// Causal / sliding-window GQA flash attention, forward and backward, bf16
// in and out, float32 inside, for Hopper (sm_90a): TMA loads into a ring of
// shared-memory stages paced by mbarriers, wgmma tensor-core products with
// the accumulators in registers, one producer warpgroup and two consumer
// warpgroups per thread block.
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
// Bound: operations. At the train path's [1, 4096, 32, 80] the forward does
// 2*D multiply-adds per visible (query, key) pair (about 86 GFLOP) on 84 MB
// of inputs and outputs, far above the card's 295 operations per byte in
// bf16, so the tensor cores set the floor. The design:
//   * Tiles in shared memory. A tile of R rows of one head is D/16 chunks
//     of [R][16] bf16 (32-byte rows) in the 32-byte swizzle (bit 4 of a byte
//     offset XOR bit 7: the two 16-byte halves of a row swap on rows 4-7 of
//     every 8). Every head dim (64, 80, 112, 128, 256) is a whole number of
//     chunks, so 80 and 112 need no padding: a k16 step of a K-major
//     operand is one chunk, and an MN-major operand spans the chunks at a
//     fixed stride (the descriptor's leading offset).
//   * TMA. q, k, v and dO are 4-D tensor maps (D, heads, S, B) with a box
//     of {16, 1, 64, 1} (128 rows for the forward's Q tile and its K and V
//     stages of 128 keys); one thread issues the boxes of a tile, the
//     hardware zero-fills rows past S, and the stage's mbarrier counts the
//     bytes. Tensor maps are encoded on the host per call through the
//     entry point cudaGetDriverEntryPoint hands out (no -lcuda).
//   * Warp specialisation. Warpgroup 0 produces (one thread issues TMA;
//     setmaxnreg drops it to 24 registers), warpgroups 1 and 2 consume (240
//     registers each), each owning 64 rows of the block's 128. A ring of 2
//     stages with full and empty mbarriers overlaps the next tile's load
//     with this one's products.
//   * wgmma. S = Q K^T takes both operands from shared memory into
//     registers; the online softmax runs on the accumulator fragment (row
//     max and sum over the 4 lanes of a row, ex2.approx with the scale
//     folded in log2 units); P is rounded to bf16 straight into the A-operand
//     registers of O += P V, whose V operand is MN-major in shared memory.
//     O stays in registers until the epilogue writes o and lse.
//   * Masks only on the tiles that need them (the causal diagonal, the
//     window's edge, the ragged end); tiles no row of the block can see are
//     never loaded. Causal grids launch the heaviest query tiles first.
//   * Block order. The forward and dq grids run the blocks of a group of
//     heads together (heads fastest, then the query tiles, heaviest first)
//     and one group after another: every head where the K and V the blocks
//     stream fit in half the L2, else the largest group that fits
//     (grouped). zamba2's 32 heads of 112 stream 59 MB of K and V, past
//     the H100's 50 MB: 8 heads a group.
//   * Short sequences (Sq <= 64 and Sk <= 64: transformer-table1's folded
//     [288, 32, 2, 64]): a block of 128 rows would leave its second
//     consumer warpgroup on rows past Sq and stream a 128-key stage of
//     which 64 keys at most are real. flash_fwd_short_kernel gives each of
//     its two warpgroups its own (batch, head) item instead: one TMA load
//     of 64 rows of Q, K and V onto the warpgroup's own mbarrier, one
//     S = Q K^T, the softmax in one pass, one O += P V. No producer
//     warpgroup and no ring: half the blocks of the general kernel, and at
//     head dims up to 80 two blocks an SM.
//   * Backward: a delta = rowsum(dO * O) pass (a thread a 16-byte chunk,
//     coalesced), then dk/dv per 128 keys of a kv head (64 per consumer
//     warpgroup; tiles of 64 query rows of Q and dO, with their lse and
//     delta, stream through the ring, summed over the H/KV query heads),
//     then dq per 128 query rows (tiles of 128 keys of K and V stream
//     through the ring). S^T and dP^T (S and dP) are issued together, and
//     the softmax of one overlaps the other's product. Every sum stays in
//     one thread block or in a fixed-order pass: no atomics, deterministic
//     runs.
//   * dk/dv grids that fill the card. A dk/dv block owns a key block of one
//     kv head and loops over its units, the (query head, query tile) pairs
//     some row of which sees a key of the block, head-major. Where KV * B *
//     key blocks is under one wave of the SMs (gemma_2b's one kv head: 64
//     blocks on 132 SMs; qwen25_3b's two: 64) the wrapper's plan
//     (flash.dkdv_plan, the float32 kernels' with this file's tiles)
//     splits each key block's units into nsplit contiguous runs, one block
//     each; a run writes its dK and dV unscaled in float32 to scratch [2,
//     nsplit, B, Sk, KV, D], and flash_bwd_dkdv_sum_kernel adds the runs
//     in split order, scales dK and rounds both to bf16. The vlm's and
//     mistral's 256 blocks stay whole: split 3 ways they ran slower, the
//     partial sums' traffic outweighing the balance.
//   * D = 256 (Tiles<256>): 64 keys a forward stage and a dk/dv block. dK
//     and dV of 64 keys would need 256 float32 accumulators a thread, so
//     each consumer warpgroup holds one half of the head dim of both (128
//     registers). S^T and dP^T are computed once a tile: each warpgroup
//     takes 32 of the tile's 64 query columns (two m64n32 products), forms
//     its half of P^T and dS^T, and writes both in bf16 to shared memory
//     (8 KiB each, in the swizzled K-major layout a TMA load would give)
//     behind a named barrier; then dV += P^T dO and dK += dS^T Q run on its
//     128 columns with both operands in shared memory: 4 products a tile,
//     2 on each warpgroup. dk/dv also writes dS^T, rounded to bf16 as dq
//     rounds it before its product, to scratch [B, H, Sk, Sq rounded up to
//     128], and flash_bwd_dq_ds_kernel forms dQ += dS K from it: stages of
//     128 keys of K and of dS^T (its [keys][16 queries] boxes are the
//     MN-major A operand as they land), no recomputation of S and dP.
//     Entries dk/dv did not write (pairs no row of a query tile sees) are
//     zeroed in shared memory on the tiles a mask cuts.
// P and dS are rounded to bf16 before they feed a product, as the
// reference's probs.astype(q.dtype) does. The softmax scale is the true
// 1/sqrt(D) of the caller's head dim (the Python wrapper passes it where
// it zero-pads D to a built one).

#include <cuda.h>  // CUtensorMap and its enums; the entry point is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBox = 64;          // rows of a TMA box and of a warpgroup's tile
constexpr int kChunkCols = 16;    // bf16 columns of a swizzle chunk (k16)
constexpr int kConsumers = 2;     // consumer warpgroups per block
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlockRows = kBox * kConsumers;  // query rows per block
constexpr int kStages = 2;
constexpr int kBwdTile = 64;      // query rows per streamed dk/dv tile
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use

// Tile sizes of a head dim: keys a forward stage, keys a dk/dv block, keys
// a dq stage, and whether dk/dv writes dS^T for dq (kDsPath). Up to 128 a
// forward or dq stage streams 128 keys and a dk/dv block owns 128 keys, 64
// per consumer warpgroup. At 256 a stage of 128 keys of K and V is 128 KiB
// and two stages overflow the 227 KiB a block may use: the forward streams
// 64 keys a stage, a dk/dv block owns 64 keys (each consumer warpgroup half
// the head dim of dK and dV), and dq streams 128 keys of K and of dS^T.
template <int kFwd, int kDkdv, int kDq, bool kDs>
struct TileSizes {
  static constexpr int kFwdKeys = kFwd;
  static constexpr int kDkdvKeys = kDkdv;
  static constexpr int kDqKeys = kDq;
  static constexpr bool kDsPath = kDs;
};
template <int D>
struct Tiles : TileSizes<128, 128, 128, false> {};
template <>
struct Tiles<256> : TileSizes<64, 64, 128, true> {};
// dS^T rows are padded to whole dq blocks (flash.DQ_DS_ROWS)
constexpr int kDqDsRows = kBlockRows;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Problem {
  int B, Sq, Sk, H, KV, causal, window, q_offset;
  float scale;  // 1/sqrt(D)
  int hg;       // query heads of a block-order group (forward, dq)
};

// Block `linear` of a grid that runs the blocks of `group` heads together
// (head fastest, then `tiles` tiles a head in order) and one group after
// another: its head and tile.
__device__ __forceinline__ void block_order(int linear, int tiles, int group,
                                            int* head, int* tile) {
  const int per = group * tiles;
  if (per == (int)gridDim.x) {  // one group: two divisions fewer
    *head = linear % group;
    *tile = linear / group;
    return;
  }
  *head = linear / per * group + linear % per % group;
  *tile = linear % per / group;
}

__device__ __forceinline__ bool visible(const Problem& p, int qpos, int kpos) {
  if (kpos >= p.Sk) return false;
  if (p.causal && kpos > qpos) return false;
  if (p.window > 0 && kpos <= qpos - p.window) return false;
  return true;
}

// True when every (query, key) pair of query positions [qa, qa + 64) and
// keys [k0, k0 + nkeys) is visible (and in range): no mask needed.
__device__ __forceinline__ bool all_visible(const Problem& p, int qa, int k0,
                                            int nkeys) {
  if (k0 + nkeys > p.Sk) return false;
  if (p.causal && k0 + nkeys - 1 > qa) return false;
  if (p.window > 0 && k0 <= qa + kBox - 1 - p.window) return false;
  return true;
}

// First key (aligned down to `tile`) and end key of the keys some row of
// [q0, q0 + rows) can see.
__device__ __forceinline__ void key_range(const Problem& p, int q0, int rows,
                                          int tile, int* k_begin,
                                          int* k_end) {
  const int qlo = p.q_offset + q0;
  const int qhi = p.q_offset + min(q0 + rows, p.Sq) - 1;
  int end = p.Sk;
  if (p.causal) end = min(end, qhi + 1);
  int begin = 0;
  if (p.window > 0) begin = max(0, qlo - p.window + 1);
  *k_begin = (begin / tile) * tile;
  *k_end = end;
}

// First query (aligned down to `tile`) and end query of the rows that can
// see some key of [k0, k0 + keys).
__device__ __forceinline__ void query_range(const Problem& p, int k0,
                                            int keys, int tile,
                                            int* q_begin, int* q_end) {
  const int k_last = min(k0 + keys, p.Sk) - 1;
  int begin = 0, end = p.Sq;
  if (p.causal) begin = max(0, k0 - p.q_offset);
  if (p.window > 0) end = min(p.Sq, k_last + p.window - p.q_offset);
  *q_begin = (begin / tile) * tile;
  *q_end = end;
}

__device__ __forceinline__ int tiles_between(int begin, int end, int tile) {
  return end > begin ? (end - begin + tile - 1) / tile : 0;
}

// ------------------------------------------------------------------------
// PTX: shared addresses, mbarriers, TMA, wgmma, setmaxnreg
// ------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrives at named barrier `id` without waiting (the producer's side of a
// hand-over).
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Orders this thread's generic-proxy stores to shared memory before the
// async proxy's reads (wgmma operands) that follow a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_u16(uint32_t addr, uint16_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" ::"r"(addr), "h"(v) : "memory");
}

// Byte offset of element (row, col) in a tile of `rows` rows stored as
// chunks of 16 columns, [rows][16] bf16 each, in the 32-byte swizzle: what
// a TMA load of {16, rows} boxes writes, for a tile based at a multiple of
// 256 bytes.
__device__ __forceinline__ uint32_t swizzled(int rows, int row, int col) {
  return (col / kChunkCols) * rows * 32 + row * 32 +
         (((col % kChunkCols) * 2) ^ ((row & 4) << 2));
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + R) of one head of a (D, heads, S, B) tensor map into
// the chunked tile at `dst`: chunk j (columns 16j .. 16j+15) at dst + j*R*32,
// as R/Box boxes of [Box][16] (Box: the map's box rows).
template <int R, int D, int Box = kBox>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int j = 0; j < D / kChunkCols; ++j)
#pragma unroll
    for (int hf = 0; hf < R / Box; ++hf)
      tma_load(dst + j * R * 32 + hf * Box * 32, map, bar, j * kChunkCols,
               head, row0 + hf * Box, b);
}

// wgmma shared-memory descriptors for the 32-byte swizzle (mode 3): the
// address, the leading byte offset (LBO) and the stride byte offset (SBO),
// in 16-byte units. K-major: 8-row groups 256 bytes apart (SBO), LBO
// unused (1). MN-major: 8-row groups of K 256 bytes apart (SBO), chunks of
// 16 MN columns `rows` * 32 bytes apart (LBO).
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int rows) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((rows * 32) >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from reading (or moving) accumulator registers across
// the asynchronous products that write them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.0f;
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B in shared memory: K-major
// where TA (TB) is 0, MN-major where it is 1.
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc);

// d[64 x N] += A[64 x 16] B[16 x N], A in registers (the accumulator
// layout of a 64 x 16 slice, rounded to bf16 pairs), B MN-major in shared
// memory.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int acc);

// The specialisations list every accumulator register (N/2 a thread).
template <>
__device__ __forceinline__ void wgmma_ss<32, 0, 0>(float (&d)[16], uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<64, 0, 0>(float (&d)[32], uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, 0, 0>(float (&d)[64], uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128, 0, 1>(float (&d)[64], uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<256, 1, 1>(float (&d)[128], uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float (&d)[56],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The bf16 A operand of k-step kk from a float accumulator fragment whose
// columns are that operand's K: registers 8kk .. 8kk+7 hold columns 16kk ..
// 16kk+15 of the thread's two rows in the A layout's order.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void to_a_operand(const float (&s)[N / 2],
                                             uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Accumulator layout of a 64 x N wgmma tile: thread t of the warpgroup holds
// rows 16*(t/32) + (t%32)/4 (registers 4i, 4i+1) and that row + 8
// (registers 4i+2, 4i+3), columns 8i + 2*(t%4) + {0, 1}.
__device__ __forceinline__ int frag_row(int tid) {
  return 16 * (tid / 32) + (tid % 32) / 4;
}

__device__ __forceinline__ int frag_col(int tid, int i) {
  return 8 * i + 2 * (tid % 4);
}

// 2^x on the special-function unit (ex2.approx, flushing subnormals):
// relative error about 2^-22, far below the bf16 rounding P and dS get.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(bf16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// Write rows `row` and `row + 8` of a 64 x N accumulator, times `mul0` and
// `mul1`, as columns col0 .. col0 + N - 1 of a [B, S, heads, D] tensor of T
// (bf16, or float32 for the dk/dv split's partial sums).
template <int N, int D, typename T>
__device__ __forceinline__ void store_frag(const float (&acc)[N / 2], T* dst,
                                           int tid, int b, int row, int S,
                                           int heads, int head, int col0,
                                           float mul0, float mul1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row + 8 * half;
    if (s >= S) continue;
    const float mul = half ? mul1 : mul0;
    T* out = dst + (((long long)b * S + s) * heads + head) * D + col0;
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      store2(out + frag_col(tid, i), acc[4 * i + 2 * half] * mul,
             acc[4 * i + 2 * half + 1] * mul);
  }
}

// Aligns the dynamic shared memory to 1024 bytes (the swizzle and TMA want
// at least 256).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// The online softmax of one 64 x N tile of logits `s` (rows r and r + 8 of
// the thread, masked entries -inf) against the running row max m (base-2
// units) and this thread's share of the row sums l: s becomes P, and the
// factors by which the earlier O and l shrink are returned in a0, a1.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N / 2], float scale2,
                                             float& m0, float& m1, float& l0,
                                             float& l1, float& a0,
                                             float& a1) {
  float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
  }
  const float n0 = fmaxf(m0, quad_max(mx0) * scale2);
  const float n1 = fmaxf(m1, quad_max(mx1) * scale2);
  const float u0 = n0 == -CUDART_INF_F ? 0.0f : n0;
  const float u1 = n1 == -CUDART_INF_F ? 0.0f : n1;
  a0 = fast_exp2(m0 - u0);
  a1 = fast_exp2(m1 - u1);
  m0 = n0;
  m1 = n1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int i = 0; i < N / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[4 * i + e] = fast_exp2(fmaf(s[4 * i + e], scale2, -u0));
      s[4 * i + 2 + e] = fast_exp2(fmaf(s[4 * i + 2 + e], scale2, -u1));
      sum0 += s[4 * i + e];
      sum1 += s[4 * i + 2 + e];
    }
  l0 = l0 * a0 + sum0;  // this thread's share; summed over the quad last
  l1 = l1 * a1 + sum1;
}

// o = acc / l and lse = m + log2(l) (natural units) of rows `row` and `row
// + 8` of one head.
template <int D>
__device__ __forceinline__ void store_out(const float (&acc_o)[D / 2],
                                          bf16* o, float* lse, int tid,
                                          const Problem& p, int b, int h,
                                          int row, float m0, float m1,
                                          float l0, float l1) {
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_frag<D, D>(acc_o, o, tid, b, row, p.Sq, p.H, h, 0, 1.0f / l0,
                   1.0f / l1);
  if (tid % 4 == 0) {
    float* out = lse + ((long long)b * p.H + h) * p.Sq;
    if (row < p.Sq) out[row] = (m0 + log2f(l0)) * kLn2;
    if (row + 8 < p.Sq) out[row + 8] = (m1 + log2f(l1)) * kLn2;
  }
}

// ------------------------------------------------------------------------
// forward: o, lse
// ------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  // stages of K and V: 3 up to D = 128 (the pipelined loop releases a
  // stage a tile later), 2 at 256
  static constexpr int kRing = Tiles<D>::kDsPath ? kStages : kStages + 1;
  static constexpr int kQ = kBlockRows * D * 2;   // Q tile, 128 rows
  static constexpr int kKV = Tiles<D>::kFwdKeys * D * 2;  // one K or V tile
  static constexpr int kStage = 2 * kKV;          // K then V
  static constexpr int kBars = kQ + kRing * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kRing) + 1024;
};
static_assert(FwdSmem<128>::kBytes <= kSmemMax, "forward at 128 overflows");

// grid (H x query tiles of 128, B) in block_order, 384 threads: warpgroup
// 0 loads, 1 and 2 each own 64 query rows. Up to D = 128 each consumer warpgroup
// pipelines its tiles, and the two take turns to issue their products
// (named barriers 1 and 2): in round t a warpgroup, in its turn, issues S_t
// = Q K_t^T and O += P_{t-1} V_{t-1}, hands the turn over, then runs the
// softmax of S_t while O's product is in flight and the other warpgroup's
// products run; O is rescaled once O += P_{t-1} V_{t-1} has landed. At
// 256 two S tiles beside O would not fit the registers: one tile at a time
// (S, softmax, O += P V, each waited for).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, Problem p) {
  using L = FwdSmem<D>;
  constexpr int NC = D / kChunkCols;
  constexpr int kFwdKeys = Tiles<D>::kFwdKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + L::kQ;
  // barriers: q_full, full[kStages], empty[kStages]
  const uint32_t bar0 = sQ + L::kBars;
  const uint32_t q_full = bar0;
  constexpr int kRing = L::kRing;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + kRing + s); };

  const int nq = gridDim.x / p.H, b = blockIdx.y;
  int h, qt;
  block_order(blockIdx.x, nq, p.hg, &h, &qt);
  const int q0 = (nq - 1 - qt) * kBlockRows;  // heavy first
  const int kvh = h / (p.H / p.KV);
  int k_begin, k_end;
  key_range(p, q0, kBlockRows, kFwdKeys, &k_begin, &k_end);
  const int n_tiles = tiles_between(k_begin, k_end, kFwdKeys);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kRing; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      load_tile<kBlockRows, D, kBlockRows>(sQ, &tq, q_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kRing;
        if (t >= kRing) mbar_wait(empty(s), (t / kRing - 1) & 1);
        mbar_expect_tx(full(s), L::kStage);
        const uint32_t dst = sKV + s * L::kStage;
        const int k0 = k_begin + t * kFwdKeys;
        load_tile<kFwdKeys, D, kFwdKeys>(dst, &tk, full(s), kvh, k0, b);
        load_tile<kFwdKeys, D, kFwdKeys>(dst + L::kKV, &tv, full(s), kvh, k0,
                                         b);
      }
    }
  } else if constexpr (!Tiles<D>::kDsPath) {
    // ---- consumers, D <= 128: pipelined, in turns ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int r = frag_row(tid);
    const int qa = p.q_offset + q0 + kBox * cw;  // position of local row 0
    const int qpos0 = qa + r, qpos1 = qpos0 + 8;
    const float scale2 = p.scale * kLog2e;  // logits in base-2 units
    const uint32_t sQw = sQ + cw * kBox * 32;
    // turns: warpgroup cw waits at barrier 1 + cw and hands over at 2 -
    // cw; a hand-over nobody waits for goes to barrier 3, which warpgroup
    // 0's 128 threads complete alone (selects, not branches: ptxas keeps
    // the products of a path it cannot prove uniform in order)
    const int other = cw == 0 ? 2 : 1, spare = cw == 0 ? 3 : 1;
    const int spare_n = cw == 0 ? 128 : 128 * kConsumers;
    constexpr int kTurn = 128 * kConsumers;

    float acc_o[D / 2], acc_s[kFwdKeys / 2];
    uint32_t pa[kFwdKeys / 16][4];
    zero(acc_o);
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;
    float a0, a1;
    // S = Q K_t^T of tile t into acc_s
    auto issue_s = [&](int t) {
      mbar_wait(full(t % kRing), (t / kRing) & 1);
      const uint32_t sK = sKV + (t % kRing) * L::kStage;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kFwdKeys>(acc_s, desc_k(sQw + j * kBlockRows * 32),
                           desc_k(sK + j * kFwdKeys * 32), j);
      wgmma_commit();
    };
    // O += P V_t from pa
    auto issue_pv = [&](int t) {
      const uint32_t sV = sKV + (t % kRing) * L::kStage + L::kKV;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs<D>(acc_o, pa[kk], desc_mn(sV + kk * 16 * 32, kFwdKeys), 1);
      wgmma_commit();
    };
    // mask and softmax of tile t's S (landed)
    auto softmax_s = [&](int t) {
      const int k0 = k_begin + t * kFwdKeys;
      if (!all_visible(p, qa, k0, kFwdKeys)) {
#pragma unroll
        for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + frag_col(tid, i) + e;
            if (!visible(p, qpos0, kpos)) acc_s[4 * i + e] = -CUDART_INF_F;
            if (!visible(p, qpos1, kpos))
              acc_s[4 * i + 2 + e] = -CUDART_INF_F;
          }
      }
      softmax_tile<kFwdKeys>(acc_s, scale2, m0, m1, l0, l1, a0, a1);
    };
    auto release = [&](int t) {
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty(t % kRing));
    };

    named_arrive(spare, spare_n);  // warpgroup 0 takes the first turn
    mbar_wait(q_full, 0);
    // tile 0: S alone
    named_sync(1 + cw, kTurn);
    issue_s(0);
    named_arrive(other, kTurn);
    fence_regs(acc_s);
    wgmma_wait<0>();
    fence_regs(acc_s);
    softmax_s(0);
    to_a_operand<kFwdKeys>(acc_s, pa);
    // tiles 1 ..: S of this tile and O of the last in flight together
    for (int t = 1; t < n_tiles; ++t) {
      named_sync(1 + cw, kTurn);
      issue_s(t);
      issue_pv(t - 1);
      named_arrive(other, kTurn);
      fence_regs(acc_s);
      fence_regs(acc_o);
      wgmma_wait<1>();
      fence_regs(acc_s);
      softmax_s(t);
      wgmma_wait<0>();
      fence_regs(acc_o);
      release(t - 1);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc_o[4 * i] *= a0;
        acc_o[4 * i + 1] *= a0;
        acc_o[4 * i + 2] *= a1;
        acc_o[4 * i + 3] *= a1;
      }
      to_a_operand<kFwdKeys>(acc_s, pa);
    }
    // the last tile's O
    named_sync(1 + cw, kTurn);
    issue_pv(n_tiles - 1);
    named_arrive(cw == 0 ? other : 3, cw == 0 ? kTurn : 128);
    fence_regs(acc_o);
    wgmma_wait<0>();
    fence_regs(acc_o);
    release(n_tiles - 1);
    store_out<D>(acc_o, o, lse, tid, p, b, h, q0 + kBox * cw + r, m0, m1, l0,
                 l1);
  } else {
    // ---- consumers, D = 256: a tile at a time ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int r = frag_row(tid);
    const int qa = p.q_offset + q0 + kBox * cw;  // position of local row 0
    const int qpos0 = qa + r, qpos1 = qpos0 + 8;
    const float scale2 = p.scale * kLog2e;  // logits in base-2 units
    const uint32_t sQw = sQ + cw * kBox * 32;

    float acc_o[D / 2];
    zero(acc_o);
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kRing;
      const int k0 = k_begin + t * kFwdKeys;
      const uint32_t sK = sKV + s * L::kStage, sV = sK + L::kKV;
      mbar_wait(full(s), (t / kRing) & 1);

      float acc_s[kFwdKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kFwdKeys>(acc_s, desc_k(sQw + j * kBlockRows * 32),
                           desc_k(sK + j * kFwdKeys * 32), j);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);

      if (!all_visible(p, qa, k0, kFwdKeys)) {
#pragma unroll
        for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = k0 + frag_col(tid, i) + e;
            if (!visible(p, qpos0, kpos)) acc_s[4 * i + e] = -CUDART_INF_F;
            if (!visible(p, qpos1, kpos))
              acc_s[4 * i + 2 + e] = -CUDART_INF_F;
          }
      }
      float a0, a1;
      softmax_tile<kFwdKeys>(acc_s, scale2, m0, m1, l0, l1, a0, a1);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc_o[4 * i] *= a0;
        acc_o[4 * i + 1] *= a0;
        acc_o[4 * i + 2] *= a1;
        acc_o[4 * i + 3] *= a1;
      }
      uint32_t pa[kFwdKeys / 16][4];
      to_a_operand<kFwdKeys>(acc_s, pa);

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKeys / 16; ++kk)
        wgmma_rs<D>(acc_o, pa[kk], desc_mn(sV + kk * 16 * 32, kFwdKeys), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_o);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty(s));
    }
    store_out<D>(acc_o, o, lse, tid, p, b, h, q0 + kBox * cw + r, m0, m1, l0,
                 l1);
  }
}

template <int D>
struct ShortSmem {
  static constexpr int kTile = kBox * D * 2;  // 64 rows of Q, K or V
  static constexpr int kItem = 3 * kTile;     // a warpgroup's Q, K and V
  static constexpr int kBars = kConsumers * kItem;
  static constexpr int kBytes = kBars + 8 * kConsumers + 1024;
};

// Sq <= 64 and Sk <= 64: grid (ceil(B H / 2)), 256 threads; warpgroup w
// takes item 2 * blockIdx.x + w, the (batch, head) pair b = item / H, h =
// item % H, whole: its thread 0 loads 64 rows of Q, K and V, then the
// warpgroup computes S, the softmax and O in one pass.
template <int D>
__global__ void __launch_bounds__(128 * kConsumers, D <= 80 ? 2 : 1)
flash_fwd_short_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse,
                       Problem p) {
  using L = ShortSmem<D>;
  constexpr int NC = D / kChunkCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const int cw = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const uint32_t sQ = smem_u32(smem) + cw * L::kItem;
  const uint32_t sK = sQ + L::kTile, sV = sK + L::kTile;
  const uint32_t bar = smem_u32(smem) + L::kBars + 8 * cw;
  const long long item = (long long)blockIdx.x * kConsumers + cw;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (item >= (long long)p.B * p.H) return;
  const int b = (int)(item / p.H), h = (int)(item % p.H);
  if (tid == 0) {
    mbar_expect_tx(bar, L::kItem);
    const int kvh = h / (p.H / p.KV);
    load_tile<kBox, D>(sQ, &tq, bar, h, 0, b);
    load_tile<kBox, D>(sK, &tk, bar, kvh, 0, b);
    load_tile<kBox, D>(sV, &tv, bar, kvh, 0, b);
  }
  const int r = frag_row(tid);
  const int qpos0 = p.q_offset + r, qpos1 = qpos0 + 8;
  mbar_wait(bar, 0);

  float acc_s[kBox / 2];
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NC; ++j)
    wgmma_ss<kBox>(acc_s, desc_k(sQ + j * kBox * 32),
                   desc_k(sK + j * kBox * 32), j);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc_s);
#pragma unroll
  for (int i = 0; i < kBox / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kpos = frag_col(tid, i) + e;
      if (!visible(p, qpos0, kpos)) acc_s[4 * i + e] = -CUDART_INF_F;
      if (!visible(p, qpos1, kpos)) acc_s[4 * i + 2 + e] = -CUDART_INF_F;
    }
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;
  float a0, a1;
  softmax_tile<kBox>(acc_s, p.scale * kLog2e, m0, m1, l0, l1, a0, a1);
  uint32_t pa[kBox / 16][4];
  to_a_operand<kBox>(acc_s, pa);

  float acc_o[D / 2];
  zero(acc_o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBox / 16; ++kk)
    wgmma_rs<D>(acc_o, pa[kk], desc_mn(sV + kk * 16 * 32, kBox), 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc_o);
  store_out<D>(acc_o, o, lse, tid, p, b, h, r, m0, m1, l0, l1);
}

// ------------------------------------------------------------------------
// backward, step 1: delta = rowsum(dO * O) (bound by bytes: it reads o and
// dO once)
// ------------------------------------------------------------------------

// A row of D bf16 is D/8 16-byte chunks, and a block of 256 threads takes
// the chunks of 256 / (D/8) consecutive rows of [B, Sq, H], one a thread,
// so a warp's loads are 512 contiguous bytes; each thread leaves the dot
// product of its 8 pairs in shared memory and one thread a row adds its
// row's D/8 partial sums in order.
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const bf16* __restrict__ o,
                       const bf16* __restrict__ dout,
                       float* __restrict__ delta, Problem p) {
  constexpr int C = D / 8;      // chunks a row
  constexpr int R = 256 / C;    // rows a block
  __shared__ float part[R * C];
  const long long rows = (long long)p.B * p.Sq * p.H;
  const long long row0 = (long long)blockIdx.x * R;
  const int t = threadIdx.x;
  if (t < R * C) {
    const long long row = row0 + t / C;
    float acc = 0.0f;
    if (row < rows) {
      const uint4 a = reinterpret_cast<const uint4*>(o + row * D)[t % C];
      const uint4 g = reinterpret_cast<const uint4*>(dout + row * D)[t % C];
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(a2[e]);
        const float2 y = __bfloat1622float2(g2[e]);
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
      }
    }
    part[t] = acc;
  }
  __syncthreads();
  const long long row = row0 + t;
  if (t < R && row < rows) {
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) sum += part[t * C + c];
    // row indexes [B, Sq, H]; delta is [B, H, Sq]
    const long long h = row % p.H;
    const long long s = (row / p.H) % p.Sq;
    const long long b = row / ((long long)p.H * p.Sq);
    delta[(b * p.H + h) * p.Sq + s] = sum;
  }
}

// ------------------------------------------------------------------------
// backward, step 2: dk, dv per (key block, kv head, batch, split)
// ------------------------------------------------------------------------

template <int D>
struct DkdvSmem {
  static constexpr int kKV = Tiles<D>::kDkdvKeys * D * 2;  // one K or V tile
  static constexpr int kRows = kBwdTile * D * 2;  // one Q or dO tile
  // at D = 256: P^T and dS^T of a tile in bf16, exchanged between the
  // consumer warpgroups
  static constexpr int kX =
      Tiles<D>::kDsPath ? 2 * Tiles<D>::kDkdvKeys * kBwdTile * 2 : 0;
  // Q, dO, then lse (base 2) and delta, 64 floats each, in a 1 KB slot
  static constexpr int kStage = 2 * kRows + 1024;
  static constexpr int kBars = 2 * kKV + kX + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};
static_assert(DkdvSmem<256>::kBytes <= kSmemMax, "dk/dv at 256 overflows");

// dK and dV of one block of keys, stored: bf16 dk (times the softmax
// scale) and dv where the grid does not split, else the unscaled float32
// partial sums of split `split` (part[0][split], part[1][split]).
template <int N, int D>
__device__ __forceinline__ void store_dkdv(const float (&acc_dk)[N / 2],
                                           const float (&acc_dv)[N / 2],
                                           bf16* dk, bf16* dv, float* part,
                                           int nsplit, int split, int tid,
                                           const Problem& p, int b, int kvh,
                                           int row, int col0) {
  if (nsplit > 1) {
    const long long plane = (long long)p.B * p.Sk * p.KV * D;
    store_frag<N, D>(acc_dk, part + split * plane, tid, b, row, p.Sk, p.KV,
                     kvh, col0, 1.0f, 1.0f);
    store_frag<N, D>(acc_dv, part + (nsplit + split) * plane, tid, b, row,
                     p.Sk, p.KV, kvh, col0, 1.0f, 1.0f);
  } else {
    store_frag<N, D>(acc_dk, dk, tid, b, row, p.Sk, p.KV, kvh, col0, p.scale,
                     p.scale);
    store_frag<N, D>(acc_dv, dv, tid, b, row, p.Sk, p.KV, kvh, col0, 1.0f,
                     1.0f);
  }
}

// grid (KV x key blocks of Tiles<D>::kDkdvKeys x nsplit, B), 384 threads;
// blockIdx.x = (key block * nsplit + split) * KV + kv head, key block 0
// (the heaviest under a causal mask) first. The block loops over units [u0, u1) of its key
// block's (query head, query tile) list, flash.dkdv_plan's runs. Warpgroup
// 0 loads (its first warp also stages lse and delta). Up to D = 128,
// warpgroups 1 and 2 each own 64 keys; at 256 both take the block's 64
// keys, each 32 query columns of S^T and dP^T and 128 columns of dK and dV
// (the header), and dk/dv writes dS^T to `ds` ([B, H, Sk, ld] bf16).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, float* __restrict__ part,
                      bf16* __restrict__ ds, int nsplit, int ld, Problem p) {
  using L = DkdvSmem<D>;
  constexpr int NC = D / kChunkCols;
  constexpr int kKeys = Tiles<D>::kDkdvKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + L::kKV;
  const uint32_t sX = sK + 2 * L::kKV;
  const uint32_t sStage = sX + L::kX;
  float* stage_vec =
      reinterpret_cast<float*>(smem + 2 * L::kKV + L::kX + 2 * L::kRows);
  const uint32_t bar0 = sK + L::kBars;
  const uint32_t kv_full = bar0;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + kStages + s); };

  const int b = blockIdx.y;
  // z = key block * nsplit + split, kv heads fastest
  const int kvh = blockIdx.x % p.KV, z = blockIdx.x / p.KV;
  const int split = z % nsplit;
  const int k0 = (z / nsplit) * kKeys;
  const int rep = p.H / p.KV;
  int q_begin, q_end;
  query_range(p, k0, kKeys, kBwdTile, &q_begin, &q_end);
  const int n_q = tiles_between(q_begin, q_end, kBwdTile);
  const int units = rep * n_q;
  const int u0 = nsplit == 1 ? 0 : (int)((long long)units * split / nsplit);
  const int n_items =
      nsplit == 1 ? units
                  : (int)((long long)units * (split + 1) / nsplit) - u0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKV);
        load_tile<kKeys, D>(sK, &tk, kv_full, kvh, k0, b);
        load_tile<kKeys, D>(sV, &tv, kv_full, kvh, k0, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % kStages;
        const int u = u0 + it;
        const int h = kvh * rep + u / n_q;
        const int qr0 = q_begin + (u % n_q) * kBwdTile;
        if (it >= kStages) mbar_wait(empty(s), (it / kStages - 1) & 1);
        float* vec = stage_vec + s * (L::kStage / 4);
        const float* lrow = lse + ((long long)b * p.H + h) * p.Sq;
        const float* drow = delta + ((long long)b * p.H + h) * p.Sq;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = lane + 32 * e, q = qr0 + i;
          vec[i] = q < p.Sq ? lrow[q] * kLog2e : CUDART_INF_F;
          vec[kBwdTile + i] = q < p.Sq ? drow[q] : 0.0f;
        }
        if (lane == 0) {
          mbar_expect_tx(full(s), 2 * L::kRows);
          const uint32_t dst = sStage + s * L::kStage;
          load_tile<kBwdTile, D>(dst, &tq, full(s), h, qr0, b);
          load_tile<kBwdTile, D>(dst + L::kRows, &tdo, full(s), h, qr0, b);
        } else {
          mbar_arrive(full(s));
        }
      }
    }
  } else if constexpr (Tiles<D>::kDsPath) {
    // ---- consumers at D = 256: warpgroup cw computes query columns [32
    // cw, 32 cw + 32) of S^T, P^T, dP^T and dS^T of the tile's 64 x 64,
    // then head-dim columns [128 cw, 128 cw + 128) of dV += P^T dO and
    // dK += dS^T Q from the whole P^T and dS^T in shared memory ----
    constexpr int kCols = kBwdTile / kConsumers;  // query columns, 32
    constexpr int kHalf = D / kConsumers;         // head-dim columns, 128
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int r = frag_row(tid);
    const int kr0 = k0 + r, kr1 = kr0 + 8;
    const float scale2 = p.scale * kLog2e;
    const uint32_t sP = sX, sdS = sX + kKeys * kBwdTile * 2;
    // this warpgroup's rows of Q and dO as S^T's B operand (K-major), and
    // its head-dim chunks of them as the MN-major B of dK and dV
    const uint32_t q_rows = cw * kCols * 32;
    const uint32_t d_cols = cw * (kHalf / kChunkCols) * kBwdTile * 32;

    float acc_dv[kHalf / 2], acc_dk[kHalf / 2];
    zero(acc_dv);
    zero(acc_dk);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % kStages;
      const int u = u0 + it;
      const int h = kvh * rep + u / n_q;
      const int qr0 = q_begin + (u % n_q) * kBwdTile;
      const uint32_t sQ = sStage + s * L::kStage, sdO = sQ + L::kRows;
      const float* vec = stage_vec + s * (L::kStage / 4);
      mbar_wait(full(s), (it / kStages) & 1);

      float st[kCols / 2], dpt[kCols / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kCols>(st, desc_k(sK + j * kKeys * 32),
                        desc_k(sQ + j * kBwdTile * 32 + q_rows), j);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kCols>(dpt, desc_k(sV + j * kKeys * 32),
                        desc_k(sdO + j * kBwdTile * 32 + q_rows), j);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T = exp2(S^T * scale2 - lse2[query]); rows are keys, columns
      // queries
      const int c0 = cw * kCols;  // this warpgroup's first tile column
      const bool masked =
          qr0 + kBwdTile > p.Sq ||
          !all_visible(p, p.q_offset + qr0, k0, kBox);
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + frag_col(tid, i) + e;
          const float l2 = vec[c];
          float p0 = fast_exp2(fmaf(st[4 * i + e], scale2, -l2));
          float p1 = fast_exp2(fmaf(st[4 * i + 2 + e], scale2, -l2));
          if (masked) {
            const int qpos = p.q_offset + qr0 + c;
            const bool in = qr0 + c < p.Sq;
            if (!in || !visible(p, qpos, kr0)) p0 = 0.0f;
            if (!in || !visible(p, qpos, kr1)) p1 = 0.0f;
          }
          st[4 * i + e] = p0;
          st[4 * i + 2 + e] = p1;
        }
      wgmma_wait<0>();
      fence_regs(dpt);
      // dS^T = P^T * (dP^T - delta[query])
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = vec[kBwdTile + c0 + frag_col(tid, i) + e];
          dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - dl);
          dpt[4 * i + 2 + e] = st[4 * i + 2 + e] * (dpt[4 * i + 2 + e] - dl);
        }
      // both warpgroups are done with the last tile's P^T and dS^T (each
      // waited for its products before it came here)
      named_sync(1, 128 * kConsumers);
      bf16* ds_rows = ds + ((long long)b * p.H + h) * p.Sk * ld + qr0;
#pragma unroll
      for (int i = 0; i < kCols / 8; ++i)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = r + 8 * hf, c = c0 + frag_col(tid, i);
          const uint32_t off = swizzled(kKeys, row, c);
          const uint32_t pv = pack_bf16(st[4 * i + 2 * hf],
                                        st[4 * i + 2 * hf + 1]);
          const uint32_t dsv = pack_bf16(dpt[4 * i + 2 * hf],
                                         dpt[4 * i + 2 * hf + 1]);
          st_shared_u32(sP + off, pv);
          st_shared_u32(sdS + off, dsv);
          if (k0 + row < p.Sk)
            *reinterpret_cast<uint32_t*>(ds_rows + (long long)(k0 + row) *
                                                       ld + c) = dsv;
        }
      fence_proxy_async();
      named_sync(2, 128 * kConsumers);
      // dV += P^T dO, dK += dS^T Q on this warpgroup's head-dim columns
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_ss<kHalf, 0, 1>(acc_dv, desc_k(sP + kk * kKeys * 32),
                              desc_mn(sdO + d_cols + kk * 16 * 32, kBwdTile),
                              1);
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_ss<kHalf, 0, 1>(acc_dk, desc_k(sdS + kk * kKeys * 32),
                              desc_mn(sQ + d_cols + kk * 16 * 32, kBwdTile),
                              1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty(s));
    }
    store_dkdv<kHalf, D>(acc_dk, acc_dv, dk, dv, part, nsplit, split, tid, p,
                         b, kvh, kr0, cw * kHalf);
  } else {
    // ---- consumers: S^T, P^T, dP^T, dS^T for 64 keys x 64 queries ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int kw0 = k0 + kBox * cw;  // this warpgroup's first key
    const int kr0 = kw0 + frag_row(tid), kr1 = kr0 + 8;
    const float scale2 = p.scale * kLog2e;
    const uint32_t sKw = sK + cw * kBox * 32, sVw = sV + cw * kBox * 32;

    float acc_dk[D / 2], acc_dv[D / 2];
    zero(acc_dk);
    zero(acc_dv);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_items; ++it) {
      const int s = it % kStages;
      const int qr0 = q_begin + ((u0 + it) % n_q) * kBwdTile;
      const uint32_t sQ = sStage + s * L::kStage, sdO = sQ + L::kRows;
      const float* vec = stage_vec + s * (L::kStage / 4);
      mbar_wait(full(s), (it / kStages) & 1);

      float st[kBwdTile / 2], dpt[kBwdTile / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kBwdTile>(st, desc_k(sKw + j * kKeys * 32),
                           desc_k(sQ + j * kBwdTile * 32), j);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kBwdTile>(dpt, desc_k(sVw + j * kKeys * 32),
                           desc_k(sdO + j * kBwdTile * 32), j);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(st);

      // P^T = exp2(S^T * scale2 - lse2[query]); rows are keys, columns
      // queries
      const bool masked =
          qr0 + kBwdTile > p.Sq ||
          !all_visible(p, p.q_offset + qr0, kw0, kBox);
#pragma unroll
      for (int i = 0; i < kBwdTile / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = frag_col(tid, i) + e;
          const float l2 = vec[c];
          float p0 = fast_exp2(fmaf(st[4 * i + e], scale2, -l2));
          float p1 = fast_exp2(fmaf(st[4 * i + 2 + e], scale2, -l2));
          if (masked) {
            const int qpos = p.q_offset + qr0 + c;
            const bool in = qr0 + c < p.Sq;
            if (!in || !visible(p, qpos, kr0)) p0 = 0.0f;
            if (!in || !visible(p, qpos, kr1)) p1 = 0.0f;
          }
          st[4 * i + e] = p0;
          st[4 * i + 2 + e] = p1;
        }
      uint32_t pa[kBwdTile / 16][4];
      to_a_operand<kBwdTile>(st, pa);
      // dV += P^T dO
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_rs<D>(acc_dv, pa[kk], desc_mn(sdO + kk * 16 * 32, kBwdTile), 1);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(dpt);
      // dS^T = P^T * (dP^T - delta[query])
#pragma unroll
      for (int i = 0; i < kBwdTile / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float dl = vec[kBwdTile + frag_col(tid, i) + e];
          dpt[4 * i + e] = st[4 * i + e] * (dpt[4 * i + e] - dl);
          dpt[4 * i + 2 + e] = st[4 * i + 2 + e] * (dpt[4 * i + 2 + e] - dl);
        }
      uint32_t da[kBwdTile / 16][4];
      to_a_operand<kBwdTile>(dpt, da);
      // dK += dS^T Q
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdTile / 16; ++kk)
        wgmma_rs<D>(acc_dk, da[kk], desc_mn(sQ + kk * 16 * 32, kBwdTile), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty(s));
    }
    store_dkdv<D, D>(acc_dk, acc_dv, dk, dv, part, nsplit, split, tid, p, b,
                     kvh, kr0, 0);
  }
}

// dk = bf16(sum_s fma(part[0][s], scale, .)), dv = bf16(sum_s part[1][s]),
// s = 0, 1, ..., nsplit - 1 in that order: n floats of each, 4 a thread.
template <int D>
__global__ void flash_bwd_dkdv_sum_kernel(const float* __restrict__ part,
                                          bf16* __restrict__ dk,
                                          bf16* __restrict__ dv, long long n,
                                          int nsplit, float scale) {
  const long long e = 4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (e >= n) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int s = 0; s < nsplit; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * n + e);
    const float4 y =
        *reinterpret_cast<const float4*>(part + (nsplit + s) * n + e);
    a.x = fmaf(x.x, scale, a.x); a.y = fmaf(x.y, scale, a.y);
    a.z = fmaf(x.z, scale, a.z); a.w = fmaf(x.w, scale, a.w);
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  *reinterpret_cast<uint2*>(dk + e) =
      make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  *reinterpret_cast<uint2*>(dv + e) =
      make_uint2(pack_bf16(c.x, c.y), pack_bf16(c.z, c.w));
}

// ------------------------------------------------------------------------
// backward, step 3: dq per (128 query rows, head, batch)
// ------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kQ = kBlockRows * D * 2;   // one Q or dO tile
  static constexpr int kKV = Tiles<D>::kDqKeys * D * 2;  // one K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBars = 2 * kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// grid (H x query tiles of 128, B) in block_order, 384 threads: warpgroup
// 0 loads, 1 and 2 each own 64 query rows and recompute S and dP (head dims up to 128).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    Problem p) {
  using L = DqSmem<D>;
  constexpr int NC = D / kChunkCols;
  constexpr int kDqKeys = Tiles<D>::kDqKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + L::kQ;
  const uint32_t sStage = sQ + 2 * L::kQ;
  const uint32_t bar0 = sQ + L::kBars;
  const uint32_t qd_full = bar0;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + kStages + s); };

  const int nq = gridDim.x / p.H, b = blockIdx.y;
  int h, qt;
  block_order(blockIdx.x, nq, p.hg, &h, &qt);
  const int q0 = (nq - 1 - qt) * kBlockRows;  // heavy first
  const int kvh = h / (p.H / p.KV);
  int k_begin, k_end;
  key_range(p, q0, kBlockRows, kDqKeys, &k_begin, &k_end);
  const int n_tiles = tiles_between(k_begin, k_end, kDqKeys);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(qd_full, 2 * L::kQ);
      load_tile<kBlockRows, D>(sQ, &tq, qd_full, h, q0, b);
      load_tile<kBlockRows, D>(sdO, &tdo, qd_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), (t / kStages - 1) & 1);
        mbar_expect_tx(full(s), L::kStage);
        const uint32_t dst = sStage + s * L::kStage;
        const int kt0 = k_begin + t * kDqKeys;
        load_tile<kDqKeys, D>(dst, &tk, full(s), kvh, kt0, b);
        load_tile<kDqKeys, D>(dst + L::kKV, &tv, full(s), kvh, kt0, b);
      }
    }
  } else {
    // ---- consumers: S, P, dP, dS for 64 rows x 128 keys ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int row0 = q0 + kBox * cw + frag_row(tid);  // and row0 + 8
    const int qa = p.q_offset + q0 + kBox * cw;
    const int qpos0 = p.q_offset + row0, qpos1 = qpos0 + 8;
    const float scale2 = p.scale * kLog2e;
    const uint32_t sQw = sQ + cw * kBox * 32, sdOw = sdO + cw * kBox * 32;
    const float* lrow = lse + ((long long)b * p.H + h) * p.Sq;
    const float* drow = delta + ((long long)b * p.H + h) * p.Sq;
    // rows past Sq: P = 0
    const float lse0 = row0 < p.Sq ? lrow[row0] * kLog2e : CUDART_INF_F;
    const float lse1 = row0 + 8 < p.Sq ? lrow[row0 + 8] * kLog2e
                                       : CUDART_INF_F;
    const float dl0 = row0 < p.Sq ? drow[row0] : 0.0f;
    const float dl1 = row0 + 8 < p.Sq ? drow[row0 + 8] : 0.0f;

    float acc_dq[D / 2];
    zero(acc_dq);
    mbar_wait(qd_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int kt0 = k_begin + t * kDqKeys;
      const uint32_t sKs = sStage + s * L::kStage, sVs = sKs + L::kKV;
      mbar_wait(full(s), (t / kStages) & 1);

      float sc[kDqKeys / 2], dp[kDqKeys / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kDqKeys>(sc, desc_k(sQw + j * kBlockRows * 32),
                           desc_k(sKs + j * kDqKeys * 32), j);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kDqKeys>(dp, desc_k(sdOw + j * kBlockRows * 32),
                           desc_k(sVs + j * kDqKeys * 32), j);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sc);
      const bool masked = !all_visible(p, qa, kt0, kDqKeys);
#pragma unroll
      for (int i = 0; i < kDqKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kt0 + frag_col(tid, i) + e;
          float p0 = fast_exp2(fmaf(sc[4 * i + e], scale2, -lse0));
          float p1 = fast_exp2(fmaf(sc[4 * i + 2 + e], scale2, -lse1));
          if (masked) {
            if (!visible(p, qpos0, kpos)) p0 = 0.0f;
            if (!visible(p, qpos1, kpos)) p1 = 0.0f;
          }
          sc[4 * i + e] = p0;
          sc[4 * i + 2 + e] = p1;
        }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P * (dP - delta[row])
#pragma unroll
      for (int i = 0; i < kDqKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * i + e] = sc[4 * i + e] * (dp[4 * i + e] - dl0);
          dp[4 * i + 2 + e] = sc[4 * i + 2 + e] * (dp[4 * i + 2 + e] - dl1);
        }
      uint32_t da[kDqKeys / 16][4];
      to_a_operand<kDqKeys>(dp, da);
      // dQ += dS K
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDqKeys / 16; ++kk)
        wgmma_rs<D>(acc_dq, da[kk], desc_mn(sKs + kk * 16 * 32, kDqKeys), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dq);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty(s));
    }
    store_frag<D, D>(acc_dq, dq, tid, b, row0, p.Sq, p.H, h, 0, p.scale,
                     p.scale);
  }
}

template <int D>
struct DqDsSmem {
  static constexpr int kK = Tiles<D>::kDqKeys * D * 2;  // K: keys x D
  // dS^T: keys x the block's 128 query columns
  static constexpr int kS = Tiles<D>::kDqKeys * kBlockRows * 2;
  static constexpr int kStage = kK + kS;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kBytes = kBars + 8 * 2 * kStages + 1024;
};
static_assert(DqDsSmem<256>::kBytes <= kSmemMax, "dq at 256 overflows");

// dQ of 128 query rows of one head from the dS^T dk/dv wrote (kDsPath):
// grid (H x query tiles of 128, B) in block_order, 384 threads; warpgroup
// 0 streams stages of K and dS^T (tds: the map of [B, H, Sk, ld] as (ld,
// Sk, H, B), boxes of {16 queries, 64 keys}); warpgroups 1 and 2 each own
// 64 rows: dQ += dS K with dS the MN-major A operand as the boxes land.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_ds_kernel(const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tds,
                       bf16* __restrict__ dq, Problem p) {
  using L = DqDsSmem<D>;
  constexpr int kKeys = Tiles<D>::kDqKeys;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sStage = smem_u32(smem);
  const uint32_t bar0 = sStage + L::kBars;
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };

  const int nq = gridDim.x / p.H, b = blockIdx.y;
  int h, qt;
  block_order(blockIdx.x, nq, p.hg, &h, &qt);
  const int q0 = (nq - 1 - qt) * kBlockRows;  // heavy first
  const int kvh = h / (p.H / p.KV);
  int k_begin, k_end;
  key_range(p, q0, kBlockRows, kKeys, &k_begin, &k_end);
  const int n_tiles = tiles_between(k_begin, k_end, kKeys);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), (t / kStages - 1) & 1);
        mbar_expect_tx(full(s), L::kStage);
        const uint32_t dst = sStage + s * L::kStage;
        const int kt0 = k_begin + t * kKeys;
        load_tile<kKeys, D>(dst, &tk, full(s), kvh, kt0, b);
#pragma unroll
        for (int j = 0; j < kBlockRows / kChunkCols; ++j)
#pragma unroll
          for (int hf = 0; hf < kKeys / kBox; ++hf)
            tma_load(dst + L::kK + j * kKeys * 32 + hf * kBox * 32, &tds,
                     full(s), q0 + j * kChunkCols, kt0 + hf * kBox, h, b);
      }
    }
  } else {
    // ---- consumers: dQ += dS K for 64 rows x 128 keys ----
    setmaxnreg_inc<240>();
    const int cw = threadIdx.x / 128 - 1;
    const int tid = threadIdx.x % 128;
    const int row0 = q0 + kBox * cw + frag_row(tid);  // and row0 + 8
    const int qa = p.q_offset + q0 + kBox * cw;
    // this warpgroup's 64 query columns of a dS^T stage: 4 chunks
    const uint32_t s_cols = cw * (kBox / kChunkCols) * kKeys * 32;

    float acc_dq[D / 2];
    zero(acc_dq);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      const int kt0 = k_begin + t * kKeys;
      const uint32_t sKs = sStage + s * L::kStage, sS = sKs + L::kK;
      mbar_wait(full(s), (t / kStages) & 1);
      if (!all_visible(p, qa, kt0, kKeys)) {
        // zero the pairs that cannot see each other: dk/dv wrote zeros
        // for those of the tiles it visited and nothing for the others
        const int c = tid % kBox, qpos = qa + c;
        for (int key = tid / kBox; key < kKeys; key += 128 / kBox)
          if (!visible(p, qpos, kt0 + key))
            st_shared_u16(sS + swizzled(kKeys, key, kBox * cw + c), 0);
        fence_proxy_async();
        named_sync(1 + cw, 128);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_ss<D, 1, 1>(acc_dq, desc_mn(sS + s_cols + kk * 16 * 32, kKeys),
                          desc_mn(sKs + kk * 16 * 32, kKeys), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dq);
      __syncwarp();
      if (tid % 32 == 0) mbar_arrive(empty(s));
    }
    store_frag<D, D>(acc_dq, dq, tid, b, row0, p.Sq, p.H, h, 0, p.scale,
                     p.scale);
  }
}

// ------------------------------------------------------------------------
// host: tensor maps and launchers
// ------------------------------------------------------------------------

// cuTensorMapEncodeTiled's signature (cuda.h), reached through
// cudaGetDriverEntryPoint so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// cuTensorMapEncodeTiled works in the calling thread's current context.
// A thread the runtime has not used yet (PyTorch's autograd thread, when
// the caching allocator served all its tensors) has none: bind the current
// device's primary context, as cudaSetDevice does.
void bind_context() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) cudaSetDevice(dev);
}

// A bf16 tensor whose dims, innermost first, are (d0, d1, d2, d3) as a 4-D
// map with a box of {16, box1, box2, 1} in the 32-byte swizzle; elements
// past a dim read as zeros.
bool make_map4(CUtensorMap* map, const void* ptr, cuuint64_t d0,
               cuuint64_t d1, cuuint64_t d2, cuuint64_t d3, cuuint32_t box1,
               cuuint32_t box2) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  const cuuint64_t dims[4] = {d0, d1, d2, d3};
  const cuuint64_t strides[3] = {d0 * 2, d0 * d1 * 2, d0 * d1 * d2 * 2};
  const cuuint32_t box[4] = {kChunkCols, box1, box2, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A [B, S, heads, D] bf16 tensor as the map (D, heads, S, B) with a box of
// {16, 1, box_rows, 1}: rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D, int box_rows = kBox) {
  return make_map4(map, ptr, D, heads, S, B, 1, box_rows);
}

// scale > 0: the softmax scale of the caller's head dim (a head dim padded
// to D with zero lanes keeps its own 1/sqrt); else 1/sqrt(D).
Problem make_problem(int B, int Sq, int Sk, int H, int KV, int D, int causal,
                     int window, int q_offset, float scale) {
  Problem p;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale > 0.0f ? scale : 1.0f / sqrtf((float)D);
  p.hg = H;
  return p;
}

// The forward and dq grids run the blocks of a group of query heads
// together, so that the K and V they stream stay in the L2 while they run:
// every head where the K and V of all kv heads (of a batch entry) fit in
// half the L2 (the order of one group: heads fastest, the heaviest query
// tiles first), else the kv heads of the largest divisor of KV whose
// share fits (one at least). At zamba2's [1, 4096, 32, 112] (59 MB of K
// and V) 8 heads a group: a forward 6% faster on an H100. dk/dv keeps
// every kv head in one group: grouped, the vlm's GQA grid lost its
// heaviest-first order and ran 27% slower.
Problem grouped(Problem p, int D) {
  static std::atomic<int> l2_of[64];  // each device's L2 bytes, read once
  const long long bytes = 4LL * p.Sk * D;  // K and V of a kv head
  int dev = 0, g = p.KV;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < 64) {
    int l2 = l2_of[dev].load(std::memory_order_relaxed);
    if (l2 == 0 && cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize,
                                          dev) == cudaSuccess)
      l2_of[dev].store(l2, std::memory_order_relaxed);
    while (l2 > 0 && g > 1 && (p.KV % g || g * bytes > l2 / 2)) --g;
  }
  p.hg = p.H / p.KV * g;
  return p;
}

bool problem_ok(const Problem& p) {
  return p.B >= 1 && p.B <= 65535 && p.Sq >= 1 && p.Sk >= 1 && p.KV >= 1 &&
         p.H >= p.KV && p.H % p.KV == 0 && p.H <= 65535 &&
         (p.Sq + kBlockRows - 1) / kBlockRows <= 65535 &&
         (p.Sk + kBox - 1) / kBox <= 65535;
}

// The dynamic shared memory a kernel takes, set once per device (a call to
// cudaFuncSetAttribute costs host time on every launch otherwise).
template <auto kKernel>
cudaError_t allow_smem(int bytes) {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Problem& p, cudaStream_t s) {
  bind_context();
  // boxes as tall as the tiles: 64 rows of everything on the short path,
  // else a 128-row Q tile and K and V stages of Tiles<D>::kFwdKeys
  const bool short_path = p.Sq <= kBox && p.Sk <= kBox;
  const int q_box = short_path ? kBox : kBlockRows;
  const int kv_box = short_path ? kBox : Tiles<D>::kFwdKeys;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, p.B, p.Sq, p.H, D, q_box) ||
      !make_map(&tk, k, p.B, p.Sk, p.KV, D, kv_box) ||
      !make_map(&tv, v, p.B, p.Sk, p.KV, D, kv_box))
    return cudaErrorInvalidValue;
  bf16* of = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  if (short_path) {
    // one (batch, head) item a consumer warpgroup
    const int smem = ShortSmem<D>::kBytes;
    cudaError_t err = allow_smem<flash_fwd_short_kernel<D>>(smem);
    if (err != cudaSuccess) return err;
    const long long items = (long long)p.B * p.H;
    flash_fwd_short_kernel<D>
        <<<(unsigned)((items + kConsumers - 1) / kConsumers),
           128 * kConsumers, smem, s>>>(tq, tk, tv, of, lf, p);
    return cudaGetLastError();
  }
  const int smem = FwdSmem<D>::kBytes;
  cudaError_t err = allow_smem<flash_fwd_kernel<D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(p.H * ((p.Sq + kBlockRows - 1) / kBlockRows)),
                  (unsigned)p.B);
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(tq, tk, tv, of, lf,
                                                   grouped(p, D));
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, void* part, int nsplit, const Problem& p,
                cudaStream_t s) {
  using T = Tiles<D>;
  constexpr int kKeys = T::kDkdvKeys;
  const long long nkb = (p.Sk + kKeys - 1) / kKeys;
  if (nsplit < 1 || nkb * nsplit > 65535 ||
      ((nsplit > 1 || T::kDsPath) &&
       (part == nullptr || reinterpret_cast<uintptr_t>(part) % 16 != 0)))
    return cudaErrorInvalidValue;
  bind_context();
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, p.B, p.Sq, p.H, D) ||
      !make_map(&tk, k, p.B, p.Sk, p.KV, D) ||
      !make_map(&tv, v, p.B, p.Sk, p.KV, D) ||
      !make_map(&tdo, dout, p.B, p.Sq, p.H, D))
    return cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.Sq * p.H;
  constexpr int kDeltaRows = 256 / (D / 8);  // rows a delta block
  flash_bwd_delta_kernel<D>
      <<<(unsigned)((rows + kDeltaRows - 1) / kDeltaRows), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  bf16* dk_b = static_cast<bf16*>(dk);
  bf16* dv_b = static_cast<bf16*>(dv);
  // part: the split's partial sums (float32 [2, nsplit, B, Sk, KV, D])
  // where nsplit > 1, then at kDsPath dS^T (bf16 [B, H, Sk, ld])
  const long long plane = (long long)p.B * p.Sk * p.KV * D;
  float* part_f = static_cast<float*>(part);
  bf16* ds = T::kDsPath
                 ? reinterpret_cast<bf16*>(part_f + (nsplit > 1 ? 2 * nsplit
                                                                      * plane
                                                                : 0))
                 : nullptr;
  const int ld = (p.Sq + kDqDsRows - 1) / kDqDsRows * kDqDsRows;
  const Problem pg = grouped(p, D);
  err = allow_smem<flash_bwd_dkdv_kernel<D>>(DkdvSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)(p.KV * nkb * nsplit), (unsigned)p.B);
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, DkdvSmem<D>::kBytes, s>>>(
      tq, tk, tv, tdo, lse_f, delta_f, dk_b, dv_b, part_f, ds, nsplit, ld, pg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (nsplit > 1) {
    flash_bwd_dkdv_sum_kernel<D><<<(unsigned)((plane / 4 + 255) / 256), 256,
                                   0, s>>>(part_f, dk_b, dv_b, plane, nsplit,
                                           p.scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid_q((unsigned)(p.H * ((p.Sq + kBlockRows - 1) / kBlockRows)),
                    (unsigned)p.B);
  // each head dim builds the one dq kernel it takes
  if constexpr (T::kDsPath) {
    CUtensorMap tds;
    if (!make_map4(&tds, ds, ld, p.Sk, p.H, p.B, kBox, 1))
      return cudaErrorInvalidValue;
    err = allow_smem<flash_bwd_dq_ds_kernel<D>>(DqDsSmem<D>::kBytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_ds_kernel<D><<<grid_q, kThreads, DqDsSmem<D>::kBytes, s>>>(
        tk, tds, static_cast<bf16*>(dq), pg);
  } else {
    err = allow_smem<flash_bwd_dq_kernel<D>>(DqSmem<D>::kBytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<D><<<grid_q, kThreads, DqSmem<D>::kBytes, s>>>(
        tq, tk, tv, tdo, lse_f, delta_f, static_cast<bf16*>(dq), pg);
  }
  return cudaGetLastError();
}

}  // namespace

// All tensors bf16 except lse/delta (float32 [B, H, Sq]), each 16-byte
// aligned. window <= 0: no sliding window. D in {64, 80, 112, 128, 256}.
// scale <= 0: the softmax scale 1/sqrt(D). Returns the launches'
// cudaError_t (cudaErrorInvalidValue for a shape or pointer the kernels do
// not take).
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Sk, int H, int KV,
                         int D, int causal, int window, int q_offset,
                         float scale, void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset, scale);
  if (!problem_ok(p)) return (int)cudaErrorInvalidValue;
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

// delta: float32 scratch [B, H, Sq] the caller allocates. nsplit: the
// dk/dv blocks' split (flash.dkdv_plan). part: scratch the caller
// allocates (flash.bwd_scratch bytes): with nsplit > 1 the float32 partial
// sums [2, nsplit, B, Sk, KV, D], then at D = 256 dS^T in bf16 [B, H, Sk,
// Sq rounded up to 128]; may be null where it needs neither.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv,
                         void* part, int nsplit, int B, int Sq, int Sk, int H,
                         int KV, int D, int causal, int window, int q_offset,
                         float scale, void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset, scale);
  if (!problem_ok(p)) return (int)cudaErrorInvalidValue;
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
