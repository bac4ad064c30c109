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
//     of [R][16] bf16 (32-byte rows) in the 32-byte swizzle. Every head dim
//     (64, 80, 128) is a whole number of chunks, so D = 80 needs no padding:
//     a k16 step of a K-major operand is one chunk, and an MN-major operand
//     spans the chunks at a fixed stride (the descriptor's leading offset).
//   * TMA. q, k, v and dO are 4-D tensor maps (D, heads, S, B) with a box
//     of {16, 1, 64, 1}; one thread issues the boxes of a tile, the
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
//   * Backward: a delta = rowsum(dO * O) pass (a thread a row, 16-byte
//     loads), then dk/dv per 128 keys of a kv head (64 per consumer
//     warpgroup; tiles of 64 query rows of Q and dO, with their lse and
//     delta, stream through the ring, summed over the H/KV query heads),
//     then dq per 128 query rows (tiles of 128 keys of K and V stream
//     through the ring). S^T and dP^T (S and dP) are issued together, and
//     the softmax of one overlaps the other's product. Every sum stays in
//     one thread block, in a fixed order: no atomics, deterministic runs.
// P and dS are rounded to bf16 before they feed a product, as the
// reference's probs.astype(q.dtype) does. The softmax scale is the true
// 1/sqrt(D) (the TPU wrapper's padding of D to 128 lanes is not carried
// over).

#include <cuda.h>  // CUtensorMap and its enums; the entry point is looked up
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBox = 64;          // rows of a TMA box and of a warpgroup's tile
constexpr int kChunkCols = 16;    // bf16 columns of a swizzle chunk (k16)
constexpr int kConsumers = 2;     // consumer warpgroups per block
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlockRows = kBox * kConsumers;  // rows (or keys) per block
constexpr int kStages = 2;
constexpr int kFwdKeys = 128;     // keys per forward tile
constexpr int kBwdTile = 64;      // query rows per streamed dk/dv tile
constexpr int kDqKeys = 128;      // keys per streamed dq tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Problem {
  int B, Sq, Sk, H, KV, causal, window, q_offset;
  float scale;  // 1/sqrt(D)
};

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
// [q0, q0 + rows) can see. Mirrored by kernels/flash_attention/flash.py:
// key_tiles, which the CPU tests hold against the visible pairs.
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
// see some key of [k0, k0 + keys). Mirrored by flash.py:query_tiles.
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
// as R/64 boxes of [64][16].
template <int R, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int head, int row0,
                                          int b) {
#pragma unroll
  for (int j = 0; j < D / kChunkCols; ++j)
#pragma unroll
    for (int hf = 0; hf < R / kBox; ++hf)
      tma_load(dst + j * R * 32 + hf * kBox * 32, map, bar, j * kChunkCols,
               head, row0 + hf * kBox, b);
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

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory.
template <int N>
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
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float (&d)[40],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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

// Write rows `row` and `row + 8` of a 64 x D accumulator, times `mul`, as
// bf16 into a [B, S, heads, D] tensor.
template <int D>
__device__ __forceinline__ void store_frag(const float (&acc)[D / 2],
                                           bf16* dst, int tid, int b, int row,
                                           int S, int heads, int head,
                                           float mul0, float mul1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int s = row + 8 * half;
    if (s >= S) continue;
    const float mul = half ? mul1 : mul0;
    bf16* out = dst + (((long long)b * S + s) * heads + head) * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(out + frag_col(tid, i)) =
          __floats2bfloat162_rn(acc[4 * i + 2 * half] * mul,
                                acc[4 * i + 2 * half + 1] * mul);
  }
}

// Aligns the dynamic shared memory to 1024 bytes (the swizzle and TMA want
// at least 256).
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// ------------------------------------------------------------------------
// forward: o, lse
// ------------------------------------------------------------------------

template <int D>
struct FwdSmem {
  static constexpr int kQ = kBlockRows * D * 2;   // Q tile, 128 rows
  static constexpr int kKV = kFwdKeys * D * 2;    // one K or V tile
  static constexpr int kStage = 2 * kKV;          // K then V
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// grid (H, B, query tiles of 128), 384 threads: warpgroup 0 loads, 1 and
// 2 each own 64 query rows.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                 float* __restrict__ lse, Problem p) {
  using L = FwdSmem<D>;
  constexpr int NC = D / kChunkCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sKV = sQ + L::kQ;
  // barriers: q_full, full[kStages], empty[kStages]
  const uint32_t bar0 = sQ + L::kBars;
  const uint32_t q_full = bar0;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // heavy first
  const int kvh = h / (p.H / p.KV);
  int k_begin, k_end;
  key_range(p, q0, kBlockRows, kFwdKeys, &k_begin, &k_end);
  const int n_tiles = tiles_between(k_begin, k_end, kFwdKeys);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumers * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      load_tile<kBlockRows, D>(sQ, &tq, q_full, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty(s), (t / kStages - 1) & 1);
        mbar_expect_tx(full(s), L::kStage);
        const uint32_t dst = sKV + s * L::kStage;
        const int k0 = k_begin + t * kFwdKeys;
        load_tile<kFwdKeys, D>(dst, &tk, full(s), kvh, k0, b);
        load_tile<kFwdKeys, D>(dst + L::kKV, &tv, full(s), kvh, k0, b);
      }
    }
  } else {
    // ---- consumers ----
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
      const int s = t % kStages;
      const int k0 = k_begin + t * kFwdKeys;
      const uint32_t sK = sKV + s * L::kStage, sV = sK + L::kKV;
      mbar_wait(full(s), (t / kStages) & 1);

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
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 8; ++i) {
        mx0 = fmaxf(mx0, fmaxf(acc_s[4 * i], acc_s[4 * i + 1]));
        mx1 = fmaxf(mx1, fmaxf(acc_s[4 * i + 2], acc_s[4 * i + 3]));
      }
      const float n0 = fmaxf(m0, quad_max(mx0) * scale2);
      const float n1 = fmaxf(m1, quad_max(mx1) * scale2);
      const float u0 = n0 == -CUDART_INF_F ? 0.0f : n0;
      const float u1 = n1 == -CUDART_INF_F ? 0.0f : n1;
      const float a0 = fast_exp2(m0 - u0), a1 = fast_exp2(m1 - u1);
      m0 = n0;
      m1 = n1;
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int i = 0; i < kFwdKeys / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc_s[4 * i + e] = fast_exp2(fmaf(acc_s[4 * i + e], scale2, -u0));
          acc_s[4 * i + 2 + e] =
              fast_exp2(fmaf(acc_s[4 * i + 2 + e], scale2, -u1));
          sum0 += acc_s[4 * i + e];
          sum1 += acc_s[4 * i + 2 + e];
        }
      l0 = l0 * a0 + sum0;  // this thread's share; summed over the quad last
      l1 = l1 * a1 + sum1;
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

    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const int row = q0 + kBox * cw + r;
    store_frag<D>(acc_o, o, tid, b, row, p.Sq, p.H, h, 1.0f / l0, 1.0f / l1);
    if (tid % 4 == 0) {
      float* out = lse + ((long long)b * p.H + h) * p.Sq;
      if (row < p.Sq) out[row] = (m0 + log2f(l0)) * kLn2;
      if (row + 8 < p.Sq) out[row + 8] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

// ------------------------------------------------------------------------
// backward, step 1: delta = rowsum(dO * O), one thread per row (bound by
// bytes: it reads o and dO once)
// ------------------------------------------------------------------------

template <int D>
__global__ void flash_bwd_delta_kernel(const bf16* __restrict__ o,
                                       const bf16* __restrict__ dout,
                                       float* __restrict__ delta, Problem p) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long rows = (long long)p.B * p.Sq * p.H;
  if (row >= rows) return;
  // row indexes [B, Sq, H]; one thread reads its row as 16-byte vectors
  const uint4* op = reinterpret_cast<const uint4*>(o + row * D);
  const uint4* dp = reinterpret_cast<const uint4*>(dout + row * D);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 a = op[c], g = dp[c];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(g2[e]);
      acc = fmaf(x.x, y.x, acc);
      acc = fmaf(x.y, y.y, acc);
    }
  }
  const long long h = row % p.H;
  const long long s = (row / p.H) % p.Sq;
  const long long b = row / ((long long)p.H * p.Sq);
  delta[(b * p.H + h) * p.Sq + s] = acc;
}

// ------------------------------------------------------------------------
// backward, step 2: dk, dv per (128 keys, kv head, batch)
// ------------------------------------------------------------------------

template <int D>
struct DkdvSmem {
  static constexpr int kKV = kBlockRows * D * 2;  // one K or V tile
  static constexpr int kRows = kBwdTile * D * 2;  // one Q or dO tile
  // Q, dO, then lse (base 2) and delta, 64 floats each, in a 1 KB slot
  static constexpr int kStage = 2 * kRows + 1024;
  static constexpr int kBars = 2 * kKV + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// grid (KV, B, key tiles of 128), 384 threads: warpgroup 0 loads (its first
// warp also stages lse and delta), 1 and 2 each own 64 keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, Problem p) {
  using L = DkdvSmem<D>;
  constexpr int NC = D / kChunkCols;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + L::kKV;
  const uint32_t sStage = sK + 2 * L::kKV;
  float* stage_vec = reinterpret_cast<float*>(smem + 2 * L::kKV + 2 * L::kRows);
  const uint32_t bar0 = sK + L::kBars;
  const uint32_t kv_full = bar0;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + kStages + s); };

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBlockRows;
  const int rep = p.H / p.KV;
  int q_begin, q_end;
  query_range(p, k0, kBlockRows, kBwdTile, &q_begin, &q_end);
  const int n_q = tiles_between(q_begin, q_end, kBwdTile);
  const int n_items = rep * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer ----
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kKV);
        load_tile<kBlockRows, D>(sK, &tk, kv_full, kvh, k0, b);
        load_tile<kBlockRows, D>(sV, &tv, kv_full, kvh, k0, b);
      }
      for (int it = 0; it < n_items; ++it) {
        const int s = it % kStages;
        const int h = kvh * rep + it / n_q;
        const int qr0 = q_begin + (it % n_q) * kBwdTile;
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
      const int qr0 = q_begin + (it % n_q) * kBwdTile;
      const uint32_t sQ = sStage + s * L::kStage, sdO = sQ + L::kRows;
      const float* vec = stage_vec + s * (L::kStage / 4);
      mbar_wait(full(s), (it / kStages) & 1);

      float st[kBwdTile / 2], dpt[kBwdTile / 2];
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kBwdTile>(st, desc_k(sKw + j * kBlockRows * 32),
                           desc_k(sQ + j * kBwdTile * 32), j);
      wgmma_commit();
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_ss<kBwdTile>(dpt, desc_k(sVw + j * kBlockRows * 32),
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
    store_frag<D>(acc_dk, dk, tid, b, kr0, p.Sk, p.KV, kvh, p.scale, p.scale);
    store_frag<D>(acc_dv, dv, tid, b, kr0, p.Sk, p.KV, kvh, 1.0f, 1.0f);
  }
}

// ------------------------------------------------------------------------
// backward, step 3: dq per (128 query rows, head, batch)
// ------------------------------------------------------------------------

template <int D>
struct DqSmem {
  static constexpr int kQ = kBlockRows * D * 2;   // one Q or dO tile
  static constexpr int kKV = kDqKeys * D * 2;    // one K or V tile
  static constexpr int kStage = 2 * kKV;
  static constexpr int kBars = 2 * kQ + kStages * kStage;
  static constexpr int kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// grid (H, B, query tiles of 128), 384 threads: warpgroup 0 loads, 1 and
// 2 each own 64 query rows.
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
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem), sdO = sQ + L::kQ;
  const uint32_t sStage = sQ + 2 * L::kQ;
  const uint32_t bar0 = sQ + L::kBars;
  const uint32_t qd_full = bar0;
  auto full = [&](int s) { return bar0 + 8 * (1 + s); };
  auto empty = [&](int s) { return bar0 + 8 * (1 + kStages + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockRows;  // heavy first
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
    // ---- consumers: S, P, dP, dS for 64 rows x 64 keys ----
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
    store_frag<D>(acc_dq, dq, tid, b, row0, p.Sq, p.H, h, p.scale, p.scale);
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

// A [B, S, heads, D] bf16 tensor as the 4-D map (D, heads, S, B) with a box
// of {16, 1, 64, 1} in the 32-byte swizzle; rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {kChunkCols, 1, kBox, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// scale > 0: the softmax scale of the caller's head dim (a head dim padded
// to D with zero lanes keeps its own 1/sqrt); else 1/sqrt(D).
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
         (p.Sq + kBlockRows - 1) / kBlockRows <= 65535 &&
         (p.Sk + kBlockRows - 1) / kBlockRows <= 65535;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                void* lse, const Problem& p, cudaStream_t s) {
  bind_context();
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, p.B, p.Sq, p.H, D) ||
      !make_map(&tk, k, p.B, p.Sk, p.KV, D) ||
      !make_map(&tv, v, p.B, p.Sk, p.KV, D))
    return cudaErrorInvalidValue;
  const int smem = FwdSmem<D>::kBytes;
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)p.H, (unsigned)p.B,
                  (unsigned)((p.Sq + kBlockRows - 1) / kBlockRows));
  flash_fwd_kernel<D><<<grid, kThreads, smem, s>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), p);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* delta, void* dq,
                void* dk, void* dv, const Problem& p, cudaStream_t s) {
  bind_context();
  CUtensorMap tq, tk, tv, tdo;
  if (!make_map(&tq, q, p.B, p.Sq, p.H, D) ||
      !make_map(&tk, k, p.B, p.Sk, p.KV, D) ||
      !make_map(&tv, v, p.B, p.Sk, p.KV, D) ||
      !make_map(&tdo, dout, p.B, p.Sq, p.H, D))
    return cudaErrorInvalidValue;
  const long long rows = (long long)p.B * p.Sq * p.H;
  flash_bwd_delta_kernel<D><<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<float*>(delta), p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float* lse_f = static_cast<const float*>(lse);
  const float* delta_f = static_cast<const float*>(delta);
  err = allow_smem(flash_bwd_dkdv_kernel<D>, DkdvSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_kv((unsigned)p.KV, (unsigned)p.B,
                     (unsigned)((p.Sk + kBlockRows - 1) / kBlockRows));
  flash_bwd_dkdv_kernel<D><<<grid_kv, kThreads, DkdvSmem<D>::kBytes, s>>>(
      tq, tk, tv, tdo, lse_f, delta_f, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_kernel<D>, DqSmem<D>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid_q((unsigned)p.H, (unsigned)p.B,
                    (unsigned)((p.Sq + kBlockRows - 1) / kBlockRows));
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, DqSmem<D>::kBytes, s>>>(
      tq, tk, tv, tdo, lse_f, delta_f, static_cast<bf16*>(dq), p);
  return cudaGetLastError();
}

}  // namespace

// All tensors bf16 except lse/delta (float32 [B, H, Sq]), each 16-byte
// aligned. window <= 0: no sliding window. D in {64, 80, 128}. scale <= 0:
// the softmax scale 1/sqrt(D). Returns the launches' cudaError_t
// (cudaErrorInvalidValue for a shape or pointer the kernels do not take).
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
    case 128: return (int)fwd<128>(q, k, v, o, lse, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// delta: float32 scratch [B, H, Sq] the caller allocates.
extern "C" int flash_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const void* lse,
                         void* delta, void* dq, void* dk, void* dv, int B,
                         int Sq, int Sk, int H, int KV, int D, int causal,
                         int window, int q_offset, float scale,
                         void* stream) {
  const Problem p = make_problem(B, Sq, Sk, H, KV, D, causal, window,
                                 q_offset, scale);
  if (!problem_ok(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    case 80: return (int)bwd<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    case 128: return (int)bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
