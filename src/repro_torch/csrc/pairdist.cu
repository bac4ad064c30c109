// Pairwise squared distances over the worker axis: x [B, n, d] -> [B, n, n].
//
// Replaces the TPU kernel repro/kernels/pairdist/pairdist.py:pairdist_kernel
// (launched by pairdist_pallas_batched). It feeds NNM's neighbour ranking and
// Krum's scores.
//
// Bound: device memory at large d. The function reads B*n*d values once; the
// Gram matrix costs n(n+1)/2 multiply-adds per coordinate, well below the
// card's float32 rate for those bytes. At the CNN's [1, 13, 11958] the bytes
// take 0.2 us, so what is left is latency: one launch, one pass over the row,
// one reduction. The TPU kernel walks d sequentially, carrying the Gram block
// from one grid step to the next; Hopper's blocks run in parallel, so here:
//   * One launch, grid (groups * C, B) in thread block clusters of C CTAs
//     (at most 16: non-portable sizes are allowed once per device). CTA k of
//     a batch row owns tiles_per_cta consecutive 256-column tiles of d.
//   * Loads: a 3-stage ring of [n_pad, 256] tiles in shared memory, filled
//     by cp.async (16, 8 or 4 bytes, the widest the row's address and d
//     allow), so the next two tiles' loads fly while the current tile's FMAs
//     run. TMA is no use here: a tensor map needs 16-byte row strides, and a
//     float32 row of 11,958 values is 47,832 bytes. Rows past n are zero.
//   * FMAs: each thread owns one 4x4 block of (i, j) pairs of the upper
//     triangle and a stride of the tile's column pairs (two columns per
//     8-byte shared-memory read), accumulating in float32 FMA. No TF32 and
//     no tensor cores: TF32 misses the 1e-5 parity bar. This loop, not the
//     copies, held the first version back, so for n <= 20 a whole warp
//     takes one block pair: its lanes read neighbouring column pairs
//     without bank conflicts, it issues only the FMAs of rows below n (a
//     diagonal block: its upper triangle, its rows read once), and a fixed
//     shuffle butterfly sums the lanes; the warps or phases are then summed
//     in order. Tiles of 256 columns halve the barriers per byte.
//   * After cluster.sync(), rank 0 reads the other ranks' partials through
//     distributed shared memory (map_shared_rank) and adds them in rank
//     order.
//   * One cluster per row (the CNN's shape): rank 0 finalises
//     max(G_ii + G_jj - 2 G_ij, 0) at once: no scratch, no second pass.
//   * groups > 1 clusters per row (d = 1,048,576): each rank 0 writes its
//     cluster's sum to scratch [B, groups, n_pad, n_pad], fences, and takes
//     a ticket (atomicAdd on the row's int counter). The last cluster of the
//     row sums the groups' partials in group order, finalises, and sets the
//     counter back to 0, so every call leaves the counters at zero.
// Inputs are float32, bfloat16, float16 or float8_e4m3fn (dtype codes 0-3,
// those of randk.cu), widened to float32 as the TPU kernel widens them; the
// output is float32. The narrow classes (pairdist_narrow_kernel) have a
// design of their own. A first port staged them in the float32 kernel's
// 256-column tiles (a 16-bit tile cost the float32 one's barriers and ring
// turns for half its bytes), widened every column pair once per block pair
// it fed, and took plain loads where a row's start is no multiple of 4
// bytes (float8 with d = 11,958: 2.1x the float32 time). And a redesign
// that staged 1 KB tiles and widened each value once into a float32 work
// tile for the same FMAs ran 1.3-1.6x slower than that port at d =
// 1,048,576 (H100 80GB HBM3, 700 W): the n(n+1)/2 FMAs a column do not
// shrink with the bytes, and the conversion pass added to them. So there:
//   * a staged row holds 1 KB at 16 bits (512 columns), 512 B at float8
//     (512 columns: 1,024 left 2 CTAs an SM and ran 16-31% slower) and
//     where n_pad > 32 (shared memory stays under 227 KB), copied by
//     16-byte cp.async in the aligned chunks that cover it whatever its
//     alignment: a row's bytes sit at its start's offset from 16 in the
//     stage (the row stride's 16 bytes of padding hold the extra chunk), and
//     the bytes past the row's end are zero-filled (src-size);
//   * a conversion pass moves each staged value once into a 16-bit work
//     tile, shifted back by that offset (word reads and funnel shifts, 8
//     columns a thread at a time), float8 widened exactly to half, zero
//     past the tile's valid columns and on the rows past n;
//   * the tensor cores take the Gram blocks: 16-bit products are exact in
//     float32, so mma.sync m16n8k16 (float16 or bfloat16 operands, float32
//     results) replaces the FMAs, each 16-product sum added to a float32
//     accumulator rounded to nearest (mma16816). One ldmatrix.x4 of a
//     16-row group's 16 columns is both the A fragment and, as two n8
//     halves, the B fragments of X X^T; each warp sums every (gi <= gj)
//     16 x 16 block of its 16-column steps, and the warps' blocks are
//     summed in warp order;
//   * two barriers and one ring turn a tile, 256 threads a CTA.
// The narrow classes' order of summation is not the float32 class's (its
// kernel, tile and plan are as before).
// Calls that overlap on two streams of one device must not share the
// counters and scratch (the wrapper keeps one set per device).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

// The launch plan, built once per (B, n, d, dtype, device) by the wrapper
// (repro_torch/kernels/pairdist/pairdist.py: pairdist_plan, PlanStruct).
struct PairdistPlan {
  long long d;
  void* scratch;      // float32 [B, groups, n_pad, n_pad]; groups > 1 only
  void* counters;     // int32 [B] tickets, zero between calls
  int B;
  int n;
  int dtype;          // 0 = float32, 1 = bfloat16, 2 = float16, 3 = float8
  int phases;         // threads = n_block_pairs * phases
  int cluster;        // CTAs per cluster, 1..16
  int groups;         // clusters per batch row
  int tiles_per_cta;  // tiles per CTA
  int smem;           // dynamic shared memory bytes
  int tile;           // columns a tile: 256 at float32, else 1,024 or 512
                      // bytes of columns (narrow_tile_bytes)
};

namespace {

constexpr int kMaxN = 64;
constexpr int kTile = 256;
constexpr int kStages = 3;
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

// Row stride of a staged tile, in elements: 16 bytes of padding keep every
// row 16-byte aligned for cp.async and put rows on other banks.
template <typename T>
__host__ __device__ constexpr int row_stride() {
  return kTile + 16 / static_cast<int>(sizeof(T));
}

__host__ __device__ constexpr int n_pad_of(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ constexpr int block_pairs(int n) {
  return (n_pad_of(n) / 4) * (n_pad_of(n) / 4 + 1) / 2;
}

// Bytes of the work area (the ring, later the phase sums, later the Gram
// matrix), rounded to 16; the CTA's partial [block_pairs * 16] follows it.
__host__ __device__ constexpr int work_bytes(int n, int phases, int esize) {
  const int np = n_pad_of(n);
  const int ring = kStages * np * (kTile + 16 / esize) * esize;
  const int red = phases * block_pairs(n) * 16 * 4;
  const int gram = np * np * 4;
  const int m = ring > red ? (ring > gram ? ring : gram)
                           : (red > gram ? red : gram);
  return (m + 15) / 16 * 16;
}

__host__ __device__ constexpr int smem_bytes(int n, int phases, int esize) {
  return work_bytes(n, phases, esize) + block_pairs(n) * 16 * 4;
}

// The narrow classes: a staged row of TB bytes (1,024 at 16 bits, 512 at
// float8 and where n_pad > 32; the wrapper's plan,
// repro_torch/kernels/pairdist/pairdist.py: narrow_tile_bytes) plus 16 for
// the chunk a misaligned row spills into; the 16-bit work tile holds the
// staged tile's TB / itemsize columns a row plus 16 bytes that put
// ldmatrix's eight rows on other banks, for 16 * ceil(n / 16) rows.
constexpr int kNarrowThreads = 256;
__host__ __device__ constexpr int narrow_row_bytes(int tb) { return tb + 16; }
__host__ __device__ constexpr int work_row_bytes(int tb, int esize) {
  return 2 * (tb / esize) + 16;
}
__host__ __device__ constexpr int narrow_rows(int n) {
  return (n + 15) / 16 * 16;
}

// The narrow classes' work area (the ring and the work tile, later the
// warps' Gram blocks, later the Gram matrix), rounded to 16; the CTA's
// partial follows it.
__host__ __device__ constexpr int narrow_work_bytes(int n, int tb,
                                                    int esize) {
  const int np = narrow_rows(n);
  const int tiles = kStages * np * narrow_row_bytes(tb) +
                    np * work_row_bytes(tb, esize);
  const int red = kNarrowThreads / 32 * np * np * 4;
  const int gram = n_pad_of(n) * n_pad_of(n) * 4;
  const int m = tiles > red ? (tiles > gram ? tiles : gram)
                            : (red > gram ? red : gram);
  return (m + 15) / 16 * 16;
}

__host__ __device__ constexpr int narrow_smem_bytes(int n, int tb,
                                                    int esize) {
  return narrow_work_bytes(n, tb, esize) + block_pairs(n) * 16 * 4;
}

// Dynamic shared memory the narrow kernels are allowed (every plan of
// narrow_smem_bytes at n <= 64 stays under it).
constexpr int kNarrowSmemMax = 200 * 1024;

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

// Entry e of a CTA's partial (block pair e / 16, element e % 16) -> (i, j).
__device__ __forceinline__ void entry_ij(int e, int nb, int* i, int* j) {
  int pi, pj;
  block_pair(e / 16, nb, &pi, &pj);
  *i = pi * 4 + (e % 16) / 4;
  *j = pj * 4 + e % 4;
}

// float8_e4m3fn values, moved as their bits
struct E4M3 {
  unsigned char x;
};

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// Bytes of an element of dtype code `dtype`.
__host__ __device__ constexpr int esize_of(int dtype) {
  return dtype == 0 ? 4 : (dtype == 3 ? 1 : 2);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// 16 bytes from src to dst, of which only the first src_bytes are read;
// the rest of dst is zero-filled.
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage columns [col0, col0 + valid) of rows [0, n) into `stage` (the
// float32 kernel). VB is the copy width in bytes (16, 8 or 4, by cp.async).
// An odd `valid` gets a zero in column `valid`: the FMAs read column pairs.
template <typename T, int VB>
__device__ __forceinline__ void load_tile(T* stage, const T* xb, int n,
                                          long long d, long long col0,
                                          int valid, int tid, int threads) {
  constexpr int S = row_stride<T>();
  constexpr int V = VB / static_cast<int>(sizeof(T));
  constexpr int kCopies = kTile / V;  // copies per row
  const int copies = valid / V;       // d % V == 0: no copy is cut
  for (int e = tid; e < n * kCopies; e += threads) {
    const int r = e / kCopies;
    const int c = e % kCopies;
    if (c < copies)
      cp_async<VB>(stage + r * S + c * V,
                   xb + (long long)r * d + col0 + (long long)c * V);
  }
  if (valid & 1) {
    for (int r = tid; r < n; r += threads) stage[r * S + valid] = zero<T>();
  }
}

// The tile loop: rows n..n_pad-1 of every stage set to
// zero once, then the CTA's tiles through the ring, `compute(stage, pairs)`
// on each (pairs: the tile's column pairs, the last one padded with zero).
template <typename T, int VB, class Compute>
__device__ __forceinline__ void stream_tiles(const T* xb, int n, long long d,
                                             const PairdistPlan& p, T* ring,
                                             int tid, int threads,
                                             Compute&& compute) {
  constexpr int S = row_stride<T>();
  const int n_pad = n_pad_of(n);
  const int stage_elems = n_pad * S;
  const int pad_elems = (n_pad - n) * S;  // no copy writes the pad rows
  for (int e = tid; e < kStages * pad_elems; e += threads) {
    const int s = e / pad_elems;
    ring[s * stage_elems + n * S + (e - s * pad_elems)] = zero<T>();
  }
  const long long n_tiles = (d + kTile - 1) / kTile;
  const long long t_begin = (long long)blockIdx.x * p.tiles_per_cta;
  long long t_end = t_begin + p.tiles_per_cta;
  if (t_end > n_tiles) t_end = n_tiles;
  const int count = t_end > t_begin ? (int)(t_end - t_begin) : 0;
  auto valid = [&](int t) {
    const long long left = d - (t_begin + t) * kTile;
    return left < kTile ? (int)left : kTile;
  };
  auto issue = [&](int t) {
    if (t < count) {
      load_tile<T, VB>(ring + (t % kStages) * stage_elems, xb, n, d,
                       (t_begin + t) * kTile, valid(t), tid, threads);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int t = 0; t < count; ++t) {
    issue(t + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    compute(ring + (t % kStages) * stage_elems, (valid(t) + 1) / 2);
    __syncthreads();
  }
  cp_async_wait<0>();
}

// Sum a warp's lanes into lane 0 by a fixed butterfly.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The epilogue, from the CTA's partial `part` (entries e -> (i, j) by
// entry_ij): the cluster's sum in rank order on rank 0, the row's sum over
// its clusters in group order by the last cluster (ticket), and the
// distances.
__device__ __forceinline__ void finish(float* part, int n_entries, int nb,
                                       const PairdistPlan& p,
                                       float* __restrict__ out,
                                       unsigned char* smem, long long b,
                                       int tid, int threads) {
  __shared__ int is_last;
  const int n = p.n;
  const int n_pad = n_pad_of(n);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const bool leader = cluster.block_rank() == 0;
  if (leader) {
    const int ranks = p.cluster;
    for (int e = tid; e < n_entries; e += threads) {
      float v[kMaxCluster];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        v[r] = r < ranks ? cluster.map_shared_rank(part, r)[e] : 0.0f;
      float s = part[e];
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r)
        if (r < ranks) s += v[r];
      part[e] = s;
    }
  }
  cluster.sync();  // the other ranks' shared memory lives until read
  if (!leader) return;

  if (p.groups > 1) {
    float* scratch = static_cast<float*>(p.scratch);
    const long long g = blockIdx.x / p.cluster;
    const long long plane = (long long)n_pad * n_pad;
    float* mine = scratch + (b * p.groups + g) * plane;
    for (int e = tid; e < n_entries; e += threads) {
      int i, j;
      entry_ij(e, nb, &i, &j);
      mine[i * n_pad + j] = part[e];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* counter = static_cast<int*>(p.counters) + b;
      is_last = atomicAdd(counter, 1) == p.groups - 1;
    }
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const float* row = scratch + b * p.groups * plane;
    for (int e = tid; e < n_entries; e += threads) {
      int i, j;
      entry_ij(e, nb, &i, &j);
      const float* at = row + i * n_pad + j;
      // 64 loads in flight at a time, summed in group order
      float s = __ldcg(at);
      for (int q0 = 1; q0 < p.groups; q0 += 64) {
        float v[64];
#pragma unroll
        for (int u = 0; u < 64; ++u)
          v[u] = q0 + u < p.groups ? __ldcg(at + (q0 + u) * plane) : 0.0f;
#pragma unroll
        for (int u = 0; u < 64; ++u)
          if (q0 + u < p.groups) s += v[u];
      }
      part[e] = s;
    }
    if (tid == 0) static_cast<int*>(p.counters)[b] = 0;
  }

  // the Gram matrix in shared memory, then the distances
  float* gram = reinterpret_cast<float*>(smem);  // [n_pad][n_pad]
  __syncthreads();
  for (int e = tid; e < n_entries; e += threads) {
    int i, j;
    entry_ij(e, nb, &i, &j);
    gram[i * n_pad + j] = part[e];
  }
  __syncthreads();
  float* ob = out + b * n * n;
  for (int e = tid; e < n * n; e += threads) {
    const int i = e / n;
    const int j = e % n;
    const float gij = i <= j ? gram[i * n_pad + j] : gram[j * n_pad + i];
    ob[e] = fmaxf(gram[i * n_pad + i] + gram[j * n_pad + j] - 2.0f * gij,
                  0.0f);
  }
}

// The FMAs of one 4x4 block pair over a thread's column pairs of a tile:
// rows ra[0..3] against rows rv[0..RV-1]; a diagonal block (DIAG, ra ==
// rv) reads its rows once and takes only its upper triangle.
template <typename T, int RV, bool DIAG>
__device__ __forceinline__ void block_fma(float (&acc)[16], const T* ra,
                                          const T* rv, int ph, int pairs,
                                          int phases) {
  constexpr int S = row_stride<T>();
  constexpr int RA = DIAG ? RV : 4;
  for (int q = ph; q < pairs; q += phases) {
    float2 a[RA], v[RV];
#pragma unroll
    for (int r = 0; r < RA; ++r) a[r] = load_pair(ra + r * S + 2 * q);
#pragma unroll
    for (int c = 0; c < RV; ++c)
      v[c] = DIAG ? a[c] : load_pair(rv + c * S + 2 * q);
#pragma unroll
    for (int r = 0; r < RA; ++r) {
#pragma unroll
      for (int c = DIAG ? r : 0; c < RV; ++c) {
        acc[r * 4 + c] = fmaf(a[r].x, v[c].x, acc[r * 4 + c]);
        acc[r * 4 + c] = fmaf(a[r].y, v[c].y, acc[r * 4 + c]);
      }
    }
  }
}

// Each thread owns one 4x4 block of (i, j) pairs of the upper triangle and
// a stride of the tile's column pairs (its phase). With phases >= 32 a warp
// takes one block pair: its lanes read neighbouring column pairs (8-byte
// reads without bank conflicts), it issues only the FMAs of rows below n
// (a diagonal block: its upper triangle, its rows read once), and the lanes
// are summed by a fixed shuffle butterfly. With fewer (n > 20) the block
// pairs interleave within a warp and every thread takes the full 4x4. The
// phases are then summed in order in shared memory.
template <typename T, int VB>
__global__ void __launch_bounds__(kMaxThreads)
pairdist_kernel(const T* __restrict__ x, float* __restrict__ out,
                PairdistPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = row_stride<T>();
  const int n = p.n;
  const int nb = n_pad_of(n) / 4;
  const int nbp = block_pairs(n);
  const int n_entries = nbp * 16;
  const int phases = p.phases;
  const int threads = nbp * phases;
  const int tid = threadIdx.x;
  const int lanes = phases >= 32 ? 32 : 1;
  const int bp = (tid / lanes) % nbp;
  const int ph = tid / (lanes * nbp) * lanes + tid % lanes;
  int bi, bj;
  block_pair(bp, nb, &bi, &bj);
  const long long b = blockIdx.y;
  float* part = reinterpret_cast<float*>(
      smem + work_bytes(n, phases, static_cast<int>(sizeof(T))));

  float acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;
  // which rows of the pair hold data: a warp-uniform choice of the FMAs to
  // issue (rows past n and a diagonal block's lower half are skipped; with
  // interleaved pairs, every thread takes the full 4x4)
  const int rows_v = min(4, n - bj * 4);
  const int kind = lanes < 32 ? 3 : (bi == bj ? 3 + rows_v : rows_v - 1);
  stream_tiles<T, VB>(x + b * n * p.d, n, p.d, p, reinterpret_cast<T*>(smem),
                      tid, threads, [&](const T* st, int pairs) {
    const T* ra = st + bi * 4 * S;
    const T* rv = st + bj * 4 * S;
    switch (kind) {
      case 0: block_fma<T, 1, false>(acc, ra, rv, ph, pairs, phases); break;
      case 1: block_fma<T, 2, false>(acc, ra, rv, ph, pairs, phases); break;
      case 2: block_fma<T, 3, false>(acc, ra, rv, ph, pairs, phases); break;
      case 3: block_fma<T, 4, false>(acc, ra, rv, ph, pairs, phases); break;
      case 4: block_fma<T, 1, true>(acc, ra, rv, ph, pairs, phases); break;
      case 5: block_fma<T, 2, true>(acc, ra, rv, ph, pairs, phases); break;
      case 6: block_fma<T, 3, true>(acc, ra, rv, ph, pairs, phases); break;
      default: block_fma<T, 4, true>(acc, ra, rv, ph, pairs, phases); break;
    }
  });

  if (lanes == 32) {
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = warp_sum(acc[k]);
  }
  float* red = reinterpret_cast<float*>(smem);  // [phases / lanes][nbp][16]
  if (tid % lanes == 0) {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      red[((ph / lanes) * nbp + bp) * 16 + k] = acc[k];
  }
  __syncthreads();
  for (int e = tid; e < n_entries; e += threads) {
    float s = red[e];
    for (int q = 1; q < phases / lanes; ++q) s += red[q * n_entries + e];
    part[e] = s;
  }
  finish(part, n_entries, nb, p, out, smem, b, tid, threads);
}

// Four float8_e4m3fn values (a 32-bit word, the first in the low byte) as
// two f16x2 words (exact: every float8 value is a half).
__device__ __forceinline__ void e4m3x4_to_f16(unsigned w, unsigned& lo,
                                              unsigned& hi) {
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;"
      : "=r"(lo) : "h"((unsigned short)(w & 0xFFFFu)));
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;"
      : "=r"(hi) : "h"((unsigned short)(w >> 16)));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b for one m16n8k16 tile, 16-bit operands (BF: bfloat16, else
// float16): the tensor core sums the 16 exact products from zero (its
// accumulation truncates, so a running sum kept in it drifts: 0.52 at d =
// 4,099, 1.3e-5 of max |x|^2, on an H100), and each sum is added to c in
// float32, rounded to nearest.
template <bool BF>
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  float d[4];
  if constexpr (BF) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %10, %10, %10};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
          "f"(0.0f));
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) c[k] += d[k];
}

// pairdist_kernel for bfloat16, float16 and float8_e4m3fn (module
// comment): staged tiles of TB bytes (p.tile * sizeof(T) == TB), each
// value realigned (and float8 widened to half) once into a 16-bit work
// tile of NG groups of 16 rows, whose Gram blocks the tensor cores sum.
template <typename T, int TB, int NG>
__global__ void __launch_bounds__(kNarrowThreads)
pairdist_narrow_kernel(const T* __restrict__ x, float* __restrict__ out,
                       PairdistPlan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int ES = sizeof(T);
  constexpr bool BF = std::is_same<T, __nv_bfloat16>::value;
  constexpr int TILE = TB / ES;                  // columns a staged tile
  constexpr int RB = narrow_row_bytes(TB);       // staged row stride
  constexpr int CHUNKS = RB / 16;                // 16-byte copies a row
  constexpr int NP = 16 * NG;                    // work tile rows
  constexpr int WB = work_row_bytes(TB, ES);     // work row stride, bytes
  constexpr int UNITS = TILE / 8;                // 8-column units a row
  constexpr int PAIRS = NG * (NG + 1) / 2;       // 16 x 16 Gram blocks
  constexpr int WARPS = kNarrowThreads / 32;
  const int n = p.n;
  const int nb = n_pad_of(n) / 4;
  const int n_entries = block_pairs(n) * 16;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const long long b = blockIdx.y;
  const long long d = p.d;
  unsigned char* ring = smem;
  unsigned char* work = smem + kStages * NP * RB;
  float* part = reinterpret_cast<float*>(
      smem + narrow_work_bytes(n, TB, ES));
  const T* xb = x + b * n * d;

  float acc[PAIRS][2][4];
#pragma unroll
  for (int q = 0; q < PAIRS; ++q)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[q][h][k] = 0.0f;

  // the work tile's rows n..NP-1 are zero throughout
  for (int e = tid; e < (NP - n) * (WB / 16); e += kNarrowThreads)
    reinterpret_cast<uint4*>(work + n * WB)[e] = make_uint4(0, 0, 0, 0);
  const long long n_tiles = (d + TILE - 1) / TILE;
  const long long t_begin = (long long)blockIdx.x * p.tiles_per_cta;
  long long t_end = t_begin + p.tiles_per_cta;
  if (t_end > n_tiles) t_end = n_tiles;
  const int count = t_end > t_begin ? (int)(t_end - t_begin) : 0;
  auto valid = [&](int t) {
    const long long left = d - (t_begin + t) * TILE;
    return left < TILE ? (int)left : TILE;
  };
  // the 16-byte chunks that cover each row's bytes of tile t, zero past
  // the row's valid bytes
  auto issue = [&](int t) {
    if (t < count) {
      const long long col0 = (t_begin + t) * TILE;
      const int bytes = valid(t) * ES;
      unsigned char* st = ring + (t % kStages) * NP * RB;
      for (int e = tid; e < n * CHUNKS; e += kNarrowThreads) {
        const int r = e / CHUNKS;
        const int k = e % CHUNKS;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            xb + (long long)r * d + col0);
        const int mis = (int)(reinterpret_cast<uintptr_t>(src) & 15);
        const int have = mis + bytes - 16 * k;
        if (have > 0)
          cp_async16_zfill(st + r * RB + 16 * k, src - mis + 16 * k,
                           have < 16 ? have : 16);
      }
    }
    cp_async_commit();
  };
  // ldmatrix rows and columns of this lane: matrices (rows 0-7, 8-15) x
  // (columns 0-7, 8-15), in the m16n8k16 A fragment's order
  const int lrow = lane % 8 + 8 * ((lane / 8) % 2);
  const int lcol = 8 * (lane / 16);
  issue(0);
  issue(1);
  cp_async_wait<kStages - 2>();
  __syncthreads();
  for (int t = 0; t < count; ++t) {
    // stage (t + 2) % 3 was last read by tile t - 1's conversion
    issue(t + kStages - 1);
    const unsigned char* st = ring + (t % kStages) * NP * RB;
    const int vt = valid(t);
    // realign (float8: and widen) each value once: 8 columns a unit, zero
    // from column vt on
    for (int e = tid; e < n * UNITS; e += kNarrowThreads) {
      const int r = e / UNITS;
      const int u = e % UNITS;
      const int mis = (int)(reinterpret_cast<uintptr_t>(
                                xb + (long long)r * d) & 15);
      const int off = mis + u * 8 * ES;
      const unsigned* wp = reinterpret_cast<const unsigned*>(
          st + r * RB + (off & ~3));
      const unsigned sh = (off & 3) * 8;
      unsigned o[4];
      if constexpr (ES == 2) {
        unsigned w[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) w[k] = wp[k];
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = __funnelshift_r(w[k], w[k + 1], sh);
      } else {
        const unsigned w0 = wp[0], w1 = wp[1], w2 = wp[2];
        e4m3x4_to_f16(__funnelshift_r(w0, w1, sh), o[0], o[1]);
        e4m3x4_to_f16(__funnelshift_r(w1, w2, sh), o[2], o[3]);
      }
      const int c = u * 8;
      if (c + 8 > vt) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          o[k] &= (c + 2 * k < vt ? 0x0000FFFFu : 0u) |
                  (c + 2 * k + 1 < vt ? 0xFFFF0000u : 0u);
      }
      *reinterpret_cast<uint4*>(work + r * WB + c * 2) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
    __syncthreads();
    // each warp sums its 16-column steps of the tile: the 16 x 16 blocks
    // of G over row groups gi <= gj, A and B from the same fragments
    const int steps = (vt + 15) / 16;
    for (int kc = warp; kc < steps; kc += WARPS) {
      unsigned f[NG][4];
#pragma unroll
      for (int g = 0; g < NG; ++g)
        ldmatrix_x4(f[g], work + (16 * g + lrow) * WB + (16 * kc + lcol) * 2);
      int q = 0;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
#pragma unroll
        for (int gj = gi; gj < NG; ++gj, ++q) {
          mma16816<BF>(acc[q][0], f[gi], f[gj][0], f[gj][2]);
          mma16816<BF>(acc[q][1], f[gi], f[gj][1], f[gj][3]);
        }
      }
    }
    cp_async_wait<kStages - 2>();  // tile t + 1 landed
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps' blocks into red [WARPS][NP][NP], then summed in warp order
  float* red = reinterpret_cast<float*>(smem);
  {
    const int g = lane / 4, c2 = 2 * (lane % 4);
    int q = 0;
#pragma unroll
    for (int gi = 0; gi < NG; ++gi) {
#pragma unroll
      for (int gj = gi; gj < NG; ++gj, ++q) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* blk = red + warp * NP * NP + (16 * gi + g) * NP + 16 * gj +
                       8 * h + c2;
          blk[0] = acc[q][h][0];
          blk[1] = acc[q][h][1];
          blk[8 * NP] = acc[q][h][2];
          blk[8 * NP + 1] = acc[q][h][3];
        }
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < n_entries; e += kNarrowThreads) {
    int i, j;
    entry_ij(e, nb, &i, &j);
    float s = red[i * NP + j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) s += red[w * NP * NP + i * NP + j];
    part[e] = s;
  }
  finish(part, n_entries, nb, p, out, smem, b, tid, kNarrowThreads);
}

// One launch in clusters of p.cluster CTAs; the first launch of each kernel
// on a device allows clusters of 16 and the largest dynamic shared memory a
// plan can ask for.
template <typename T, int VB>
cudaError_t launch(const void* x, float* out, const PairdistPlan& p,
                   cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  auto kernel = pairdist_kernel<T, VB>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(kMaxN, 1, static_cast<int>(sizeof(T))));
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.groups * p.cluster), (unsigned)p.B, 1);
  cfg.blockDim = dim3((unsigned)(block_pairs(p.n) * p.phases), 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), out, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The narrow kernels: one launch in clusters, as launch() does.
template <typename T, int TB, int NG>
cudaError_t launch_narrow(const void* x, float* out, const PairdistPlan& p,
                          cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  auto kernel = pairdist_narrow_kernel<T, TB, NG>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNarrowSmemMax);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) configured[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(p.groups * p.cluster), (unsigned)p.B, 1);
  cfg.blockDim = dim3((unsigned)kNarrowThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), out, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_narrow_tb(const void* x, float* o, const PairdistPlan& p,
                             cudaStream_t s) {
  const int ng = (p.n + 15) / 16;
  if constexpr (sizeof(T) == 2) {  // float8 stages 512 B only
    if (p.tile * 2 == 1024) {
      if (ng == 1) return launch_narrow<T, 1024, 1>(x, o, p, s);
      if (ng == 2) return launch_narrow<T, 1024, 2>(x, o, p, s);
      return cudaErrorInvalidValue;
    }
  }
  switch (ng) {
    case 1: return launch_narrow<T, 512, 1>(x, o, p, s);
    case 2: return launch_narrow<T, 512, 2>(x, o, p, s);
    case 3: return launch_narrow<T, 512, 3>(x, o, p, s);
    default: return launch_narrow<T, 512, 4>(x, o, p, s);
  }
}

// The widest cp.async the float32 row addresses allow: every row start and
// every tile start (a multiple of 256 columns) must be aligned to it.
int copy_bytes(const void* x, long long d) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  for (int vb = 16; vb > 4; vb /= 2) {
    if (a % vb == 0 && (d * 4) % vb == 0) return vb;
  }
  return 4;
}

bool valid_plan(const PairdistPlan& p) {
  if (p.n < 1 || p.n > kMaxN || p.B < 1 || p.B > 65535 || p.d < 1)
    return false;
  if (p.dtype < 0 || p.dtype > 3) return false;
  if (p.dtype == 0 &&
      (p.phases < 1 || p.phases > kTile / 2 || (p.phases & (p.phases - 1)) ||
       block_pairs(p.n) * p.phases > kMaxThreads))
    return false;
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.groups < 1 ||
      p.tiles_per_cta < 1)
    return false;
  const int es = esize_of(p.dtype);
  const int tb = p.tile * es;  // bytes of a staged row
  if (p.dtype == 0 ? p.tile != kTile : tb != 512 && !(es == 2 && tb == 1024))
    return false;
  if ((long long)p.groups * p.cluster * p.tiles_per_cta * p.tile < p.d)
    return false;
  if ((long long)p.groups * p.cluster > 0x7fffffffLL) return false;
  if (p.groups > 1 && (p.scratch == nullptr || p.counters == nullptr))
    return false;
  if (p.dtype == 0) return p.smem == smem_bytes(p.n, p.phases, es);
  if (tb == 1024 && narrow_rows(p.n) > 32) return false;
  return p.smem == narrow_smem_bytes(p.n, tb, es) &&
         p.smem <= kNarrowSmemMax;
}

}  // namespace

// x: [B, n, d] (plan->dtype 0 = float32, 1 = bfloat16, 2 = float16,
// 3 = float8_e4m3fn), contiguous.
// out: float32 [B, n, n]. plan: the launch plan (see PairdistPlan), which
// holds the scratch and the zeroed ticket counters when groups > 1.
// Returns the launch's cudaError_t (0 on success); it runs on `stream`.
extern "C" int pairdist(const void* x, void* out, const void* plan,
                        void* stream) {
  if (x == nullptr || out == nullptr || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const PairdistPlan& p = *static_cast<const PairdistPlan*>(plan);
  if (!valid_plan(p)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  if (p.dtype == 0) {
    switch (copy_bytes(x, p.d)) {
      case 16: err = launch<float, 16>(x, o, p, s); break;
      case 8: err = launch<float, 8>(x, o, p, s); break;
      default: err = launch<float, 4>(x, o, p, s); break;
    }
  } else if (p.dtype == 1) {
    err = launch_narrow_tb<__nv_bfloat16>(x, o, p, s);
  } else if (p.dtype == 2) {
    err = launch_narrow_tb<__half>(x, o, p, s);
  } else {
    err = launch_narrow_tb<E4M3>(x, o, p, s);
  }
  return (int)err;
}
