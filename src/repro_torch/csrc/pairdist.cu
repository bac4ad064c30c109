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
//     float32 row of 11,958 values is 47,832 bytes. bfloat16 rows with odd d
//     are not 4-byte aligned and take plain loads. Rows past n are zero.
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
// those of randk.cu), staged in their own type and widened to float32 as a
// column pair is read, as the TPU kernel widens them; the output is float32.
// No float atomics: every sum runs in a fixed order, so the same inputs give
// the same bits whichever cluster finishes last. The squared norms are G's
// own diagonal, so the result's diagonal is exactly 0 and it is symmetric.
// Calls that overlap on two streams of one device must not share the
// counters and scratch (the wrapper keeps one set per device).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cstdint>

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
  int tiles_per_cta;  // 256-column tiles per CTA
  int smem;           // dynamic shared memory bytes
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
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
template <>
__device__ __forceinline__ __half zero<__half>() {
  return __float2half(0.0f);
}
template <>
__device__ __forceinline__ E4M3 zero<E4M3>() {
  return E4M3{0};
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ float2 load_pair(const E4M3* p) {
  const __half2 h(__nv_cvt_fp8x2_to_halfraw2(
      *reinterpret_cast<const __nv_fp8x2_storage_t*>(p), __NV_E4M3));
  return __half22float2(h);
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage columns [col0, col0 + valid) of rows [0, n) into `stage`. VB is the
// copy width in bytes (16, 8 or 4, by cp.async), or 0 for plain loads. An
// odd `valid` gets a zero in column `valid`: the FMAs read column pairs.
template <typename T, int VB>
__device__ __forceinline__ void load_tile(T* stage, const T* xb, int n,
                                          long long d, long long col0,
                                          int valid, int tid, int threads) {
  constexpr int S = row_stride<T>();
  if constexpr (VB == 0) {
    for (int e = tid; e < n * kTile; e += threads) {
      const int r = e / kTile;
      const int c = e % kTile;
      stage[r * S + c] = c < valid ? xb[(long long)r * d + col0 + c] : zero<T>();
    }
  } else {
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

// The widest cp.async the row addresses allow: every row start and every
// tile start (a multiple of 256 columns) must be aligned to it.
int copy_bytes(const void* x, long long d, int esize) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  for (int vb = 16; vb >= 4; vb /= 2) {
    if (vb >= esize && a % vb == 0 && (d * esize) % vb == 0) return vb;
  }
  return 0;
}

template <typename T>
cudaError_t launch_2byte(const void* x, float* o, const PairdistPlan& p,
                         cudaStream_t s) {
  switch (copy_bytes(x, p.d, 2)) {
    case 16: return launch<T, 16>(x, o, p, s);
    case 8: return launch<T, 8>(x, o, p, s);
    case 4: return launch<T, 4>(x, o, p, s);
    default: return launch<T, 0>(x, o, p, s);
  }
}

bool valid_plan(const PairdistPlan& p) {
  if (p.n < 1 || p.n > kMaxN || p.B < 1 || p.B > 65535 || p.d < 1)
    return false;
  if (p.dtype < 0 || p.dtype > 3) return false;
  if (p.phases < 1 || p.phases > kTile / 2 || (p.phases & (p.phases - 1)))
    return false;
  if (block_pairs(p.n) * p.phases > kMaxThreads) return false;
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.groups < 1 ||
      p.tiles_per_cta < 1)
    return false;
  if ((long long)p.groups * p.cluster * p.tiles_per_cta * kTile < p.d)
    return false;
  if ((long long)p.groups * p.cluster > 0x7fffffffLL) return false;
  if (p.groups > 1 && (p.scratch == nullptr || p.counters == nullptr))
    return false;
  return p.smem == smem_bytes(p.n, p.phases, esize_of(p.dtype));
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
    switch (copy_bytes(x, p.d, 4)) {
      case 16: err = launch<float, 16>(x, o, p, s); break;
      case 8: err = launch<float, 8>(x, o, p, s); break;
      default: err = launch<float, 4>(x, o, p, s); break;
    }
  } else if (p.dtype == 1) {
    err = launch_2byte<__nv_bfloat16>(x, o, p, s);
  } else if (p.dtype == 2) {
    err = launch_2byte<__half>(x, o, p, s);
  } else {
    switch (copy_bytes(x, p.d, 1)) {
      case 16: err = launch<E4M3, 16>(x, o, p, s); break;
      case 8: err = launch<E4M3, 8>(x, o, p, s); break;
      case 4: err = launch<E4M3, 4>(x, o, p, s); break;
      default: err = launch<E4M3, 0>(x, o, p, s); break;
    }
  }
  return (int)err;
}
