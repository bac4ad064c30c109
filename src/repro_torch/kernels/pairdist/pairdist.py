"""CUDA kernel wrapper: batched pairwise squared distances over the worker axis.

Replaces ``repro/kernels/pairdist/pairdist.py:pairdist_kernel`` (launched by
``pairdist_pallas_batched``). The kernel, ``csrc/pairdist.cu``, is one
launch: thread block clusters cut each batch row's ``d`` axis, each CTA
streams its tiles through a cp.async ring and reduces a Gram partial in
float32 FMA, rank 0 of a cluster sums the ranks' partials through
distributed shared memory, and where a row needs several clusters the last
one to finish (a ticket counter) sums theirs in a fixed order. See the
source for the design.

Below float32 a tile is one of bytes (:func:`narrow_tile_bytes`), copied
in the aligned 16-byte chunks that cover each row whatever its alignment,
moved once into a 16-bit work tile (float8 widened
to half) and summed by the tensor cores (``mma.sync``, float32
accumulators) in :data:`NARROW_THREADS` threads a CTA.

The launch plan (:func:`pairdist_plan`) is pure Python and is built once
per ``(B, n, d, dtype, device)``, with the scratch it needs; the ticket
counters are allocated and zeroed once per device, and every call leaves
them at zero. A call allocates only its output.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import build

TILE = 256            # columns per float32 tile (kTile in the source)
TILE_BYTES = 1024     # bytes of a narrow class's staged row ...
SMALL_TILE_BYTES = 512  # ... where n_pad > NARROW_WIDE_N_PAD
NARROW_WIDE_N_PAD = 32
STAGES = 3            # tiles in the cp.async ring (kStages)
MAX_THREADS = 512     # threads per CTA (kMaxThreads)
NARROW_THREADS = 256  # threads per CTA of the narrow kernels
MAX_CLUSTER = 16      # CTAs per cluster, non-portable size (kMaxCluster)
PORTABLE_CLUSTER = 8  # the cluster size where a row takes several clusters
ONE_CLUSTER_TILES = 8  # a row of at most 16 x 8 tiles takes one cluster
BLOCKS_PER_SM = 4     # target CTAs per SM, over all batch rows
SMEM_LIMIT = 232_448  # shared memory a block can use on Hopper (227 KB)
SM_SMEM = 233_472     # shared memory of an SM (228 KB) ...
BLOCK_RESERVE = 1024  # ... of which each resident block reserves 1 KB
NARROW_SMEM_MAX = 200 * 1024  # kNarrowSmemMax
NARROW_MIN_TILES = 3  # tiles a narrow CTA takes at the least, where d allows
MAX_N = 64
MAX_B = 65535
#: The input dtypes and their codes (those of ``csrc/randk.cu``).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float8_e4m3fn: 3}


class PairdistPlan(NamedTuple):
    n_pad: int          # n rounded up to 4
    threads: int        # block_pairs * phases (NARROW_THREADS below float32)
    phases: int         # threads that share a 4x4 block pair: 32 or
                        # more (whole warps) for n <= 20; 1 below float32
    cluster: int        # CTAs per cluster
    groups: int         # clusters per batch row
    tiles_per_cta: int  # tiles per CTA
    smem: int           # dynamic shared memory bytes
    tile: int = TILE    # columns a tile (tile_columns)

    @property
    def ctas(self) -> int:
        """CTAs per batch row."""
        return self.groups * self.cluster

    def columns(self, k: int, d: int) -> range:
        """The columns of ``d`` that CTA ``k`` of a row reduces."""
        lo = k * self.tiles_per_cta * self.tile
        return range(min(lo, d), min(lo + self.tiles_per_cta * self.tile, d))


def block_pairs(n: int) -> int:
    nb = -(-n // 4)
    return nb * (nb + 1) // 2


def smem_bytes(n: int, phases: int, itemsize: int) -> int:
    """``smem_bytes`` of the source: the ring (later the phase sums, later
    the Gram matrix), rounded to 16, then the CTA's partial."""
    n_pad = -(-n // 4) * 4
    ring = STAGES * n_pad * (TILE + 16 // itemsize) * itemsize
    red = phases * block_pairs(n) * 16 * 4
    work = -(-max(ring, red, n_pad * n_pad * 4) // 16) * 16
    return work + block_pairs(n) * 16 * 4


def narrow_tile_bytes(n: int, itemsize: int) -> int:
    """Bytes of a narrow class's staged row: :data:`TILE_BYTES`, the float32
    tile's, at 16 bits; :data:`SMALL_TILE_BYTES` at float8 (its 16-bit work
    tile doubles the bytes: 1,024 columns held 2 CTAs an SM and ran 16-31%
    slower than 512 at d = 1,048,576 and 11,958 on an H100) and where
    ``n_pad`` passes :data:`NARROW_WIDE_N_PAD` (the ring and the work tile
    would pass 227 KB)."""
    if itemsize == 1 or -(-n // 4) * 4 > NARROW_WIDE_N_PAD:
        return SMALL_TILE_BYTES
    return TILE_BYTES


def tile_columns(n: int, itemsize: int) -> int:
    """Columns a staged tile: :data:`TILE` at float32, else a tile of
    :func:`narrow_tile_bytes` bytes (512 columns at n <= 32)."""
    return TILE if itemsize >= 4 else narrow_tile_bytes(n, itemsize) // itemsize


def narrow_smem_bytes(n: int, tile_bytes: int, itemsize: int) -> int:
    """``narrow_smem_bytes`` of the source: for ``16 * ceil(n / 16)`` rows,
    the ring of staged rows of ``tile_bytes + 16`` bytes and the 16-bit
    work tile of ``tile_bytes / itemsize`` columns and 16 bytes a row (later
    the warps' Gram blocks, later the Gram matrix), rounded to 16, then the
    CTA's partial."""
    rows = -(-n // 16) * 16
    n_pad = -(-n // 4) * 4
    tiles = (STAGES * rows * (tile_bytes + 16)
             + rows * (2 * (tile_bytes // itemsize) + 16))
    red = NARROW_THREADS // 32 * rows * rows * 4
    work = -(-max(tiles, red, n_pad * n_pad * 4) // 16) * 16
    return work + block_pairs(n) * 16 * 4


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
        p *= 2
    return p


def _pow2_at_most(v: int) -> int:
    p = 1
    while 2 * p <= v:
        p *= 2
    return p


def pairdist_plan(b: int, n: int, d: int, itemsize: int,
                  sm_count: int) -> PairdistPlan:
    """How the kernel cuts ``[b, n, d]`` on a card of ``sm_count`` SMs.

    Each CTA owns ``tiles_per_cta`` consecutive tiles of a row. A row of at
    most ``MAX_CLUSTER * ONE_CLUSTER_TILES`` tiles, or one that wants no
    more CTAs than a cluster holds, is one cluster (up to 16 CTAs, a power
    of two): no scratch, no ticket. Longer rows take ``groups`` clusters of
    ``PORTABLE_CLUSTER``, about ``BLOCKS_PER_SM`` CTAs per SM over the batch.
    Below float32 the narrow classes take their tiles of bytes, as many
    CTAs an SM as its shared memory lets one hold, with clusters and groups
    rounded down so that the grid is one wave, and at least
    :data:`NARROW_MIN_TILES` tiles a CTA (a CTA's prologue and epilogue are
    fixed costs: [36, 13, 11958] at 16 CTAs of 2 tiles a row ran 20-44%
    slower than at 8 of 3).
    """
    narrow = itemsize < 4
    n_pad = -(-n // 4) * 4
    phases = 1
    while 2 * phases * block_pairs(n) <= MAX_THREADS and 2 * phases <= TILE // 2:
        phases *= 2
    threads = block_pairs(n) * phases
    tile = tile_columns(n, itemsize)
    tiles = -(-d // tile)
    if narrow:  # warps of the tensor cores; no phases; one wave
        phases, threads = 1, NARROW_THREADS
        smem = narrow_smem_bytes(n, tile * itemsize, itemsize)
        per_sm = max(1, SM_SMEM // (smem + BLOCK_RESERVE))
        want = min(max(1, tiles // NARROW_MIN_TILES),
                   max(1, per_sm * sm_count // b))
        first, down = _pow2_at_most, lambda a, c: max(1, a // c)
    else:
        smem = smem_bytes(n, phases, itemsize)
        want = min(tiles, max(1, -(-BLOCKS_PER_SM * sm_count // b)))
        first, down = _pow2_at_least, lambda a, c: -(-a // c)
    if want <= MAX_CLUSTER or tiles <= MAX_CLUSTER * ONE_CLUSTER_TILES:
        cluster = first(min(want, MAX_CLUSTER))
        per = -(-tiles // cluster)
        cluster = _pow2_at_least(-(-tiles // per))
        groups = 1
    else:
        cluster = PORTABLE_CLUSTER
        groups = down(want, cluster)
        per = -(-tiles // (groups * cluster))
        groups = -(-tiles // (per * cluster))
    return PairdistPlan(n_pad, threads, phases, cluster, groups, per, smem,
                        tile)


class PlanStruct(ctypes.Structure):
    """``struct PairdistPlan`` of the source, field for field."""
    _fields_ = [("d", ctypes.c_longlong), ("scratch", ctypes.c_void_p),
                ("counters", ctypes.c_void_p), ("B", ctypes.c_int),
                ("n", ctypes.c_int), ("dtype", ctypes.c_int),
                ("phases", ctypes.c_int), ("cluster", ctypes.c_int),
                ("groups", ctypes.c_int), ("tiles_per_cta", ctypes.c_int),
                ("smem", ctypes.c_int), ("tile", ctypes.c_int)]


#: ``{device index: int32 [MAX_B] ticket counters}``, zeroed once.
_COUNTERS: Dict[int, torch.Tensor] = {}
#: ``{(B, n, d, dtype, device index): (struct address, struct, scratch)}``.
_LAUNCH: Dict[tuple, tuple] = {}


def counters(device: torch.device) -> torch.Tensor:
    """The device's ticket counters (zero between calls)."""
    idx = torch.device(device).index or 0
    c = _COUNTERS.get(idx)
    if c is None:
        c = _COUNTERS[idx] = torch.zeros(MAX_B, dtype=torch.int32,
                                         device=torch.device("cuda", idx))
    return c


def _launch_plan(key: tuple) -> tuple:
    b, n, d, dtype, idx = key
    plan = pairdist_plan(b, n, d, dtype.itemsize, build.sm_count(idx))
    dev = torch.device("cuda", idx)
    scratch = None
    if plan.groups > 1:
        scratch = torch.empty(b * plan.groups * plan.n_pad ** 2,
                              dtype=torch.float32, device=dev)
    struct = PlanStruct(
        d, scratch.data_ptr() if scratch is not None else None,
        counters(dev).data_ptr(), b, n, DTYPES[dtype], plan.phases,
        plan.cluster, plan.groups, plan.tiles_per_cta, plan.smem, plan.tile)
    return ctypes.addressof(struct), struct, scratch


def _check(x: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"pairdist_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError("pairdist_cuda takes float32, bfloat16, float16 or "
                        f"float8_e4m3fn, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"pairdist_cuda takes [B, n, d], got {tuple(x.shape)}")
    b, n, d = x.shape
    if not (1 <= n <= MAX_N) or b < 1 or d < 1 or b > MAX_B:
        raise ValueError(f"pairdist_cuda needs 1 <= n <= {MAX_N}, "
                         f"1 <= B <= {MAX_B} and d >= 1, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("pairdist_cuda needs a contiguous tensor")


def pairdist_cuda(x: torch.Tensor) -> torch.Tensor:
    """x [B, n, d] (CUDA, float32, bfloat16, float16 or float8_e4m3fn) ->
    [B, n, n] float32."""
    _check(x)
    b, n, d = x.shape
    idx = x.get_device()
    key = (b, n, d, x.dtype, idx)
    launch = _LAUNCH.get(key)
    if launch is None:
        launch = _LAUNCH[key] = _launch_plan(key)
    out = x.new_empty((b, n, n), dtype=torch.float32)
    err = build.entry("pairdist", "pairdist")(
        x.data_ptr(), out.data_ptr(), launch[0], build.stream_ptr(idx))
    build.check(err, "pairdist")
    pairdist_cuda.launches += 1
    return out


pairdist_cuda.launches = 0
