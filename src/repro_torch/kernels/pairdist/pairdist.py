"""CUDA kernel wrapper: batched pairwise squared distances over the worker axis.

Replaces ``repro/kernels/pairdist/pairdist.py:pairdist_kernel`` (launched by
``pairdist_pallas_batched``). The kernel, ``csrc/pairdist.cu``, is one
launch: thread block clusters cut each batch row's ``d`` axis, each CTA
streams its tiles through a cp.async ring and reduces a Gram partial in
float32 FMA, rank 0 of a cluster sums the ranks' partials through
distributed shared memory, and where a row needs several clusters the last
one to finish (a ticket counter) sums theirs in a fixed order. See the
source for the design.

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

TILE = 256            # columns per staged tile (kTile in the source)
STAGES = 3            # tiles in the cp.async ring (kStages)
MAX_THREADS = 512     # threads per CTA (kMaxThreads)
MAX_CLUSTER = 16      # CTAs per cluster, non-portable size (kMaxCluster)
PORTABLE_CLUSTER = 8  # the cluster size where a row takes several clusters
ONE_CLUSTER_TILES = 8  # a row of at most 16 x 8 tiles takes one cluster
BLOCKS_PER_SM = 4     # target CTAs per SM, over all batch rows
SMEM_LIMIT = 232_448  # shared memory a block can use on Hopper (227 KB)
MAX_N = 64
MAX_B = 65535
#: The input dtypes and their codes (those of ``csrc/randk.cu``).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float8_e4m3fn: 3}


class PairdistPlan(NamedTuple):
    n_pad: int          # n rounded up to 4
    threads: int        # block_pairs * phases
    phases: int         # threads that share a 4x4 block pair: 32 or
                        # more (whole warps) for n <= 20
    cluster: int        # CTAs per cluster
    groups: int         # clusters per batch row
    tiles_per_cta: int  # TILE-column tiles per CTA
    smem: int           # dynamic shared memory bytes

    @property
    def ctas(self) -> int:
        """CTAs per batch row."""
        return self.groups * self.cluster

    def columns(self, k: int, d: int) -> range:
        """The columns of ``d`` that CTA ``k`` of a row reduces."""
        lo = k * self.tiles_per_cta * TILE
        return range(min(lo, d), min(lo + self.tiles_per_cta * TILE, d))


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


def _pow2_at_least(v: int) -> int:
    p = 1
    while p < v:
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
    """
    n_pad = -(-n // 4) * 4
    phases = 1
    while 2 * phases * block_pairs(n) <= MAX_THREADS and 2 * phases <= TILE // 2:
        phases *= 2
    threads = block_pairs(n) * phases
    tiles = -(-d // TILE)
    want = min(tiles, max(1, -(-BLOCKS_PER_SM * sm_count // b)))
    if want <= MAX_CLUSTER or tiles <= MAX_CLUSTER * ONE_CLUSTER_TILES:
        cluster = _pow2_at_least(min(want, MAX_CLUSTER))
        per = -(-tiles // cluster)
        cluster = _pow2_at_least(-(-tiles // per))
        groups = 1
    else:
        cluster = PORTABLE_CLUSTER
        groups = -(-want // cluster)
        per = -(-tiles // (groups * cluster))
        groups = -(-tiles // (per * cluster))
    return PairdistPlan(n_pad, threads, phases, cluster, groups, per,
                        smem_bytes(n, phases, itemsize))


class PlanStruct(ctypes.Structure):
    """``struct PairdistPlan`` of the source, field for field."""
    _fields_ = [("d", ctypes.c_longlong), ("scratch", ctypes.c_void_p),
                ("counters", ctypes.c_void_p), ("B", ctypes.c_int),
                ("n", ctypes.c_int), ("dtype", ctypes.c_int),
                ("phases", ctypes.c_int), ("cluster", ctypes.c_int),
                ("groups", ctypes.c_int), ("tiles_per_cta", ctypes.c_int),
                ("smem", ctypes.c_int)]


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
        plan.cluster, plan.groups, plan.tiles_per_cta, plan.smem)
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
