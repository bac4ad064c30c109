"""CUDA kernel wrappers: static rank weighting of the sorted worker axis.

Replaces ``repro/kernels/cwtm/cwtm.py:sorted_weight_kernel`` (launched by
``sorted_weighted_batched``). The kernel, ``csrc/sorted_weight.cu``, is bound
by device memory (one read of ``[B, n, d]``, one write of ``[B, d]``): one
thread per coordinate holds its ``n`` values in registers, sorts them with a
bitonic network unrolled at compile time and sums them with static rank
weights. CWTM (here) and the coordinate-wise median
(``repro_torch.kernels.median``) are this kernel with two weight vectors.

Below float32 a thread owns :func:`vec_of` adjacent coordinates, reads
each worker row in loads of :func:`load_width` bytes and sorts two
coordinates an instruction (f16x2 or bf16x2); every result keeps the
float32 sum's bits. Where that leaves the card short of threads
(:func:`plan_vec`) a thread takes one coordinate, as at float32.

The launch plan (the block size, :func:`sorted_weight_threads`, the
coordinates a thread and the load width, and the float32 weights) is built
once per ``(B, n, d, dtype, weights, device, address mod 16)`` into the C
struct the entry takes; a call allocates only its output.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.kernels import build

MAX_N = 64
MAX_B = 65535
#: The input dtypes and their codes (those of ``csrc/randk.cu``).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float8_e4m3fn: 3}
THREADS = (256, 128, 64)  # block sizes, widest first


def _bitonic_pairs(n: int):
    """Compare-exchange stages of the bitonic network for n (a power of 2)."""
    stages = []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            stages.append([(i, i ^ j, (i & k) == 0)
                           for i in range(n) if (i ^ j) > i])
            j //= 2
        k *= 2
    return stages


def sort_network_compares(n_pad: int) -> int:
    """Compare-exchange pairs of the bitonic network (2 ops each: min, max)."""
    return sum(len(stage) for stage in _bitonic_pairs(n_pad))


def n_pad_of(n: int) -> int:
    """The power of two (at least 2) the kernel pads ``n`` rows to."""
    p = 2
    while p < n:
        p *= 2
    return p


def vec_of(n_pad: int, itemsize: int) -> int:
    """Coordinates a thread owns (``vec_of`` of the source): 1 at float32;
    below it at most a 16-byte load a row and at most 64 values (``V *
    n_pad``, two to a register); at least one pair."""
    if itemsize >= 4:
        return 1
    return max(2, min(16 // itemsize, 64 // n_pad))


#: Threads an SM the vector plan must give, else a narrow class takes one
#: coordinate a thread (latency-bound: CWTM at [1, 13, 11958] on an H100
#: read 1.8 µs of device time so and 5.3 at V = 4; at [36, 13, 11958], 108K
#: threads at V = 4, 9.1 against 10.7).
VEC_MIN_THREADS_PER_SM = 512


def plan_vec(b: int, n: int, d: int, itemsize: int, sm_count: int) -> int:
    """Coordinates a thread the plan takes: :func:`vec_of`, or 1 (the
    float32 kernel's design) where that would leave an SM fewer than
    :data:`VEC_MIN_THREADS_PER_SM` threads."""
    vec = vec_of(n_pad_of(n), itemsize)
    if -(-d // vec) * b < VEC_MIN_THREADS_PER_SM * sm_count:
        return 1
    return vec


def load_width(address: int, d: int, itemsize: int, vec: int) -> int:
    """Bytes a load: the widest power of two up to ``vec * itemsize`` that
    the tensor's address and its row length ``d * itemsize`` are multiples
    of (every row start and every thread's first coordinate then lie on
    it); ``itemsize`` at the least."""
    w = vec * itemsize
    while w > itemsize and (address % w or (d * itemsize) % w):
        w //= 2
    return w


def sorted_weight_threads(b: int, d: int, sm_count: int,
                          vec: int = 1) -> int:
    """Threads a block: 256, or the widest of 128 and 64 that gives at least
    one block per SM (64 if none does): ``vec`` coordinates a thread, so a
    small ``[b, n, d]`` spreads over the card."""
    coords = -(-d // vec)  # threads a row
    for t in THREADS[:-1]:
        if -(-coords // t) * b >= sm_count:
            return t
    return THREADS[-1]


class RankWeights(ctypes.Structure):
    _fields_ = [("w", ctypes.c_float * MAX_N)]


class PlanStruct(ctypes.Structure):
    """``struct SortedWeightPlan`` of the source, field for field."""
    _fields_ = [("d", ctypes.c_longlong), ("B", ctypes.c_int),
                ("n", ctypes.c_int), ("dtype", ctypes.c_int),
                ("threads", ctypes.c_int), ("nan_out", ctypes.c_int),
                ("vec", ctypes.c_int), ("width", ctypes.c_int),
                ("weights", RankWeights)]


def plan_struct(b: int, n: int, d: int, dtype: torch.dtype,
                weights: Sequence[float], sm_count: int,
                nan_out: bool = False, address: int = 0) -> PlanStruct:
    """The C launch plan: the block size for the card, the coordinates a
    thread and the load width (from the tensor's ``address``), the weights
    as float32, zero past ``n``, and whether a NaN among a coordinate's
    values makes it NaN (``nan_out``, the median) or sorts last (CWTM)."""
    w = RankWeights()
    w.w[:len(weights)] = [float(v) for v in weights]
    size = torch.empty((), dtype=dtype).element_size()
    vec = plan_vec(b, n, d, size, sm_count)
    return PlanStruct(d, b, n, DTYPES[dtype],
                      sorted_weight_threads(b, d, sm_count, vec),
                      int(nan_out), vec, load_width(address, d, size, vec),
                      w)


#: ``{(B, n, d, dtype, device index, weights, nan_out, address % 16):
#: (struct address, struct)}``.
_LAUNCH: Dict[tuple, tuple] = {}


def _check(x: torch.Tensor, weights: Sequence[float]) -> None:
    if not x.is_cuda:
        raise ValueError(f"sorted-weight kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError("sorted-weight kernel takes float32, bfloat16, "
                        f"float16 or float8_e4m3fn, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"sorted-weight kernel takes [B, n, d], got {tuple(x.shape)}")
    b, n, d = x.shape
    if not (1 <= n <= MAX_N) or b < 1 or d < 1 or b > MAX_B:
        raise ValueError(f"sorted-weight kernel needs 1 <= n <= {MAX_N}, "
                         f"1 <= B <= {MAX_B} and d >= 1, got {tuple(x.shape)}")
    if len(weights) != n:
        raise ValueError(f"{len(weights)} rank weights for n={n}")
    if not x.is_contiguous():
        raise ValueError("sorted-weight kernel needs a contiguous tensor")


def sorted_weighted_cuda(x: torch.Tensor, weights: Sequence[float],
                         nan_out: bool = False) -> torch.Tensor:
    """Launch the kernel: x [B, n, d] -> [B, d] in x's dtype, where
    ``weights[i]`` scales the i-th smallest value of each coordinate, NaN
    sorted after every number (``nan_out``: NaN wherever one is among the
    values). The callers (:func:`cwtm_cuda`, ``median_cuda``) count the
    launch."""
    _check(x, weights)
    b, n, d = x.shape
    idx = x.get_device()
    ptr = x.data_ptr()
    key = (b, n, d, x.dtype, idx, tuple(weights), nan_out, ptr % 16)
    launch = _LAUNCH.get(key)
    if launch is None:
        struct = plan_struct(b, n, d, x.dtype, weights, build.sm_count(idx),
                             nan_out, ptr % 16)
        launch = _LAUNCH[key] = (ctypes.addressof(struct), struct)
    out = x.new_empty((b, d))
    err = build.entry("sorted_weight", "sorted_weight")(
        ptr, out.data_ptr(), launch[0], build.stream_ptr(idx))
    build.check(err, "sorted_weight")
    return out


@functools.lru_cache(maxsize=None)
def cwtm_weights(n: int, f: int) -> Tuple[float, ...]:
    """Rank weights of the trimmed mean: 1/(n-2f) over ranks [f, n-f)."""
    if n <= 2 * f:
        raise ValueError(f"cwtm needs n > 2f, got n={n}, f={f}")
    w = 1.0 / float(n - 2 * f)
    return tuple(w if f <= i < n - f else 0.0 for i in range(n))


def cwtm_cuda(x: torch.Tensor, f: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean on the card: x [B, n, d] -> [B, d]."""
    out = sorted_weighted_cuda(x, cwtm_weights(x.shape[-2], f))
    cwtm_cuda.launches += 1
    return out


cwtm_cuda.launches = 0
