"""CUDA kernel wrapper: batched pairwise squared distances over the worker axis.

Replaces ``repro/kernels/pairdist/pairdist.py:pairdist_kernel`` (launched by
``pairdist_pallas_batched``). The kernel, ``csrc/pairdist.cu``, is bound by
device memory (one read of ``[B, n, d]``); it splits ``d`` over
``S ~ 4 x SMs / B`` blocks per batch row that each reduce a Gram partial in
float32 FMA, then sums the partials in a fixed order in a second pass. See
the source for the design.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

TILE = 128          # columns per shared-memory tile (kTile in the source)
BLOCKS_PER_SM = 4   # target pass-1 blocks per SM, over all batch rows
MAX_N = 64
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"pairdist_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"pairdist_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"pairdist_cuda takes [B, n, d], got {tuple(x.shape)}")
    b, n, d = x.shape
    if not (1 <= n <= MAX_N) or b < 1 or d < 1 or b > 65535:
        raise ValueError(f"pairdist_cuda needs 1 <= n <= {MAX_N}, "
                         f"1 <= B <= 65535 and d >= 1, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("pairdist_cuda needs a contiguous tensor")


def split_plan(b: int, d: int, sm_count: int) -> tuple:
    """``(n_splits, tiles_per_split)``: how pass 1 cuts the ``d`` axis."""
    tiles = -(-d // TILE)
    n_splits = min(tiles, max(1, -(-BLOCKS_PER_SM * sm_count // b)))
    per = -(-tiles // n_splits)
    return -(-tiles // per), per


def pairdist_cuda(x: torch.Tensor) -> torch.Tensor:
    """x [B, n, d] (CUDA, float32 or bfloat16) -> [B, n, n] float32."""
    _check(x)
    b, n, d = x.shape
    n_pad = -(-n // 4) * 4
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_splits, per = split_plan(b, d, sms)
    partial = torch.empty((b, n_pad, n_pad, n_splits), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((b, n, n), dtype=torch.float32, device=x.device)
    lib = build.load("pairdist")
    err = lib.pairdist(x.data_ptr(), partial.data_ptr(), out.data_ptr(), b, n,
                       d, n_splits, per, DTYPES[x.dtype],
                       build.stream_ptr(x.device))
    build.check(err, "pairdist")
    pairdist_cuda.launches += 1
    return out


pairdist_cuda.launches = 0
