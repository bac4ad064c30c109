"""CUDA kernel wrapper: coordinate-wise median over the worker axis.

Replaces ``repro/kernels/median/median.py:median_pallas_batched``, which
launches the TPU sorted-weight kernel (``repro/kernels/cwtm/cwtm.py``) with
median rank weights. Here too the median is the sorted-weight kernel
(``csrc/sorted_weight.cu``, bound by device memory) with other weights.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels.cwtm.cwtm import sorted_weighted_cuda


@functools.lru_cache(maxsize=None)
def median_weights(n: int) -> Tuple[float, ...]:
    """1 at the middle sorted row (n odd), 1/2 at each of the two middle
    rows (n even): ``jnp.median``'s midpoint convention."""
    if n < 1:
        raise ValueError(f"median needs n >= 1, got {n}")
    w = [0.0] * n
    if n % 2:
        w[n // 2] = 1.0
    else:
        w[n // 2 - 1] = 0.5
        w[n // 2] = 0.5
    return tuple(w)


def median_cuda(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median on the card: x [B, n, d] -> [B, d]."""
    out = sorted_weighted_cuda(x, median_weights(x.shape[-2]))
    median_cuda.launches += 1
    return out


median_cuda.launches = 0
