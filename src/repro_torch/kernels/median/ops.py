"""Dispatch for the median kernel: the plain version for a CPU tensor, the
CUDA kernel for a CUDA tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.median.median import median_cuda
from repro_torch.kernels.median.ref import median_ref


def median(x: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the worker axis, for the per-lane
    ``[n, d]`` or the batched ``[B, n, d]`` shape."""
    if x.device.type == "cpu":
        return median_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"median runs on cpu or cuda tensors, got {x.device}")
    if x.ndim == 2:
        return median_cuda(x[None])[0]
    return median_cuda(x)
