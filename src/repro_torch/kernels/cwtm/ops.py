"""Dispatch for the CWTM kernel: the plain version for a CPU tensor, the
CUDA kernel for a CUDA tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.cwtm.cwtm import cwtm_cuda
from repro_torch.kernels.cwtm.ref import cwtm_ref


def cwtm(x: torch.Tensor, f: int) -> torch.Tensor:
    """Coordinate-wise trimmed mean over the worker axis, for the per-lane
    ``[n, d]`` or the batched ``[B, n, d]`` shape."""
    if x.device.type == "cpu":
        return cwtm_ref(x, f)
    if x.device.type != "cuda":
        raise ValueError(f"cwtm runs on cpu or cuda tensors, got {x.device}")
    if x.ndim == 2:
        return cwtm_cuda(x[None], f)[0]
    return cwtm_cuda(x, f)
