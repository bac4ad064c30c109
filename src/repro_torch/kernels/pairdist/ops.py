"""Dispatch for the pairwise-distance kernel: the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.pairdist.pairdist import pairdist_cuda
from repro_torch.kernels.pairdist.ref import pairdist_ref


def pairdist(x: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances over the worker axis (float32), for the
    per-lane ``[n, d]`` or the batched ``[B, n, d]`` shape. Serves NNM and
    (Multi-)Krum in ``repro_torch.core.aggregators``."""
    if x.device.type == "cpu":
        return pairdist_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"pairdist runs on cpu or cuda tensors, got {x.device}")
    if x.ndim == 2:
        return pairdist_cuda(x[None])[0]
    return pairdist_cuda(x)
