"""Dispatch for the Block-RandK kernels: the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.randk.randk import (block_compress_cuda,
                                             block_decompress_cuda,
                                             momentum_scatter_cuda)
from repro_torch.kernels.randk.ref import (block_compress_ref,
                                           block_decompress_ref,
                                           momentum_scatter_ref)


def _device_type(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    return x.device.type


def compress(g: torch.Tensor, ids: torch.Tensor, *, block_size: int,
             alpha: float) -> torch.Tensor:
    """Wire payload ``[n, kb * block_size]`` of the bank ``g [n, d]``."""
    if _device_type(g, "block compress") == "cpu":
        return block_compress_ref(g, ids, block_size, alpha)
    return block_compress_cuda(g, ids, block_size, alpha)


def decompress(payload: torch.Tensor, ids: torch.Tensor, *, block_size: int,
               d: int) -> torch.Tensor:
    """Dense ``[n, d]`` reconstruction of the payload."""
    if _device_type(payload, "block decompress") == "cpu":
        return block_decompress_ref(payload, ids, block_size, d)
    return block_decompress_cuda(payload, ids, block_size, d)


def momentum_update(m: torch.Tensor, payload: torch.Tensor, ids: torch.Tensor,
                    *, block_size: int, beta: float,
                    f32_out: bool = False) -> torch.Tensor:
    """RoSDHB step 5 on the wire payload, in place on the bank ``m``:
    ``m <- beta * m + (1 - beta) * wire`` with ``wire`` the decompressed
    payload. Returns ``m``, or with ``f32_out`` (a bfloat16 bank) the
    unrounded float32 result."""
    if _device_type(m, "momentum update") == "cpu":
        return momentum_scatter_ref(m, payload, ids, block_size, beta,
                                    f32_out)
    return momentum_scatter_cuda(m, payload, ids, block_size, beta, f32_out)
