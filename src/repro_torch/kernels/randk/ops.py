"""Dispatch for the Block-RandK kernels: the plain version for a CPU
tensor, the CUDA kernel for a CUDA tensor."""

from __future__ import annotations

import torch

from repro_torch.kernels.randk.randk import (  # noqa: F401 (slot_map)
    block_compress_cuda, block_decompress_cuda, momentum_scatter_cuda,
    slot_map)
from repro_torch.kernels.randk.ref import (block_compress_ref,
                                           block_decompress_ref,
                                           momentum_scatter_ref)


def _device_type(x: torch.Tensor, what: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, got {x.device}")
    return x.device.type


def compress(g: torch.Tensor, ids: torch.Tensor, *, block_size: int,
             alpha: float, out=None) -> torch.Tensor:
    """Wire payload ``[n, kb * block_size]`` of the bank ``g [n, d]``, into
    ``out`` where given (a worker's rows of the round's payload)."""
    if _device_type(g, "block compress") == "cpu":
        return block_compress_ref(g, ids, block_size, alpha, out=out)
    return block_compress_cuda(g, ids, block_size, alpha, out=out)


def decompress(payload: torch.Tensor, ids: torch.Tensor, *, block_size: int,
               d: int) -> torch.Tensor:
    """Dense ``[n, d]`` reconstruction of the payload."""
    if _device_type(payload, "block decompress") == "cpu":
        return block_decompress_ref(payload, ids, block_size, d)
    return block_decompress_cuda(payload, ids, block_size, d)


def momentum_update(m: torch.Tensor, payload: torch.Tensor, ids: torch.Tensor,
                    *, block_size: int, beta: float, window=None, slots=None,
                    out=None) -> torch.Tensor:
    """RoSDHB step 5 on the wire payload, in place on the bank ``m``:
    ``m <- beta * m + (1 - beta) * wire`` with ``wire`` the decompressed
    payload. Returns ``m``, or ``out`` where given. ``window`` ``(b0,
    b1)``: the destination blocks ``b0`` to ``b1 - 1`` alone; ``slots``:
    the round's slot map (``randk.slot_map``), built once for a round of
    windows; ``out`` (a bank narrower than float32): the caller's float32
    ``[n, (b1 - b0) * block_size]`` buffer for the unrounded result."""
    kw = dict(window=window, slots=slots, out=out)
    if _device_type(m, "momentum update") == "cpu":
        return momentum_scatter_ref(m, payload, ids, block_size, beta, **kw)
    return momentum_scatter_cuda(m, payload, ids, block_size, beta, **kw)
