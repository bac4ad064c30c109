"""Plain PyTorch versions of the Block-RandK compress and decompress
kernels, batched over the worker axis."""

from __future__ import annotations

import torch


def _row_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``[kb]`` (one global mask) or ``[n, kb]`` (local masks) -> ``[n, kb]``."""
    return ids.expand(n, ids.shape[-1]) if ids.ndim == 1 else ids


def block_compress_ref(g: torch.Tensor, ids: torch.Tensor, block_size: int,
                       alpha: float) -> torch.Tensor:
    """g ``[n, d]`` (``d % block_size == 0``), block ids ``[kb]`` or
    ``[n, kb]`` -> payload ``[n, kb * block_size]``: the selected blocks of
    each row times ``alpha``, multiplied in float32 and cast to g's dtype."""
    n, d = g.shape
    gb = g.reshape(n, d // block_size, block_size)
    rows = torch.gather(gb, 1, _row_ids(ids, n).long()[..., None].expand(
        -1, -1, block_size))
    return (rows.float() * alpha).to(g.dtype).reshape(n, -1)


def block_decompress_ref(payload: torch.Tensor, ids: torch.Tensor,
                         block_size: int, d: int) -> torch.Tensor:
    """payload ``[n, kb * block_size]`` -> dense ``[n, d]``: each payload
    block at its block id, zeros elsewhere."""
    n = payload.shape[0]
    pb = payload.reshape(n, -1, block_size)
    out = payload.new_zeros((n, d // block_size, block_size))
    out.scatter_(1, _row_ids(ids, n).long()[..., None].expand(
        -1, -1, block_size), pb)
    return out.reshape(n, d)
