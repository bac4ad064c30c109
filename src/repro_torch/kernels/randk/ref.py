"""Plain PyTorch versions of the Block-RandK compress, decompress and fused
momentum kernels, batched over the worker axis."""

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


def momentum_scatter_ref(m: torch.Tensor, payload: torch.Tensor,
                         ids: torch.Tensor, block_size: int, beta: float,
                         f32_out: bool = False) -> torch.Tensor:
    """The fused RoSDHB step 5 as the dense step computes it, one fused
    multiply-add (``torch.add`` with ``alpha``) in float32: on a float32
    bank the payload times ``1 - beta`` scattered into a zeroed bank plus
    ``beta * m``; on a bfloat16 bank ``beta * m`` plus ``1 - beta`` times
    the scattered payload. ``m`` is updated in place (rounded to its
    dtype); returns ``m``, or with ``f32_out`` the float32 result."""
    if m.dtype == torch.bfloat16:
        wire = block_decompress_ref(payload.float(), ids, block_size,
                                    m.shape[1])
        out = (m.float() * beta).add_(wire, alpha=1.0 - beta)
    else:
        wire = block_decompress_ref(payload.float() * (1.0 - beta), ids,
                                    block_size, m.shape[1])
        out = wire.add_(m.float(), alpha=beta)
    m.copy_(out)
    return out if f32_out else m
