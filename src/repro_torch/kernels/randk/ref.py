"""Plain PyTorch versions of the Block-RandK compress, decompress and fused
momentum kernels, batched over the worker axis. Banks are float32,
bfloat16, float16 or float8_e4m3fn: values move as bits (PyTorch has no
float8 gather or scatter), arithmetic is float32, and each result is
rounded once to the bank's dtype (``utils.dtypes.to_dtype``)."""

from __future__ import annotations

import torch

from repro_torch.utils.dtypes import is_float8, to_dtype, to_float8


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` viewed as integers of its width, to move its values as bits."""
    return x.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[x.element_size()])


def _row_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``[kb]`` (one global mask) or ``[n, kb]`` (local masks) -> ``[n, kb]``."""
    return ids.expand(n, ids.shape[-1]) if ids.ndim == 1 else ids


def block_compress_ref(g: torch.Tensor, ids: torch.Tensor, block_size: int,
                       alpha: float) -> torch.Tensor:
    """g ``[n, d]`` (``d % block_size == 0``), block ids ``[kb]`` or
    ``[n, kb]`` -> payload ``[n, kb * block_size]``: the selected blocks of
    each row times ``alpha``, multiplied in float32 and cast to g's dtype."""
    n, d = g.shape
    gb = _bits(g).reshape(n, d // block_size, block_size)
    rows = torch.gather(gb, 1, _row_ids(ids, n).long()[..., None].expand(
        -1, -1, block_size)).view(g.dtype)
    return to_dtype(rows.float() * alpha, g.dtype).reshape(n, -1)


def block_decompress_ref(payload: torch.Tensor, ids: torch.Tensor,
                         block_size: int, d: int) -> torch.Tensor:
    """payload ``[n, kb * block_size]`` -> dense ``[n, d]``: each payload
    block at its block id, zeros elsewhere."""
    n = payload.shape[0]
    pb = _bits(payload).reshape(n, -1, block_size)
    out = pb.new_zeros((n, d // block_size, block_size))
    out.scatter_(1, _row_ids(ids, n).long()[..., None].expand(
        -1, -1, block_size), pb)
    return out.view(payload.dtype).reshape(n, d)


#: Columns the plain momentum update takes at a time (whole blocks): its
#: float32 ``[n, D]`` transients at D ~ 1e9 would not fit the card.
MOMENTUM_COLS = 1 << 24


def _wire_columns(pf: torch.Tensor, ids: torch.Tensor, block_size: int,
                  lo: int, hi: int) -> torch.Tensor:
    """Blocks ``[lo, hi)`` of the dense wire of the payload ``pf [n, kb *
    block_size]``: each payload block whose id falls there at its place,
    zeros elsewhere."""
    n = pf.shape[0]
    pb = pf.reshape(n, -1, block_size)
    nb = hi - lo
    out = pf.new_zeros((n, nb, block_size))
    if ids.ndim == 1:  # one global mask: the blocks inside, once
        sel = ((ids >= lo) & (ids < hi)).nonzero()[:, 0]
        out[:, (ids[sel] - lo).long()] = pb[:, sel]
    else:  # per-row ids: those outside land in a dropped slot
        rid = ids.long()
        slot = torch.where((rid >= lo) & (rid < hi), rid - lo,
                           torch.full_like(rid, nb))
        out = torch.cat([out, out.new_zeros((n, 1, block_size))], dim=1)
        out.scatter_(1, slot[..., None].expand(-1, -1, block_size), pb)
        out = out[:, :nb]
    return out.reshape(n, nb * block_size)


def _weighted_payload(m: torch.Tensor, payload: torch.Tensor,
                      beta: float) -> torch.Tensor:
    """The payload in float32 as the update scatters it: times ``1 -
    beta`` on a float32 bank, as it is on a bfloat16 one."""
    if m.dtype == torch.bfloat16:
        return payload.float()
    return payload.float() * (1.0 - beta)


def _columns(m: torch.Tensor, pf: torch.Tensor, ids: torch.Tensor,
             block_size: int, beta: float, b0: int, b1: int) -> torch.Tensor:
    cols = slice(b0 * block_size, b1 * block_size)
    wire = _wire_columns(pf, ids, block_size, b0, b1)
    if m.dtype == torch.bfloat16:
        return (m[:, cols].float() * beta).add_(wire, alpha=1.0 - beta)
    return wire.add_(m[:, cols].float(), alpha=beta)


def momentum_columns_ref(m: torch.Tensor, payload: torch.Tensor,
                         ids: torch.Tensor, block_size: int, beta: float,
                         b0: int, b1: int) -> torch.Tensor:
    """The float32 momenta of blocks ``[b0, b1)`` (columns ``b0 *
    block_size`` to ``b1 * block_size``) of :func:`momentum_scatter_ref`,
    from the bank ``m``, which is left as it is."""
    return _columns(m, _weighted_payload(m, payload, beta), ids, block_size,
                    beta, b0, b1)


def momentum_scatter_ref(m: torch.Tensor, payload: torch.Tensor,
                         ids: torch.Tensor, block_size: int, beta: float,
                         f32_out: bool = False) -> torch.Tensor:
    """The fused RoSDHB step 5 as the dense step computes it, one fused
    multiply-add (``torch.add`` with ``alpha``) in float32: on a float32
    bank the payload times ``1 - beta`` scattered into a zeroed bank plus
    ``beta * m``; on a bfloat16 bank ``beta * m`` plus ``1 - beta`` times
    the scattered payload. ``m`` is updated in place (rounded to its
    dtype); returns ``m``, or with ``f32_out`` the float32 result. Runs
    :data:`MOMENTUM_COLS` columns (whole blocks) at a time
    (:func:`momentum_columns_ref`), each coordinate's arithmetic as over
    the whole bank."""
    n, d = m.shape
    pf = _weighted_payload(m, payload, beta)
    out = torch.empty((n, d), device=m.device) if f32_out else None
    step = max(1, MOMENTUM_COLS // block_size)
    nb = d // block_size
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        cols = slice(b0 * block_size, b1 * block_size)
        res = _columns(m, pf, ids, block_size, beta, b0, b1)
        m[:, cols].copy_(to_float8(res) if is_float8(m) else res)
        if out is not None:
            out[:, cols] = res
        del res
    return out if f32_out else m
