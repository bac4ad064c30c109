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
                       alpha: float, out=None) -> torch.Tensor:
    """g ``[n, d]`` (``d % block_size == 0``), block ids ``[kb]`` or
    ``[n, kb]`` -> payload ``[n, kb * block_size]``: the selected blocks of
    each row times ``alpha``, multiplied in float32 and cast to g's dtype.
    ``out``: the caller's ``[n, kb * block_size]`` tensor of g's dtype (a
    worker's rows of a round's payload), written and returned."""
    n, d = g.shape
    gb = _bits(g).reshape(n, d // block_size, block_size)
    rows = torch.gather(gb, 1, _row_ids(ids, n).long()[..., None].expand(
        -1, -1, block_size)).view(g.dtype)
    payload = to_dtype(rows.float() * alpha, g.dtype).reshape(n, -1)
    return payload if out is None else out.copy_(payload)


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


def _weighted_payload(m: torch.Tensor, payload: torch.Tensor,
                      beta: float) -> torch.Tensor:
    """The payload in float32 as the update scatters it: times ``1 -
    beta`` on a float32 bank, as it is on a bfloat16 one."""
    if m.dtype == torch.bfloat16:
        return payload.float()
    return payload.float() * (1.0 - beta)


def _wire_columns(m: torch.Tensor, payload: torch.Tensor, ids: torch.Tensor,
                  block_size: int, beta: float, lo: int, hi: int
                  ) -> torch.Tensor:
    """Blocks ``[lo, hi)`` of the dense float32 wire of the payload ``[n,
    kb * block_size]``, weighted for the bank ``m``
    (:func:`_weighted_payload`): each payload block whose id falls there at
    its place, zeros elsewhere. Under one global mask only the blocks
    inside are widened to float32 (a round of windows at D ~ 4e9 would
    otherwise widen the whole payload once a window)."""
    n = payload.shape[0]
    pb = _bits(payload).reshape(n, -1, block_size)
    nb = hi - lo
    out = torch.zeros((n, nb, block_size), dtype=torch.float32,
                      device=payload.device)
    if ids.ndim == 1:  # one global mask: the blocks inside, once
        sel = ((ids >= lo) & (ids < hi)).nonzero()[:, 0]
        out[:, (ids[sel] - lo).long()] = _weighted_payload(
            m, pb[:, sel].view(payload.dtype), beta)
    else:  # per-row ids: those outside land in a dropped slot
        rid = ids.long()
        slot = torch.where((rid >= lo) & (rid < hi), rid - lo,
                           torch.full_like(rid, nb))
        out = torch.cat([out, out.new_zeros((n, 1, block_size))], dim=1)
        out.scatter_(1, slot[..., None].expand(-1, -1, block_size),
                     _weighted_payload(m, pb.view(payload.dtype), beta))
        out = out[:, :nb]
    return out.reshape(n, nb * block_size)


def _columns(m: torch.Tensor, payload: torch.Tensor, ids: torch.Tensor,
             block_size: int, beta: float, b0: int, b1: int) -> torch.Tensor:
    """The float32 momenta of blocks ``[b0, b1)``, written into ``m`` there
    (rounded to its dtype)."""
    cols = slice(b0 * block_size, b1 * block_size)
    wire = _wire_columns(m, payload, ids, block_size, beta, b0, b1)
    if m.dtype == torch.bfloat16:
        res = (m[:, cols].float() * beta).add_(wire, alpha=1.0 - beta)
    else:
        res = wire.add_(m[:, cols].float(), alpha=beta)
    m[:, cols].copy_(to_float8(res) if is_float8(m) else res)
    return res


def momentum_columns_ref(m: torch.Tensor, payload: torch.Tensor,
                         ids: torch.Tensor, block_size: int, beta: float,
                         b0: int, b1: int) -> torch.Tensor:
    """:func:`momentum_scatter_ref` on the window of blocks ``[b0, b1)``
    (columns ``b0 * block_size`` to ``b1 * block_size``) in one pass: the
    window of ``m`` updated in place, its float32 momenta returned."""
    return _columns(m, payload, ids, block_size, beta, b0, b1)


def momentum_scatter_ref(m: torch.Tensor, payload: torch.Tensor,
                         ids: torch.Tensor, block_size: int, beta: float,
                         *, window=None, slots=None,
                         out=None) -> torch.Tensor:
    """The fused RoSDHB step 5 as the dense step computes it, one fused
    multiply-add (``torch.add`` with ``alpha``) in float32: on a float32
    bank the payload times ``1 - beta`` scattered into a zeroed bank plus
    ``beta * m``; on a bfloat16 bank ``beta * m`` plus ``1 - beta`` times
    the scattered payload. ``m`` is updated in place (rounded to its
    dtype); returns ``m``, or ``out`` holding the float32 result. Runs
    :data:`MOMENTUM_COLS` columns (whole blocks) at a time
    (:func:`momentum_columns_ref`), each coordinate's arithmetic as over
    the whole bank. ``window``, ``slots`` and ``out`` as the kernel's
    wrapper takes them (``randk.momentum_scatter_cuda``): the blocks ``[b0,
    b1)`` alone, the slot map (unused: the plain version reads the ids),
    the float32 result written into ``out``."""
    del slots
    nb = m.shape[1] // block_size
    b0, b1 = (0, nb) if window is None else (int(window[0]), int(window[1]))
    step = max(1, MOMENTUM_COLS // block_size)
    for lo in range(b0, b1, step):
        hi = min(b1, lo + step)
        res = _columns(m, payload, ids, block_size, beta, lo, hi)
        if out is not None:
            out[:, (lo - b0) * block_size:(hi - b0) * block_size] = res
        del res
    return m if out is None else out
