"""Plain PyTorch version of the coordinate-wise trimmed mean kernel."""

from __future__ import annotations

import torch

from repro_torch.utils.dtypes import to_dtype

#: Coordinates one sort takes at a time: the sort's int64 indices of a
#: whole ``[n, D]`` bank at D ~ 1e9 would not fit the card.
SORT_COLS = 1 << 22


def by_columns(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` (``[..., n, c] -> [..., c]``, each column on its own) applied
    to ``x [..., n, d]`` :data:`SORT_COLS` columns at a time, into one
    output: bitwise ``fn(x)``."""
    d, cols = x.shape[-1], SORT_COLS
    if d <= cols:
        return fn(x)
    out = None
    for i in range(0, d, cols):
        part = fn(x[..., i:i + cols])
        if out is None:
            out = part.new_empty(part.shape[:-1] + (d,))
        out[..., i:i + cols] = part
    return out


def cwtm_ref(x: torch.Tensor, f: int) -> torch.Tensor:
    """x: [..., n, d] -> [..., d]: drop the f largest and f smallest values
    per coordinate and average the middle n - 2f in float32: below float32
    the sum times ``1/(n-2f)``, rounded to x's dtype, as the reference's
    ref compiles (float8: NaN past its range). Sorted :data:`SORT_COLS`
    coordinates at a time, in float32 (the same order)."""
    n = x.shape[-2]
    if n <= 2 * f:
        raise ValueError(f"cwtm needs n > 2f, got n={n}, f={f}")

    def trim(cols: torch.Tensor) -> torch.Tensor:
        xs = torch.sort(cols.float(), dim=-2).values[..., f:n - f, :]
        if x.dtype == torch.float32:
            return xs.mean(dim=-2)
        # the reference's compiled mean multiplies the float32 sum by 1/k
        return to_dtype(xs.sum(dim=-2) * (1.0 / (n - 2 * f)), x.dtype)

    return by_columns(trim, x)
