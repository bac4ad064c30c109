"""Plain PyTorch version of the coordinate-wise median kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.cwtm.ref import by_columns
from repro_torch.utils.dtypes import to_dtype


def median_ref(x: torch.Tensor) -> torch.Tensor:
    """x: [..., n, d] -> [..., d]: the per-coordinate median over the worker
    axis, in float32. For even n it is the midpoint ``(lo + hi) * 0.5`` of
    the two middle values, as ``jnp.median`` gives; ``torch.median`` would
    return the lower one. NaN wherever a NaN is among a coordinate's values,
    as ``jnp.median`` gives. Sorted ``SORT_COLS`` coordinates at a time."""
    n = x.shape[-2]

    def mid(cols: torch.Tensor) -> torch.Tensor:
        xs = torch.sort(cols.float(), dim=-2).values
        lo = xs[..., (n - 1) // 2, :]
        hi = xs[..., n // 2, :]
        # torch.sort puts NaN last: the top rank is NaN where one is present
        return to_dtype(torch.where(torch.isnan(xs[..., -1, :]),
                                    xs[..., -1, :], (lo + hi) * 0.5),
                        x.dtype)

    return by_columns(mid, x)
