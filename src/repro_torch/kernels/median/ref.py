"""Plain PyTorch version of the coordinate-wise median kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.cwtm.ref import by_columns


def median_ref(x: torch.Tensor) -> torch.Tensor:
    """x: [..., n, d] -> [..., d]: the per-coordinate median over the worker
    axis, in float32. For even n it is the midpoint ``(lo + hi) * 0.5`` of
    the two middle values, as ``jnp.median`` gives; ``torch.median`` would
    return the lower one. Sorted ``SORT_COLS`` coordinates at a time."""
    n = x.shape[-2]

    def mid(cols: torch.Tensor) -> torch.Tensor:
        xs = torch.sort(cols.float(), dim=-2).values
        lo = xs[..., (n - 1) // 2, :]
        hi = xs[..., n // 2, :]
        return ((lo + hi) * 0.5).to(x.dtype)

    return by_columns(mid, x)
