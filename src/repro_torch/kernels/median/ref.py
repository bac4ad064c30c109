"""Plain PyTorch version of the coordinate-wise median kernel."""

from __future__ import annotations

import torch


def median_ref(x: torch.Tensor) -> torch.Tensor:
    """x: [..., n, d] -> [..., d]: the per-coordinate median over the worker
    axis, in float32. For even n it is the midpoint ``(lo + hi) * 0.5`` of
    the two middle values, as ``jnp.median`` gives; ``torch.median`` would
    return the lower one."""
    n = x.shape[-2]
    xs = torch.sort(x.float(), dim=-2).values
    lo = xs[..., (n - 1) // 2, :]
    hi = xs[..., n // 2, :]
    return ((lo + hi) * 0.5).to(x.dtype)
