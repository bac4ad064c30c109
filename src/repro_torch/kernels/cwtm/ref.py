"""Plain PyTorch version of the coordinate-wise trimmed mean kernel."""

from __future__ import annotations

import torch


def cwtm_ref(x: torch.Tensor, f: int) -> torch.Tensor:
    """x: [..., n, d] -> [..., d]: drop the f largest and f smallest values
    per coordinate and average the middle n - 2f in float32."""
    n = x.shape[-2]
    if n <= 2 * f:
        raise ValueError(f"cwtm needs n > 2f, got n={n}, f={f}")
    xs = torch.sort(x, dim=-2).values
    return xs[..., f:n - f, :].float().mean(dim=-2).to(x.dtype)
