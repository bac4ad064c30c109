"""Plain PyTorch version of the pairwise squared-distance kernel."""

from __future__ import annotations

import torch


def pairdist_ref(x: torch.Tensor) -> torch.Tensor:
    """x: [..., n, d] -> [..., n, n] clamped squared distances in float32:
    ``sq_i + sq_j - 2 x x^T`` with ``sq`` the Gram matrix's own diagonal,
    as the kernel takes it, so the diagonal is exactly 0."""
    xf = x.float()
    g = xf @ xf.mT
    sq = g.diagonal(dim1=-2, dim2=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * g
    return d2.clamp_min(0.0)
