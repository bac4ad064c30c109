"""Plain PyTorch version of the flash-attention kernel: the dense masked
softmax of the reference's ``attention_ref``. Autograd gives its gradient."""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_mask(sq: int, sk: int, causal: bool, window: Optional[int],
                   q_offset: int, device) -> torch.Tensor:
    """``[sq, sk]`` bool: key j visible to query row i (absolute position
    ``q_offset + i``)."""
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q ``[B, Sq, H, D]``; k, v ``[B, Sk, KV, D]`` -> ``[B, Sq, H, D]``.
    Logits in float32, masked entries at -1e30 (a row with no visible key
    averages v), probabilities cast to q's dtype before the value product."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits / math.sqrt(d)
    mask = attention_mask(sq, sk, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)
