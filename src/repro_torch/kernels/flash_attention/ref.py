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


def _scaled(logits: torch.Tensor, d: int, scale: Optional[float]
            ) -> torch.Tensor:
    """Logits times the softmax scale: ``1/sqrt(D)`` (``scale`` None), or
    the given one (a head dim zero-padded to D keeps its own)."""
    return logits / math.sqrt(d) if scale is None else logits * scale


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """q ``[B, Sq, H, D]``; k, v ``[B, Sk, KV, D]`` -> ``[B, Sq, H, D]``.
    Logits in float32, masked entries at -1e30 (a row with no visible key
    averages v), probabilities cast to q's dtype before the value product.
    ``scale``: the softmax scale (default ``1/sqrt(D)``)."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = _scaled(logits, d, scale)
    mask = attention_mask(sq, sk, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype), v)


def _scores(q, k, causal, window, q_offset, scale=None):
    """Float32 ``[B, H, Sq, Sk]`` scaled logits (k repeated over its query
    heads) and the ``[Sq, Sk]`` visibility mask."""
    h, d = q.shape[2], q.shape[3]
    k = k.repeat_interleave(h // k.shape[2], dim=2)
    s = _scaled(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()), d,
                scale)
    return s, attention_mask(q.shape[1], k.shape[1], causal, window,
                             q_offset, q.device)


def attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, scale: Optional[float] = None):
    """What the forward kernel returns: ``(o, lse)``, ``o`` as
    :func:`attention_ref` and ``lse [B, H, Sq]`` the float32 natural-log
    sum of exponentials of each row's visible scaled logits."""
    s, mask = _scores(q, k, causal, window, q_offset, scale)
    lse = torch.logsumexp(s.masked_fill(~mask, -1e30), dim=-1)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale), lse


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                      *, causal: bool = True, window: Optional[int] = None,
                      q_offset: int = 0, scale: Optional[float] = None):
    """What the backward kernels compute, in float32 (FlashAttention-2):
    ``P = exp(S - lse)`` on visible keys, ``delta = rowsum(dO * O)``,
    ``dV = P^T dO``, ``dS = P (dO V^T - delta)``, ``dQ = dS K / sqrt(D)``,
    ``dK = dS^T Q / sqrt(D)`` (times ``scale`` where given), each key head
    summing its query heads. Returns ``(dq, dk, dv)`` in the dtypes of q,
    k, v."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    s, mask = _scores(q, k, causal, window, q_offset, scale)
    p = torch.exp(s - lse[..., None].float()) * mask
    do = dout.float()
    delta = (do * o.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    vr = v.repeat_interleave(rep, dim=2).float()
    kr = k.repeat_interleave(rep, dim=2).float()
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vr) - delta[..., None])
    dq = _scaled(torch.einsum("bhqk,bkhd->bqhd", ds, kr), d, scale)
    dk = _scaled(torch.einsum("bhqk,bqhd->bkhd", ds, q.float()), d, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)

    def per_kv_head(t):
        return t.reshape(b, sk, kv, rep, t.shape[-1]).sum(3)

    return (dq.to(q.dtype), per_kv_head(dk).to(k.dtype),
            per_kv_head(dv).to(v.dtype))
