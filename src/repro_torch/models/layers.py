"""Shared neural-net layers (counterpart of ``repro.models.layers``), the
train-mode subset the dense decoder needs.

Conventions, as in the reference:
  * parameters are nested dicts of tensors, dense weights ``[d_in, d_out]``;
    activations flow in ``cfg.dtype`` (bf16 by default) and parameters are
    cast on use; norms, softmax and rope run in float32;
  * attention layouts: q ``[B, S, H, Dh]``, k/v ``[B, S, KV, Dh]``.

Ported: dense, norm (``rmsnorm`` | ``layernorm``, eps 1e-6 in float32),
rope (interleaved lane pairs), ``causal_attention`` (the plain query-chunked
path), the GQA attention block in train mode (self-attention through the
flash-attention kernel path or the plain path) and the MLPs (swiglu, geglu,
gelu). Cross-attention (with ``_repeat_kv``), the decode ``kv_len`` and the
prefill/decode caches are still to port.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash as FK
from repro_torch.kernels.flash_attention import ops as FA

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def dense_init(gen: Optional[torch.Generator], d_in: int, d_out: int,
               scale: Optional[float] = None, bias: bool = False,
               device=None) -> Params:
    """N(0, scale^2) weights from ``gen`` (``None``: the default generator,
    for shape-only trees on the ``meta`` device), zero bias."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    dev = gen.device if device is None else device
    p = {"w": torch.randn((d_in, d_out), generator=gen, device=dev) * scale}
    if bias:
        p["b"] = torch.zeros((d_out,), device=dev)
    return p


def dense_apply(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    dtype = dtype or x.dtype
    y = x @ p["w"].to(dtype)
    if "b" in p:
        y = y + p["b"].to(dtype)
    return y


def norm_init(d: int, kind: str = "rmsnorm", device=None) -> Params:
    p = {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x ``[B, S, H, Dh]``; positions ``[B, S]`` or ``[S]``. Rotates the
    interleaved lane pairs ``(x[..., 0::2], x[..., 1::2])`` and interleaves
    them back, as the reference does (not the half split)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)  # [Dh/2]
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, S, Dh/2]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., 0::2], xf[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# attention core (the plain path; the flash kernel computes the same)
# --------------------------------------------------------------------------


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int, window: Optional[int] = None,
                     chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, query-chunked so the
    logits never exceed ``[B, H, chunk, Sk]``; q ``[B, Sq, H, Dh]``, k/v
    ``[B, Sk, KV, Dh]`` (already roped). Grouped-head contraction: K/V are
    never repeated over the query heads."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(dh)
    kpos = torch.arange(sk, device=q.device)

    def attend(q_chunk: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        c = q_chunk.shape[1]
        qg = q_chunk.reshape(b, c, kv, rep, dh)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                              k.float()) * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bgrqk,bkge->bqgre", probs.to(q.dtype), v)
        return out.reshape(b, c, h, v.shape[-1])

    ar = torch.arange(min(sq, chunk), device=q.device)
    if sq <= chunk:
        return attend(q, q_offset + ar)
    if sq % chunk:
        raise ValueError(f"sq={sq} is not a multiple of chunk={chunk}")
    return torch.cat([attend(q[:, i:i + chunk], q_offset + i + ar)
                      for i in range(0, sq, chunk)], dim=1)


# --------------------------------------------------------------------------
# GQA/MQA attention block
# --------------------------------------------------------------------------


def attn_init(gen: torch.Generator, cfg, device=None) -> Params:
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd,
                         bias=cfg.qkv_bias, device=device),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, device=device),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd,
                         bias=cfg.qkv_bias, device=device),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, device=device),
    }


def attn_apply(p: Params, cfg, x: torch.Tensor, *, mode: str = "train",
               pos: int = 0) -> torch.Tensor:
    """Train-mode GQA self-attention of ``x [B, S, d_model]``.

    ``cfg.use_flash_attention``: ``None`` takes the flash-attention kernels
    where they take the inputs (``flash.supports``: bfloat16, head dims 64,
    80 and 128, on the card) and the plain ``causal_attention`` elsewhere, a
    choice made before the call, as the reference takes its kernel only for
    what it runs; ``True`` asks for the kernel path (the plain dense version
    on the CPU) and raises on the card where the kernel cannot run; ``False``
    is ``causal_attention``."""
    if mode != "train":
        raise ValueError(f"attention mode {mode!r} is not ported (train "
                         f"only; the prefill and decode caches wait)")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    q = dense_apply(p["wq"], x).reshape(b, s, h, hd)
    k = dense_apply(p["wk"], x).reshape(b, s, kvh, hd)
    v = dense_apply(p["wv"], x).reshape(b, s, kvh, hd)
    qpos = pos + torch.arange(s, device=x.device)
    q = apply_rope(q, qpos, cfg.rope_theta)
    k = apply_rope(k, qpos, cfg.rope_theta)
    flash = cfg.use_flash_attention
    if flash is not False and q.is_cuda:
        why = FK.refusal(q, k, v, True, cfg.sliding_window, pos)
        if why is not None and flash:
            raise ValueError(f"use_flash_attention=True, but the flash "
                             f"kernel cannot take these inputs: {why[1]}")
        flash = why is None
    if flash:
        out = FA.flash_attention(q, k, v, causal=True,
                                 window=cfg.sliding_window, q_offset=pos)
    else:
        out = causal_attention(q, k, v, q_offset=pos,
                               window=cfg.sliding_window)
    return dense_apply(p["wo"], out.reshape(b, s, h * hd))


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             kind: str = "swiglu", device=None) -> Params:
    if kind in ("swiglu", "geglu"):
        return {"wi": dense_init(gen, d_model, d_ff, device=device),
                "wg": dense_init(gen, d_model, d_ff, device=device),
                "wo": dense_init(gen, d_ff, d_model, device=device)}
    return {"wi": dense_init(gen, d_model, d_ff, device=device),
            "wo": dense_init(gen, d_ff, d_model, device=device)}


def mlp_apply(p: Params, x: torch.Tensor, kind: str = "swiglu"
              ) -> torch.Tensor:
    if kind == "swiglu":
        a = F.silu(dense_apply(p["wg"], x))
        return dense_apply(p["wo"], a * dense_apply(p["wi"], x))
    if kind == "geglu":
        a = F.gelu(dense_apply(p["wg"], x), approximate="tanh")
        return dense_apply(p["wo"], a * dense_apply(p["wi"], x))
    return dense_apply(p["wo"],
                       F.gelu(dense_apply(p["wi"], x), approximate="tanh"))
