"""Multi-head Latent Attention (DeepSeek-V2; counterpart of
``repro.models.mla``).

Keys and values are compressed into a per-token latent ``ckv`` of rank
``kv_lora_rank`` (normed) plus one roped key ``krope`` shared by the heads;
the decode cache holds only those, ``[B, S, r]`` and ``[B, S, rope]``.
Train and prefill expand the latents into per-head keys (qk dim ``nope +
rope``) and values (``v_head_dim``) and take the plain causal attention
(MLA never reaches the flash kernel, in the reference either). Decode runs
absorbed: ``W_uk`` folded into the query and ``W_uv`` into the output, so
the step attends in the rank-r latent space, with float32 logits where the
reference asks for them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def mla_init(gen: Optional[torch.Generator], cfg, device=None) -> Params:
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    return {
        "wq": L.dense_init(gen, d, h * qd, device=device),
        "wdkv": L.dense_init(gen, d, r + cfg.qk_rope_head_dim, device=device),
        "kv_norm": L.norm_init(r, device=device),
        "wukv": L.dense_init(gen, r, h * (cfg.qk_nope_head_dim
                                          + cfg.v_head_dim), device=device),
        "wo": L.dense_init(gen, h * cfg.v_head_dim, d, device=device),
    }


def _expand_kv(p: Params, cfg, ckv: torch.Tensor, k_rope: torch.Tensor,
               dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ckv [B, S, r]`` (normed), ``k_rope [B, S, rope]`` (roped) ->
    ``k [B, S, H, nope + rope]``, ``v [B, S, H, vd]``."""
    b, s, _ = ckv.shape
    h, nope, vd = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    kv = L.dense_apply(p["wukv"], ckv, dtype=dtype).reshape(b, s, h,
                                                            nope + vd)
    k_nope, v = kv.split([nope, vd], dim=-1)
    k_r = k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_head_dim)
    return torch.cat([k_nope, k_r.to(k_nope.dtype)], dim=-1), v


def mla_apply(p: Params, cfg, x: torch.Tensor, *, mode: str = "train",
              pos: int = 0, cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """MLA of ``x [B, S, d_model]`` at positions ``pos + [0, S)``: ``(y,
    cache)``. ``prefill`` writes the prompt's latents at ``[0, S)`` of the
    preallocated ``cache``, ``decode`` (S = 1) the token's at slot ``pos``,
    in place; the cache is returned (``None`` in train mode)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode != "train" and cache is None:
        raise ValueError(f"{mode} requires a preallocated cache")
    b, s, _ = x.shape
    h, r = cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, \
        cfg.v_head_dim
    qd = nope + rope

    q = L.dense_apply(p["wq"], x).reshape(b, s, h, qd)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    qpos = pos + torch.arange(s, device=x.device)
    q_rope = L.apply_rope(q_rope, qpos, cfg.rope_theta)

    ckv, k_rope = L.dense_apply(p["wdkv"], x).split([r, rope], dim=-1)
    ckv = L.norm_apply(p["kv_norm"], ckv)
    k_rope = L.apply_rope(k_rope[:, :, None, :], qpos, cfg.rope_theta)[:, :, 0]

    new_cache = None
    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token, got S={s}")
        cache["ckv"][:, pos:pos + 1].copy_(ckv)
        cache["krope"][:, pos:pos + 1].copy_(k_rope)
        wukv = p["wukv"]["w"].to(x.dtype).reshape(r, h, nope + vd)
        wuk, wuv = wukv[:, :, :nope], wukv[:, :, nope:]
        q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope, wuk)
        ck = cache["ckv"].to(x.dtype)
        kr = cache["krope"].to(x.dtype)
        logits = (torch.einsum("bqhr,bsr->bhqs", q_lat.float(), ck.float())
                  + torch.einsum("bqhp,bsp->bhqs", q_rope.float(),
                                 kr.float()))
        logits = logits / math.sqrt(qd)
        valid = torch.arange(ck.shape[1], device=x.device) <= pos
        probs = torch.softmax(logits.masked_fill(~valid, -1e30), dim=-1)
        lat = torch.einsum("bhqs,bsr->bqhr", probs.to(x.dtype), ck)
        out = torch.einsum("bqhr,rhv->bqhv", lat, wuv)
        new_cache = cache
    else:
        k, v = _expand_kv(p, cfg, ckv, k_rope, x.dtype)
        out = L.causal_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                                 q_offset=pos, window=cfg.sliding_window)
        if mode == "prefill":
            cache["ckv"][:, :s].copy_(ckv)
            cache["krope"][:, :s].copy_(k_rope)
            new_cache = cache
    y = L.dense_apply(p["wo"], out.reshape(b, s, h * vd))
    return y, new_cache


def mla_cache_init(cfg, batch: int, max_len: int, dtype,
                   device=None) -> Dict:
    """Zero latent caches: ``ckv [batch, max_len, r]``, ``krope [batch,
    max_len, rope]``."""
    return {
        "ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, max_len, cfg.qk_rope_head_dim),
                             dtype=dtype, device=device),
    }
