"""Shared neural-net layers (counterpart of ``repro.models.layers``): the
dense, norm, rope, attention, cache and MLP pieces every family of the
model zoo builds on.

Conventions, as in the reference:
  * parameters are nested dicts of tensors, dense weights ``[d_in, d_out]``;
    activations flow in ``cfg.dtype`` (bf16 by default) and parameters are
    cast on use; norms, softmax and rope run in float32;
  * attention layouts: q ``[B, S, H, Dh]``, k/v ``[B, S, KV, Dh]``;
  * decode caches are dicts of ``k`` and ``v`` ``[B, W, KV, Dh]``;
    positions are absolute; a sliding-window cache is a ring buffer of
    length ``window`` (position p at slot ``p % W``).

Ported: dense, norm (``rmsnorm`` | ``layernorm``, eps 1e-6 in float32),
rope (interleaved lane pairs), ``causal_attention`` (the plain
query-chunked path), the caches (``prefill_cache_write``,
``ring_cache_update``, ``decode_attention``, ``attn_cache_init``), the GQA
attention block in its three modes and as cross-attention, and the MLPs
(swiglu, geglu, gelu). The reference returns new caches; the port writes
into the preallocated ones in place (a decode step allocates no cache
memory) and returns them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

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


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """``[B, S, KV, Dh]`` -> ``[B, S, KV * n_rep, Dh]``, each KV head
    repeated for its ``n_rep`` query heads."""
    if n_rep == 1:
        return k
    b, s, kv, dh = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, dh).reshape(
        b, s, kv * n_rep, dh)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_offset: int, window: Optional[int] = None,
                     kv_len: Optional[int] = None,
                     chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, query-chunked so the
    logits never exceed ``[B, H, chunk, Sk]``; q ``[B, Sq, H, Dh]``, k/v
    ``[B, Sk, KV, Dh]`` (already roped), ``kv_len`` the valid keys
    (default Sk). Grouped-head contraction: K/V are never repeated over the
    query heads."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(dh)
    kv_len = sk if kv_len is None else kv_len
    kpos = torch.arange(sk, device=q.device)

    def attend(q_chunk: torch.Tensor, qpos: torch.Tensor) -> torch.Tensor:
        c = q_chunk.shape[1]
        qg = q_chunk.reshape(b, c, kv, rep, dh)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                              k.float()) * scale
        mask = kpos[None, :] <= qpos[:, None]
        mask &= kpos[None, :] < kv_len
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


def prefill_cache_write(cache: torch.Tensor, fresh: torch.Tensor,
                        window: Optional[int]) -> torch.Tensor:
    """Write a prefilled sequence of k or v (``[B, S, KV, Dh]``) into the
    preallocated ``cache`` (``[B, W, KV, Dh]``) in place; returns it.

    Full cache (``window`` None, W >= S): slots ``[0, S)``. Ring cache
    (W == window < S): the last W entries, position p at slot ``p % W``
    (the reference's ``roll`` of the last W by ``(S - W) % W``)."""
    s, w = fresh.shape[1], cache.shape[1]
    if s <= w:
        cache[:, :s].copy_(fresh)
    elif window is None:
        raise ValueError(f"a prompt of {s} positions does not fit a full "
                         f"cache of {w}")
    else:
        last = fresh[:, s - w:]
        shift = (s - w) % w
        cache[:, shift:].copy_(last[:, :w - shift])
        cache[:, :shift].copy_(last[:, w - shift:])
    return cache


def ring_cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, pos: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write one decode step's k/v (``[B, 1, KV, Dh]``) into the caches of
    length W at slot ``pos % W``, in place; returns the caches."""
    slot = int(pos) % cache_k.shape[1]
    cache_k[:, slot:slot + 1].copy_(k)
    cache_v[:, slot:slot + 1].copy_(v)
    return cache_k, cache_v


def decode_attention(q: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: int,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attention of the token at absolute position ``pos`` (q ``[B, 1, H,
    Dh]``) against a cache (``[B, W, KV, Dh]``), grouped-head contraction,
    float32 logits masked with -1e30. A full cache holds positions
    ``0..pos`` at their slots; a ring buffer (``window``) holds position p
    at slot ``p % W`` for p in ``(pos - W, pos]``, so slot s is valid when
    its age ``(pos % W - s) % W`` is at most ``min(pos, W - 1)``."""
    b, w, kv, dh = cache_k.shape
    sq, h = q.shape[1], q.shape[2]
    rep = h // kv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kv, rep, dh)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(),
                          cache_k.float()) * scale
    slots = torch.arange(w, device=q.device)
    if window is None:
        valid = slots <= pos
    else:
        age = (pos % w - slots) % w  # 0 = the newest entry
        valid = age <= min(pos, w - 1)
    logits = logits.masked_fill(~valid, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkge->bqgre", probs.to(q.dtype), cache_v)
    return out.reshape(b, sq, h, cache_v.shape[-1])


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
               pos: int = 0, cache: Optional[Dict] = None,
               kv_x: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA attention of ``x [B, S, d_model]``: ``(y, cache)``.

    ``kv_x`` makes it cross-attention: keys and values from ``kv_x`` (image
    or audio embeddings), no rope, no mask, float32 logits, in every mode.
    Otherwise self-attention at absolute positions ``pos + [0, S)``:

    * ``train``: no cache. ``cfg.use_flash_attention``: ``None`` takes the
      flash-attention kernels where they take the inputs (``flash.supports``:
      bfloat16, head dims 64, 80 and 128, those below 128 zero-padded to
      it, on the card) and the plain ``causal_attention`` elsewhere, a
      choice made before the call, as the
      reference takes its kernel only for what it runs; ``True`` asks for
      the kernel path (the plain dense version on the CPU) and raises on the
      card where the kernel cannot run; ``False`` is ``causal_attention``;
    * ``prefill``: ``causal_attention`` (the reference takes its kernel in
      train mode only), and k, v written into ``cache``;
    * ``decode`` (S = 1): k, v written at slot ``pos % W`` of ``cache``,
      then ``decode_attention`` over it.

    The cache is written in place and returned (``None`` in train mode and
    for cross-attention)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    cross = kv_x is not None
    src = kv_x if cross else x
    q = dense_apply(p["wq"], x).reshape(b, s, h, hd)
    k = dense_apply(p["wk"], src).reshape(b, src.shape[1], kvh, hd)
    v = dense_apply(p["wv"], src).reshape(b, src.shape[1], kvh, hd)
    if not cross:
        qpos = pos + torch.arange(s, device=x.device)
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)
    if mode != "train" and not cross and cache is None:
        raise ValueError(f"{mode} requires a preallocated cache")

    new_cache = None
    if cross:
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              _repeat_kv(k, h // kvh).float())
        probs = torch.softmax(logits / math.sqrt(hd), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype),
                           _repeat_kv(v, h // kvh))
    elif mode == "decode":
        ck, cv = ring_cache_update(cache["k"], cache["v"], k, v, pos)
        out = decode_attention(q, ck, cv, pos, window=cfg.sliding_window)
        new_cache = {"k": ck, "v": cv}
    else:
        flash = cfg.use_flash_attention if mode == "train" else False
        if flash is not False and q.is_cuda:
            why = FK.refusal(q, k, v, True, cfg.sliding_window, pos,
                             pad=True)
            if why is not None and flash:
                raise ValueError(f"use_flash_attention=True, but the flash "
                                 f"kernel cannot take these inputs: "
                                 f"{why[1]}")
            flash = why is None
        if flash:
            out = FA.flash_attention(q, k, v, causal=True,
                                     window=cfg.sliding_window, q_offset=pos)
        else:
            out = causal_attention(q, k, v, q_offset=pos,
                                   window=cfg.sliding_window)
        if mode == "prefill":
            new_cache = {
                "k": prefill_cache_write(cache["k"], k, cfg.sliding_window),
                "v": prefill_cache_write(cache["v"], v, cfg.sliding_window),
            }
    y = dense_apply(p["wo"], out.reshape(b, s, h * hd))
    return y, new_cache


def attn_cache_init(cfg, batch: int, max_len: int, dtype,
                    device=None) -> Dict:
    """Zero k and v caches ``[batch, W, KV, Dh]``: W = ``max_len``, or
    ``min(max_len, sliding_window)`` for a ring buffer."""
    hd = cfg.resolved_head_dim
    w = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (batch, w, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
