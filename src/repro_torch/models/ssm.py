"""Mamba2 / SSD block (state-space duality; counterpart of
``repro.models.ssm``).

Train and prefill run the chunked SSD: within a chunk the attention-like
quadratic term, across chunks a recurrence over the chunk states (a loop
over chunks). Decode advances the recurrence one token, keeping an ``[B,
H, P, N]`` state and the depthwise convolution's last ``W - 1``
pre-activation inputs in the cache.

Layout: x ``[B, S, D]``; the input projection gives z (gate) ``[B, S,
d_inner]``, the SSM input ``[B, S, H, P]`` (``d_inner = H * P``), B and C
``[B, S, G, N]`` (G groups, N = ``ssm_state``) and dt ``[B, S, H]``.

The reference's four-operand contractions are written as products of two
operands at a time, each a batched matrix product or an elementwise
product, so nothing larger than ``[B, NC, L, L, H]`` is built (a
left-to-right einsum of the four can build ``[B, NC, L, L, H, P]``). The
intra-chunk decay ``exp(cum_i - cum_j)`` is taken on the causal entries
only (the others are ``exp(-inf) = 0``), where the reference takes it
everywhere and then zeroes the upper triangle: the same values, and no
overflow into the gradient at long chunks.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]


def ssm_init(gen: Optional[torch.Generator], cfg, device=None) -> Params:
    """The Mamba2 block's parameters; ``dt_bias`` is the inverse softplus
    of log-uniform draws in ``[1e-3, 1e-1]`` (the mamba2 init), ``A_log``
    ``log(1..H)``, ``D`` ones."""
    d, di = cfg.d_model, cfg.ssm_d_inner
    h, g, n = cfg.ssm_n_heads, cfg.ssm_n_groups, cfg.ssm_state
    conv_dim = di + 2 * g * n
    dev = gen.device if device is None else device
    in_proj = L.dense_init(gen, d, 2 * di + 2 * g * n + h, device=dev)
    conv_w = torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                         device=dev) / math.sqrt(cfg.ssm_conv_width)
    u = torch.rand((h,), generator=gen, device=dev)
    dt0 = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.arange(1, h + 1, dtype=torch.float32,
                                        device=dev)),
        "dt_bias": dt0 + torch.log(-torch.expm1(-dt0)),  # inverse softplus
        "D": torch.ones((h,), device=dev),
        "norm": L.norm_init(di, device=dev),
        "out_proj": L.dense_init(gen, di, d, device=dev),
    }


def _split_proj(cfg, proj: torch.Tensor):
    """``proj -> (z [.., d_inner], xBC [.., d_inner + 2GN], dt [.., H])``."""
    di, g, n = cfg.ssm_d_inner, cfg.ssm_n_groups, cfg.ssm_state
    return proj.split([di, di + 2 * g * n, cfg.ssm_n_heads], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d with SiLU: ``xbc [B, S, C]``, ``w [W, C]``.
    Returns ``(y, new_state)``: ``new_state`` is the trailing ``W - 1``
    inputs (before the convolution) of ``state`` then ``xbc``, what decode
    continues from. The W taps are summed in float32 and rounded once."""
    bsz, s, c = xbc.shape
    wlen = w.shape[0]
    if state is None:
        state = xbc.new_zeros((bsz, wlen - 1, c))
    dt = torch.promote_types(state.dtype, xbc.dtype)
    ext = torch.cat([state.to(dt), xbc.to(dt)], dim=1)       # [B, W-1+S, C]
    wf = w.to(xbc.dtype).float()
    y = ext[:, 0:s].float() * wf[0]
    for j in range(1, wlen):
        y = y + ext[:, j:j + s].float() * wf[j]
    y = F.silu(y.to(dt) + b.to(xbc.dtype))
    new_state = ext[:, ext.shape[1] - (wlen - 1):] if wlen > 1 else state
    return y, new_state


def _heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """``[.., G, ...]`` on axis -1 of groups -> heads: group ``g`` serves
    heads ``g * rep .. g * rep + rep - 1`` (``jnp.repeat``)."""
    if rep == 1:
        return t
    if t.shape[-1] == 1:
        return t.expand(t.shape[:-1] + (rep,))
    return t.repeat_interleave(rep, dim=-1)


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in float32.

    ``xh [B, S, H, P]``; ``dt [B, S, H]`` (after softplus, > 0); ``A [H]``
    (negative); ``Bm``, ``Cm [B, S, G, N]``; ``init_state [B, H, P, N]`` or
    ``None``; S a multiple of ``chunk``. Returns ``(y [B, S, H, P]`` in
    xh's dtype, ``final_state [B, H, P, N]`` float32)."""
    bsz, s, h, p = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc, rep = s // chunk, h // g
    xc = xh.reshape(bsz, nc, chunk, h, p).float()
    dtc = dt.reshape(bsz, nc, chunk, h).float()
    Bc = Bm.reshape(bsz, nc, chunk, g, n).float()
    Cc = Cm.reshape(bsz, nc, chunk, g, n).float()

    da = dtc * A                                   # [B, NC, L, H] (negative)
    cum = da.cumsum(dim=2)                         # within-chunk decay

    # intra-chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    idx = torch.arange(chunk, device=xh.device)
    causal = (idx[:, None] >= idx[None, :])[:, :, None]           # [L, L, 1]
    seg = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :])
                    .masked_fill(~causal, float("-inf")))      # [B,NC,L,L,H]
    cb = torch.einsum("bclgn,bcsgn->bclsg", Cc, Bc)            # [B,NC,L,L,G]
    w = _heads(cb, rep) * seg
    u = dtc[..., None] * xc                                    # [B,NC,L,H,P]
    y_diag = torch.einsum("bclsh,bcshp->bclhp", w, u)
    del seg, cb, w

    # chunk states: sum_j exp(cum_last - cum_j) dt_j B_j x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)          # [B,NC,L,H]
    ax = (decay_to_end * dtc)[..., None] * xc                  # [B,NC,L,H,P]
    states = torch.einsum("bclgrp,bclgn->bcgrpn",
                          ax.reshape(bsz, nc, chunk, g, rep, p), Bc
                          ).reshape(bsz, nc, h, p, n)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da.sum(dim=2))                     # [B, NC, H]
    carry = (xh.new_zeros((bsz, h, p, n), dtype=torch.float32)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [B,NC,H,P,N]

    # the incoming state's contribution: C_i . state * exp(cum_i)
    y_off = torch.einsum("bclgn,bcgrpn->bclgrp", Cc, prev_states.reshape(
        bsz, nc, g, rep, p, n)).reshape(bsz, nc, chunk, h, p)
    y_off = y_off * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    return y.to(xh.dtype), carry


def ssm_apply(p: Params, cfg, x: torch.Tensor, *, mode: str = "train",
              cache: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The Mamba2 block of ``x [B, S, D]``: ``(out, cache)``. ``train`` and
    ``prefill`` run the chunked SSD over the sequence (the tail padded to a
    whole chunk with dt = 0: decay 1, no input, outputs dropped);
    ``prefill`` writes the final state and the conv state into ``cache``;
    ``decode`` (S = 1) advances the cached state one token, which is kept
    in the cache's dtype (rounded each step, as the reference's). Caches
    are written in place and returned (``None`` in train mode)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown ssm mode {mode!r}")
    if mode != "train" and cache is None:
        raise ValueError(f"{mode} requires a preallocated cache")
    bsz, s, _ = x.shape
    h, pdim = cfg.ssm_n_heads, cfg.ssm_head_dim
    g, n, di = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_d_inner
    z, xbc, dt = _split_proj(cfg, L.dense_apply(p["in_proj"], x))
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    conv_state = cache.get("conv") if cache else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xh, Bm, Cm = xbc.split([di, g * n, g * n], dim=-1)
    xh = xh.reshape(bsz, s, h, pdim)
    Bm = Bm.reshape(bsz, s, g, n)
    Cm = Cm.reshape(bsz, s, g, n)

    if mode == "decode":
        if s != 1:
            raise ValueError(f"decode takes one token, got S={s}")
        st = cache["state"].float()                            # [B,H,P,N]
        dtv = dt[:, 0]                                         # [B, H]
        dec = torch.exp(dtv * A)
        Bv = Bm[:, 0].float().repeat_interleave(h // g, dim=1)  # [B, H, N]
        Cv = Cm[:, 0].float().repeat_interleave(h // g, dim=1)
        xv = xh[:, 0].float()                                  # [B, H, P]
        new_state = (st * dec[:, :, None, None]
                     + (dtv[:, :, None] * xv)[..., None] * Bv[:, :, None, :])
        y = torch.einsum("bhn,bhpn->bhp", Cv, new_state)[:, None]
        cache["state"].copy_(new_state)
        cache["conv"].copy_(new_conv)
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        if pad:
            def zf(a):
                return F.pad(a, (0, 0) * (a.ndim - 2) + (0, pad))
            y, final = ssd_chunked(zf(xh), zf(dt), A, zf(Bm), zf(Cm), chunk)
            y = y[:, :s]
        else:
            y, final = ssd_chunked(xh, dt, A, Bm, Cm, chunk)
        y = y.to(x.dtype)
        if mode == "prefill":
            cache["state"].copy_(final)
            cache["conv"].copy_(new_conv)

    y = y.float() + p["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = y * F.silu(z)
    y = L.norm_apply(p["norm"], y)
    return L.dense_apply(p["out_proj"], y), (cache if mode != "train"
                                              else None)


def ssm_cache_init(cfg, batch: int, dtype, device=None) -> Dict:
    """Zero decode caches: ``state [batch, H, P, N]`` and ``conv [batch, W
    - 1, d_inner + 2GN]``."""
    h, pdim, n = cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.ssm_d_inner + 2 * cfg.ssm_n_groups * cfg.ssm_state
    return {
        "state": torch.zeros((batch, h, pdim, n), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }
