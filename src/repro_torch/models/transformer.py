"""The decoder stack (counterpart of ``repro.models.transformer``), all six
families:

  dense / audio : L x (norm -> attention -> residual -> norm -> MLP ->
                  residual)
  moe           : first_k_dense x (attention + MLP), then the rest
                  (attention or MLA + MoE)
  ssm           : L x mamba2
  hybrid        : G x (attn_every x mamba2 + ONE weight-shared attention
                  block), then the L mod attn_every trailing mamba2 blocks
  vlm           : G x ((cross_attn_every - 1) x self-attention block + 1
                  gated cross-attention block over the image embeddings),
                  then the trailing self-attention blocks

then a final norm, the LM head and the chunked cross entropy. ``forward``
runs in ``train``, ``prefill`` and ``decode`` mode; the caches are stacked
as the parameters that own them (the hybrid's shared block owns one cache
for each of its G applications, ``[G, ...]``).

The layers' parameters are stacked on a leading layer axis (``[g, per,
...]`` for grouped blocks), as the reference stacks them for its
``lax.scan``, so the flat parameter vector has the reference's layout; the
port runs the stack as a Python loop. The reference rematerialises every
scan body (``jax.checkpoint``); the port keeps the activations instead: at
a few layers they are small beside the server's ``[n, D]`` banks, and only
one worker's are alive at a time.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import tree_leaves, tree_map

Params = Dict[str, Any]

FAMILIES = ("dense", "audio", "moe", "ssm", "hybrid", "vlm")
MODES = ("train", "prefill", "decode")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (known: "
                         f"{', '.join(FAMILIES)})")


def _vlm_groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """``(groups, self-attention blocks a group, trailing blocks)``."""
    cae = cfg.cross_attn_every
    g = cfg.n_layers // cae
    return g, cae - 1, cfg.n_layers - g * cae


def _hybrid_groups(cfg: ModelConfig) -> Tuple[int, int, int]:
    """``(groups, mamba2 blocks a group, trailing mamba2 blocks)``: each
    group ends with the shared attention block."""
    ae = cfg.attn_every
    g = cfg.n_layers // ae
    return g, ae, cfg.n_layers - g * ae


# --------------------------------------------------------------------------
# single blocks
# --------------------------------------------------------------------------


def _attn_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                     device=None, use_moe: bool = False) -> Params:
    """Norms, attention (MLA where ``cfg.use_mla``) and an MLP, or the MoE
    layer with ``use_moe``."""
    p = {"norm1": L.norm_init(cfg.d_model, cfg.norm, device=device),
         "norm2": L.norm_init(cfg.d_model, cfg.norm, device=device),
         "attn": (MLA.mla_init(gen, cfg, device=device) if cfg.use_mla
                  else L.attn_init(gen, cfg, device=device))}
    if use_moe:
        p["moe"] = MOE.moe_init(gen, cfg, device=device)
    else:
        p["mlp"] = L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                              device=device)
    return p


def _attn_block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                      mode: str, pos: int, cache: Optional[Dict]
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(x, aux)``: the block's output and its MoE loss (``None`` for an
    MLP block)."""
    h = L.norm_apply(p["norm1"], x, cfg.norm)
    if cfg.use_mla:
        a, _ = MLA.mla_apply(p["attn"], cfg, h, mode=mode, pos=pos,
                             cache=cache)
    else:
        a, _ = L.attn_apply(p["attn"], cfg, h, mode=mode, pos=pos,
                            cache=cache)
    x = x + a
    h = L.norm_apply(p["norm2"], x, cfg.norm)
    if "moe" in p:
        m, aux = MOE.moe_apply(p["moe"], cfg, h)
        return x + m, aux
    return x + L.mlp_apply(p["mlp"], h, cfg.mlp), None


def _cross_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                      device=None) -> Params:
    p = _attn_block_init(gen, cfg, device=device)
    p["gate"] = torch.zeros((), device=device)  # tanh-gated, llama-3.2 style
    return p


def _cross_block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor,
                       kv_x: torch.Tensor) -> torch.Tensor:
    h = L.norm_apply(p["norm1"], x, cfg.norm)
    a, _ = L.attn_apply(p["attn"], cfg, h, kv_x=kv_x)
    x = x + torch.tanh(p["gate"]).to(x.dtype) * a
    h = L.norm_apply(p["norm2"], x, cfg.norm)
    return x + L.mlp_apply(p["mlp"], h, cfg.mlp)


def _ssm_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                    device=None) -> Params:
    return {"norm": L.norm_init(cfg.d_model, cfg.norm, device=device),
            "ssm": SSM.ssm_init(gen, cfg, device=device)}


def _ssm_block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                     mode: str, cache: Optional[Dict]) -> torch.Tensor:
    h = L.norm_apply(p["norm"], x, cfg.norm)
    y, _ = SSM.ssm_apply(p["ssm"], cfg, h, mode=mode, cache=cache)
    return x + y


# --------------------------------------------------------------------------
# stacked init
# --------------------------------------------------------------------------


def _stacked(make: Callable[[], Params], n: int) -> Optional[Params]:
    """``n`` blocks of ``make()`` stacked on a leading axis (``None`` for
    none): each stacked leaf allocated once from the first block's leaves,
    then every block drawn fresh, in order, and copied into its slot
    (stacking ``n`` fresh blocks would hold the blocks twice; this holds the
    stack and one block)."""
    if n == 0:
        return None
    stacked = None
    for i in range(n):
        block = make()
        if stacked is None:
            stacked = tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)),
                               block)
        for s, a in zip(tree_leaves(stacked), tree_leaves(block)):
            s[i].copy_(a)
        del block, s, a  # free block i before block i + 1 is drawn
    return stacked


def _grouped(stacked: Optional[Params], g: int, per: int
             ) -> Optional[Params]:
    """A stack of ``g * per`` blocks as ``[g, per, ...]``."""
    if stacked is None:
        return None
    return tree_map(lambda a: a.reshape((g, per) + a.shape[1:]), stacked)


def model_init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Params:
    """Random float32 parameters from ``generator`` on ``device`` (default:
    the generator's device), each stacked leaf allocated once. The draws
    differ from the reference's (its threefry keys); tests carry the
    reference's parameters across with
    ``repro_torch.testing.from_jax_params``. ``generator=None`` with
    ``device="meta"`` gives a shape-only tree."""
    _check_family(cfg)
    dev = torch.device(device if device is not None else generator.device)
    p: Params = {}
    if cfg.input_kind == "tokens":
        p["embed"] = torch.randn((cfg.vocab_size, cfg.d_model),
                                 generator=generator, device=dev) * 0.02
    p["final_norm"] = L.norm_init(cfg.d_model, cfg.norm, device=dev)
    if not cfg.tie_embeddings or cfg.input_kind != "tokens":
        p["lm_head"] = torch.randn((cfg.d_model, cfg.vocab_size),
                                   generator=generator, device=dev) * 0.02

    def block(use_moe=False):
        return _attn_block_init(generator, cfg, device=dev, use_moe=use_moe)

    def ssm_block():
        return _ssm_block_init(generator, cfg, device=dev)

    fam = cfg.family
    if fam in ("dense", "audio"):
        p["blocks"] = _stacked(block, cfg.n_layers)
    elif fam == "moe":
        fk = cfg.first_k_dense
        p["dense_blocks"] = _stacked(block, fk)
        p["blocks"] = _stacked(lambda: block(use_moe=True),
                               cfg.n_layers - fk)
    elif fam == "ssm":
        p["blocks"] = _stacked(ssm_block, cfg.n_layers)
    elif fam == "hybrid":
        g, ae, rem = _hybrid_groups(cfg)
        p["blocks"] = _grouped(_stacked(ssm_block, g * ae), g, ae)
        p["tail_blocks"] = _stacked(ssm_block, rem)
        p["shared_attn"] = block()
    else:  # vlm
        g, per, rem = _vlm_groups(cfg)
        p["blocks"] = _grouped(_stacked(block, g * per), g, per)
        p["cross_blocks"] = _stacked(
            lambda: _cross_block_init(generator, cfg, device=dev), g)
        p["tail_blocks"] = _stacked(block, rem)
    return p


# --------------------------------------------------------------------------
# cache init
# --------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device=None) -> Dict:
    """Zero decode caches, stacked as the blocks that own them (``None``
    where a stack has no block; ``dtype`` defaults to ``cfg.dtype``):

    * dense, audio: ``{"blocks": {"k", "v"}}``, leaves ``[L, batch, W, KV,
      Dh]``; the vlm: ``[g, per, ...]`` and ``"tail_blocks"``;
    * moe: ``"dense_blocks"`` and ``"blocks"``, the latent caches ``{"ckv",
      "krope"}`` under MLA;
    * ssm: ``{"blocks": {"state", "conv"}}``;
    * hybrid: the mamba2 caches ``[g, attn_every, ...]`` and
      ``"tail_blocks"``, and the shared block's ``"shared_attn"`` ``{"k",
      "v"}`` ``[g, ...]``, one for each application."""
    _check_family(cfg)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    gqa = L.attn_cache_init(cfg, batch, max_len, dtype, device="meta")
    attn = (MLA.mla_cache_init(cfg, batch, max_len, dtype, device="meta")
            if cfg.use_mla else gqa)
    ssm = SSM.ssm_cache_init(cfg, batch, dtype, device="meta")

    def stacked(one, *lead):
        if 0 in lead:
            return None
        return {k: torch.zeros(lead + tuple(a.shape), dtype=dtype,
                               device=device) for k, a in one.items()}

    fam = cfg.family
    if fam == "vlm":
        g, per, rem = _vlm_groups(cfg)
        return {"blocks": stacked(attn, g, per),
                "tail_blocks": stacked(attn, rem)}
    if fam == "moe":
        fk = cfg.first_k_dense
        return {"dense_blocks": stacked(attn, fk),
                "blocks": stacked(attn, cfg.n_layers - fk)}
    if fam == "ssm":
        return {"blocks": stacked(ssm, cfg.n_layers)}
    if fam == "hybrid":
        g, ae, rem = _hybrid_groups(cfg)
        return {"blocks": stacked(ssm, g, ae), "shared_attn": stacked(gqa, g),
                "tail_blocks": stacked(ssm, rem)}
    return {"blocks": stacked(attn, cfg.n_layers)}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, mode: str = "train", pos: int = 0,
            caches: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Optional[Dict], Dict[str, torch.Tensor]]:
    """Run the decoder stack.

    ``batch``: ``{"tokens": [B, S]}`` or ``{"embeddings": [B, S, D]}``; the
    vlm adds ``{"image_embeddings": [B, T_img, D]}``. ``prefill`` and
    ``decode`` write the positions ``pos + [0, S)`` into ``caches`` (from
    :func:`cache_init`) in place.

    Returns ``(hidden [B, S, D], caches, {"moe_loss"})``: the caches given
    (``None`` in train mode); ``moe_loss`` is the MoE layers' aux losses
    summed (float32; 0 without MoE layers)."""
    _check_family(cfg)
    if mode not in MODES:
        raise ValueError(f"unknown forward mode {mode!r} (expected one of "
                         f"{MODES})")
    if mode != "train" and caches is None:
        raise ValueError(f"{mode} requires preallocated caches")
    dtype = getattr(torch, cfg.dtype)
    if cfg.input_kind == "tokens":
        # F.embedding: its CUDA backward is deterministic (sorted), where
        # the backward of an indexing gather adds with atomics
        x = F.embedding(batch["tokens"], params["embed"].to(dtype))
        if cfg.family == "dense" and cfg.tie_embeddings:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(dtype)
    else:
        x = batch["embeddings"].to(dtype)
    cc = caches if mode != "train" else {}
    moe_loss = torch.zeros((), device=x.device)

    def at(stack, i):
        return None if stack is None else tree_map(lambda a: a[i], stack)

    def self_block(stack, i, x, cache_stack):
        nonlocal moe_loss
        x, aux = _attn_block_apply(at(stack, i), cfg, x, mode=mode, pos=pos,
                                   cache=at(cache_stack, i))
        if aux is not None:
            moe_loss = moe_loss + aux
        return x

    def ssm_block(stack, i, x, cache_stack):
        return _ssm_block_apply(at(stack, i), cfg, x, mode=mode,
                                cache=at(cache_stack, i))

    fam = cfg.family
    if fam in ("dense", "audio"):
        for i in range(cfg.n_layers):
            x = self_block(params["blocks"], i, x, cc.get("blocks"))
    elif fam == "moe":
        fk = cfg.first_k_dense
        for i in range(fk):
            x = self_block(params["dense_blocks"], i, x,
                           cc.get("dense_blocks"))
        for i in range(cfg.n_layers - fk):
            x = self_block(params["blocks"], i, x, cc.get("blocks"))
    elif fam == "ssm":
        for i in range(cfg.n_layers):
            x = ssm_block(params["blocks"], i, x, cc.get("blocks"))
    elif fam == "hybrid":
        g, ae, rem = _hybrid_groups(cfg)
        for gi in range(g):
            for j in range(ae):
                x = ssm_block(params["blocks"], (gi, j), x, cc.get("blocks"))
            x, _ = _attn_block_apply(params["shared_attn"], cfg, x,
                                     mode=mode, pos=pos,
                                     cache=at(cc.get("shared_attn"), gi))
        for i in range(rem):
            x = ssm_block(params["tail_blocks"], i, x, cc.get("tail_blocks"))
    else:  # vlm
        kv_img = batch["image_embeddings"].to(dtype)
        g, per, rem = _vlm_groups(cfg)
        for gi in range(g):
            for j in range(per):
                x = self_block(params["blocks"], (gi, j), x, cc.get("blocks"))
            x = _cross_block_apply(at(params["cross_blocks"], gi), cfg, x,
                                   kv_img)
        for i in range(rem):
            x = self_block(params["tail_blocks"], i, x,
                           cc.get("tail_blocks"))
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return x, (caches if mode != "train" else None), {"moe_loss": moe_loss}


# --------------------------------------------------------------------------
# heads & losses
# --------------------------------------------------------------------------


def logits_fn(params: Params, cfg: ModelConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings and "embed" in params:
        w = params["embed"].T
    else:
        w = params["lm_head"]
    return hidden @ w.to(hidden.dtype)


def _chunk_nll(params, cfg, h, t, m) -> torch.Tensor:
    logits = logits_fn(params, cfg, h).float()
    ll = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(ll, -1, t[..., None].long())[..., 0]
    return (nll * m).sum()


def chunked_xent(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
                 targets: torch.Tensor,
                 loss_mask: Optional[torch.Tensor] = None,
                 chunk: int = 512) -> torch.Tensor:
    """Next-token cross entropy with the LM head applied per sequence chunk,
    so ``[B, S, V]`` logits never materialise (the last chunk zero-padded,
    as the reference pads it)."""
    b, s, d = hidden.shape
    if loss_mask is None:
        loss_mask = torch.ones((b, s), dtype=torch.float32,
                               device=hidden.device)
    denom = loss_mask.sum().clamp_min(1.0)
    if s <= chunk:
        return _chunk_nll(params, cfg, hidden, targets, loss_mask) / denom
    pad = (-s) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        loss_mask = F.pad(loss_mask, (0, pad))
        s += pad
    per_chunk = [_chunk_nll(params, cfg, hidden[:, i:i + chunk],
                            targets[:, i:i + chunk],
                            loss_mask[:, i:i + chunk])
                 for i in range(0, s, chunk)]
    return torch.stack(per_chunk).sum() / denom


def lm_loss(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            moe_loss_weight: float = 0.01) -> torch.Tensor:
    """Causal-LM loss over ``batch["tokens"]`` shifted by one, or over the
    given ``batch["targets"]`` (with an optional ``loss_mask``) for
    embedding-input models, plus ``moe_loss_weight`` times the MoE layers'
    aux loss."""
    hidden, _, aux = forward(params, cfg, batch, mode="train")
    if "targets" in batch:
        loss = chunked_xent(params, cfg, hidden, batch["targets"],
                            batch.get("loss_mask"))
    else:
        loss = chunked_xent(params, cfg, hidden[:, :-1],
                            batch["tokens"][:, 1:])
    return loss + moe_loss_weight * aux["moe_loss"]
