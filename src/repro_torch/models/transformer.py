"""The decoder stack (counterpart of ``repro.models.transformer``), the
``dense`` family in train mode: ``L x (norm -> attention -> residual ->
norm -> MLP -> residual)``, a final norm, the LM head and the chunked
cross entropy.

The layers' parameters are stacked on a leading layer axis, as the
reference stacks them for its ``lax.scan``, so the flat parameter vector has
the reference's layout; the port runs the stack as a Python loop. The
reference rematerialises every scan body (``jax.checkpoint``); the port
keeps the activations instead: at 2 layers they are small beside the
server's ``[n, D]`` banks, and only one worker's are alive at a time.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

Params = Dict[str, Any]

PORTED_FAMILIES = ("dense",)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES or cfg.input_kind != "tokens" \
            or cfg.use_mla or cfg.n_experts:
        raise ValueError(
            f"model family {cfg.family!r} is not ported (ported: dense "
            f"decoders on token inputs)")


def _attn_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                     device=None) -> Params:
    return {"norm1": L.norm_init(cfg.d_model, cfg.norm, device=device),
            "norm2": L.norm_init(cfg.d_model, cfg.norm, device=device),
            "attn": L.attn_init(gen, cfg, device=device),
            "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                              device=device)}


def _attn_block_apply(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                      pos: int = 0) -> torch.Tensor:
    h = L.norm_apply(p["norm1"], x, cfg.norm)
    x = x + L.attn_apply(p["attn"], cfg, h, mode="train", pos=pos)
    h = L.norm_apply(p["norm2"], x, cfg.norm)
    return x + L.mlp_apply(p["mlp"], h, cfg.mlp)


def model_init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device=None) -> Params:
    """Random float32 parameters from ``generator`` on ``device`` (default:
    the generator's device). The draws differ from the reference's (its
    threefry keys); tests carry the reference's parameters across with
    ``repro_torch.testing.from_jax_params``. ``generator=None`` with
    ``device="meta"`` gives a shape-only tree."""
    _check_family(cfg)
    dev = device if device is not None else generator.device
    p: Params = {
        "embed": torch.randn((cfg.vocab_size, cfg.d_model),
                             generator=generator, device=dev) * 0.02,
        "final_norm": L.norm_init(cfg.d_model, cfg.norm, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = torch.randn((cfg.d_model, cfg.vocab_size),
                                   generator=generator, device=dev) * 0.02
    blocks = [tree_flatten(_attn_block_init(generator, cfg, device=dev))
              for _ in range(cfg.n_layers)]
    p["blocks"] = tree_unflatten(blocks[0][1], [
        torch.stack(ls) for ls in zip(*(leaves for leaves, _ in blocks))])
    return p


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            *, mode: str = "train", pos: int = 0
            ) -> Tuple[torch.Tensor, None, Dict[str, torch.Tensor]]:
    """Run the decoder on ``batch["tokens"] [B, S]``: ``(hidden [B, S, D],
    None, {"moe_loss": 0})`` (the reference's return shape; the dense family
    has no cache here and no MoE loss)."""
    _check_family(cfg)
    if mode != "train":
        raise ValueError(f"forward mode {mode!r} is not ported (train only)")
    dtype = getattr(torch, cfg.dtype)
    # F.embedding: its CUDA backward is deterministic (sorted), where the
    # backward of an indexing gather adds with atomics
    x = F.embedding(batch["tokens"], params["embed"].to(dtype))
    if cfg.tie_embeddings:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model))).to(dtype)
    for i in range(cfg.n_layers):
        p_i = tree_map(lambda a: a[i], params["blocks"])
        x = _attn_block_apply(p_i, cfg, x, pos=pos)
    x = L.norm_apply(params["final_norm"], x, cfg.norm)
    return x, None, {"moe_loss": torch.zeros((), device=x.device)}


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
    """Causal-LM loss over ``batch["tokens"]``, shifted by one."""
    hidden, _, aux = forward(params, cfg, batch, mode="train")
    loss = chunked_xent(params, cfg, hidden[:, :-1], batch["tokens"][:, 1:])
    return loss + moe_loss_weight * aux["moe_loss"]
