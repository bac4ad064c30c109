"""Mixture-of-Experts layer (counterpart of ``repro.models.moe``): top-k
routing with a per-group capacity, Switch-style load-balance loss, and the
DeepSeek-V2 shared experts (dense MLPs added to the routed output).

The reference dispatches and combines with one-hot ``[T, E, cap]``
einsums, its TPU formulation. The port routes the same way and moves the
same rows with index gathers: each kept choice owns one slot of an
``[E, cap, D]`` buffer (a token's row is gathered into it), every expert
bank is one batched matrix product over its ``cap`` rows, and each token
gathers its ``k`` expert rows back and takes their weighted sum in choice
order. Every gather is ``F.embedding`` (a sorted, deterministic backward
on the card); nothing adds with atomics, so the forward is bitwise
repeatable and greedy decoding reproduces its tokens.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = Dict[str, torch.Tensor]

MOE_TOKEN_CHUNK = 8192  # max tokens per dispatch group (see moe_apply)


class RouteLog:
    """The expert choices of the MoE calls (``[T, k]`` a routed group), in
    call order. Recording, it keeps each call's choices; given ``replay``,
    it hands those back to the calls in order in place of their own top-k
    (the gates are then the given experts' probabilities, renormalised).
    A check that holds two computations of the same tokens against each
    other (prefill and decode against the train-mode forward) replays the
    first's choices into the second: in bfloat16 a near tie of two router
    probabilities can break either way between the two, which sends a
    token to another expert and hides the arithmetic being checked."""

    def __init__(self, replay: Optional[List[torch.Tensor]] = None):
        self.calls: List[torch.Tensor] = []
        self.replay = None if replay is None else list(replay)

    def route(self, expert_idx: torch.Tensor) -> torch.Tensor:
        if self.replay is None:
            self.calls.append(expert_idx.detach().clone())
            return expert_idx
        given = self.replay.pop(0).to(expert_idx.device)
        if given.shape != expert_idx.shape:
            raise ValueError(f"replayed choices {tuple(given.shape)} for a "
                             f"call of {tuple(expert_idx.shape)}")
        return given


_ROUTES: Optional[RouteLog] = None


@contextlib.contextmanager
def routes(log: RouteLog) -> Iterator[RouteLog]:
    """Route the MoE calls inside the block through ``log``."""
    global _ROUTES
    prev, _ROUTES = _ROUTES, log
    try:
        yield log
    finally:
        _ROUTES = prev


def moe_init(gen: Optional[torch.Generator], cfg, device=None) -> Params:
    """The router ``[D, E]`` (scale 0.02), the expert banks ``wi``, ``wg``
    ``[E, D, F]`` and ``wo`` ``[E, F, D]`` (N(0, 1/d_in)), and the shared
    experts' MLP of width ``F * n_shared_experts`` when there are any."""
    e, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    dev = gen.device if device is None else device

    def expert_bank(d_in, d_out):
        return torch.randn((e, d_in, d_out), generator=gen,
                           device=dev) / math.sqrt(d_in)

    p = {"router": L.dense_init(gen, d, e, scale=0.02, device=dev),
         "wi": expert_bank(d, ff), "wg": expert_bank(d, ff),
         "wo": expert_bank(ff, d)}
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_init(gen, d, ff * cfg.n_shared_experts,
                                 kind=cfg.mlp, device=dev)
    return p


def capacity(cfg, t: int) -> int:
    """Slots an expert holds for a group of ``t`` tokens:
    ``max(k, ceil(t * k / E * capacity_factor))``, in the reference's
    float arithmetic."""
    k = cfg.top_k
    return max(k, int(math.ceil(t * k / cfg.n_experts
                                * cfg.capacity_factor)))


def _moe_tokens(p: Params, cfg, xt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route one group of tokens: ``xt [T, D] -> (y [T, D], aux scalar)``.

    Router logits in float32, softmax, top-k (ties to the lower expert
    id), gates renormalised over the k choices. Each (token, choice) takes
    the next free slot of its expert's queue, queued token-major then in
    choice order; a choice past the capacity is dropped (gate 0). The aux
    loss counts the choices before the drop."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    dt = xt.dtype

    logits = xt.float() @ p["router"]["w"].float()                # [T, E]
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower expert id, as ``jax.lax.top_k`` (a
    # zero-padded token's uniform probabilities are all ties)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[:, :k], expert_idx[:, :k]  # [T, k]
    if _ROUTES is not None:
        expert_idx = _ROUTES.route(expert_idx)
        gate_vals = probs.gather(1, expert_idx)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    cap = capacity(cfg, t)

    # position of each (token, choice) in its expert's queue
    onehot = F.one_hot(expert_idx, e)                            # [T, k, E]
    flat = onehot.reshape(t * k, e)
    pos = (flat.cumsum(0) - flat).gather(1, expert_idx.reshape(-1, 1)) \
        .reshape(t, k)
    keep = pos < cap
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    # slot e * cap + pos of each kept choice; dropped choices read slot
    # E * cap, a zero row
    dump = e * cap
    slot = torch.where(keep, expert_idx * cap + pos,
                       torch.full_like(pos, dump))
    src = torch.full((dump + 1,), t, dtype=torch.long, device=xt.device)
    src.scatter_(0, slot.reshape(-1), torch.arange(
        t, device=xt.device).repeat_interleave(k))  # kept slots: unique
    xpad = torch.cat([xt, xt.new_zeros((1, d))])
    xe = F.embedding(src[:dump], xpad).reshape(e, cap, d)        # [E, cap, D]

    hi = torch.bmm(xe, p["wi"].to(dt))
    if cfg.mlp in ("swiglu", "geglu"):
        hg = torch.bmm(xe, p["wg"].to(dt))
        act = F.silu(hg) if cfg.mlp == "swiglu" else \
            F.gelu(hg, approximate="tanh")
        hi = hi * act
    else:
        hi = F.gelu(hi, approximate="tanh")
    ye = torch.bmm(hi, p["wo"].to(dt))                            # [E, cap, D]
    yflat = torch.cat([ye.reshape(dump, d), ye.new_zeros((1, d))])
    rows = F.embedding(slot, yflat)                              # [T, k, D]
    # the combine weights rounded to the activation dtype, as the
    # reference's comb; the k products summed in float32, in choice order
    comb = gate_vals.to(dt).float()
    y = (comb[..., None] * rows.float()).sum(1).to(dt)

    # Switch-style load-balance loss: E * sum_e (frac_tokens_e * frac_prob_e)
    me = probs.mean(0)                                           # [E]
    ce = onehot.sum(1).float().mean(0)
    aux = e * (me * ce).sum() / k
    return y, aux


def moe_apply(p: Params, cfg, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, D] -> (y, aux_loss)``. More than :data:`MOE_TOKEN_CHUNK`
    tokens are routed in groups of that many (the last zero-padded, its
    padding routed too, as the reference's), each with its own capacity,
    the aux loss averaged over the groups. The shared experts act on the
    ungrouped tokens."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    chunk = MOE_TOKEN_CHUNK
    if t <= chunk:
        y, aux = _moe_tokens(p, cfg, xt)
    else:
        xp = F.pad(xt, (0, 0, 0, (-t) % chunk))
        ys, auxs = zip(*[_moe_tokens(p, cfg, g) for g in xp.split(chunk)])
        y = torch.cat(ys)[:t]
        aux = torch.stack(auxs).mean()
    if cfg.n_shared_experts:
        y = y + L.mlp_apply(p["shared"], xt, kind=cfg.mlp)
    return y.reshape(b, s, d), aux
