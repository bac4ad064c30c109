"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``): the same routing (float32 router, top-k,
renormalised gates, per-group capacity, token-major queues, dropped
choices at gate 0), the grouped path, the shared experts and the Switch
aux loss, with the reference's parameters carried across."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import moe as MOE
from repro_torch.models.config import ModelConfig
from repro_torch.testing import from_jax_params

_BASE = dict(family="moe", d_model=32, n_heads=2, n_kv_heads=2, d_ff=48,
             vocab_size=64, n_experts=4, top_k=2, dtype="float32")


def _cfgs(**over):
    kw = {**_BASE, **over}
    return JModelConfig(name="m", **kw), ModelConfig(name="m", **kw)


def _setup(seed=0, b=2, s=12, **over):
    jcfg, cfg = _cfgs(**over)
    jp = JMOE.moe_init(jax.random.PRNGKey(seed), jcfg)
    # a wider router than the init's 0.02 scale, so the top-k choices are
    # far from ties
    jp["router"]["w"] = jp["router"]["w"] * 50.0
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model)) \
        .astype(np.float32)
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp)), x


def _ref_drops(jp, jcfg, xt) -> int:
    """Choices the reference drops for one group (its routing, replayed)."""
    t = xt.shape[0]
    e, k = jcfg.n_experts, jcfg.top_k
    logits = jnp.asarray(xt, jnp.float32) @ jp["router"]["w"]
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, -1), k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32).reshape(t * k, e)
    pos = jnp.sum((jnp.cumsum(onehot, 0) - onehot) * onehot, -1)
    cap = max(k, int(math.ceil(t * k / e * jcfg.capacity_factor)))
    return int(jnp.sum(pos >= cap))


@pytest.mark.parametrize("cf,mlp,shared", [
    (8.0, "swiglu", 0),    # capacity never binds
    (1.0, "swiglu", 0),    # capacity binds
    (0.5, "geglu", 1),     # binds hard, with a shared expert
    (1.25, "gelu", 2),     # the configs' factor, the ungated MLP
])
def test_moe_tokens_match_reference(cf, mlp, shared):
    """y and aux within rtol 1e-5 (float32) of ``_moe_tokens``."""
    jcfg, cfg, jp, tp, x = _setup(capacity_factor=cf, mlp=mlp,
                                  n_shared_experts=shared)
    xt = x.reshape(-1, cfg.d_model)
    jy, jaux = JMOE._moe_tokens(jp, jcfg, jnp.asarray(xt))
    ty, taux = MOE._moe_tokens(tp, cfg, torch.tensor(xt))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    drops = _ref_drops(jp, jcfg, xt)
    assert (drops > 0) == (cf < 1.25), drops


def test_capacity_binding_case_drops_choices_in_queue_order():
    """Where capacity binds, the dropped choices are the last ones queued
    (token-major, then choice order): rows of tokens whose every choice was
    dropped are exactly zero, as in the reference."""
    jcfg, cfg, jp, tp, x = _setup(capacity_factor=0.25, s=16)
    xt = x.reshape(-1, cfg.d_model)
    assert _ref_drops(jp, jcfg, xt) > 0
    jy, _ = JMOE._moe_tokens(jp, jcfg, jnp.asarray(xt))
    ty, _ = MOE._moe_tokens(tp, cfg, torch.tensor(xt))
    zero_ref = np.all(np.asarray(jy) == 0, axis=-1)
    assert zero_ref.any()
    np.testing.assert_array_equal(np.all(ty.numpy() == 0, axis=-1), zero_ref)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))


@pytest.mark.parametrize("shared", [0, 1])
def test_grouped_path_matches_reference(monkeypatch, shared):
    """``MOE_TOKEN_CHUNK`` = 16 in both packages: 40 tokens route as three
    groups (the last zero-padded, its padding routed too), each with its
    own capacity, the aux loss averaged over the groups; the shared
    experts on the ungrouped tokens."""
    monkeypatch.setattr(JMOE, "MOE_TOKEN_CHUNK", 16)
    monkeypatch.setattr(MOE, "MOE_TOKEN_CHUNK", 16)
    jcfg, cfg, jp, tp, x = _setup(s=20, capacity_factor=1.0,
                                  n_shared_experts=shared)
    jy, jaux = JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
    ty, taux = MOE.moe_apply(tp, cfg, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    # one group would route differently where capacity binds
    monkeypatch.setattr(MOE, "MOE_TOKEN_CHUNK", 8192)
    whole, _ = MOE.moe_apply(tp, cfg, torch.tensor(x))
    assert not torch.allclose(whole, ty)


def test_bfloat16_within_1e2_of_max_y():
    """bfloat16 activations (the expert banks cast on use, the combine
    weights rounded to bfloat16 as the reference's ``comb``): within 1e-2
    of max |y| of the reference in bfloat16."""
    jcfg, cfg, jp, tp, x = _setup(s=16, capacity_factor=1.25,
                                  n_shared_experts=1, dtype="bfloat16")
    jy, jaux = JMOE.moe_apply(jp, jcfg, jnp.asarray(x, jnp.bfloat16))
    ty, taux = MOE.moe_apply(tp, cfg, torch.tensor(x).to(torch.bfloat16))
    assert ty.dtype == torch.bfloat16
    want = np.asarray(jy.astype(jnp.float32))
    err = float(np.abs(ty.float().numpy() - want).max())
    assert err <= 1e-2 * float(np.abs(want).max())
    assert float(taux) == pytest.approx(float(jaux), rel=1e-2)


def test_forward_is_bitwise_repeatable_and_gradients_flow():
    """Two calls give the same bits; the gradient reaches every expert
    bank that a kept choice uses, the router and the input."""
    _, cfg, _, tp, x = _setup(capacity_factor=1.0)
    xt = torch.tensor(x, requires_grad=True)
    leaves = {k: v.requires_grad_() for k, v in
              (("router", tp["router"]["w"]), ("wi", tp["wi"]),
               ("wg", tp["wg"]), ("wo", tp["wo"]))}
    y1, aux1 = MOE.moe_apply(tp, cfg, xt)
    y2, aux2 = MOE.moe_apply(tp, cfg, xt)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)
    (y1.square().sum() + aux1).backward()
    assert all(float(v.grad.abs().sum()) > 0 for v in leaves.values())
    assert float(xt.grad.abs().sum()) > 0


@pytest.mark.parametrize("t,want", [(12, 5), (4, 2), (1, 2), (160, 63)])
def test_capacity_is_the_references(t, want):
    """``max(k, ceil(T * k / E * cf))`` at k = 2, E = 4, cf 0.78, with its
    floor at k."""
    cfg = ModelConfig(**{**_BASE, "capacity_factor": 0.78})
    jcfg = JModelConfig(**{**_BASE, "capacity_factor": 0.78})
    assert MOE.capacity(cfg, t) == want
    assert max(jcfg.top_k, int(math.ceil(
        t * jcfg.top_k / jcfg.n_experts * jcfg.capacity_factor))) == want


def test_route_log_records_and_replays_the_choices():
    """``moe.routes``: a recording pass keeps each call's ``[T, k]``
    choices and changes nothing; replaying them gives the same output bit
    for bit; replaying other choices routes to those experts (gates their
    renormalised probabilities); a replay of the wrong shape raises."""
    _, cfg, _, tp, x = _setup(capacity_factor=1.0)
    xt = torch.tensor(x)
    plain, _ = MOE.moe_apply(tp, cfg, xt)
    with MOE.routes(MOE.RouteLog()) as log:
        rec, _ = MOE.moe_apply(tp, cfg, xt)
    assert torch.equal(rec, plain) and len(log.calls) == 1
    assert tuple(log.calls[0].shape) == (x.shape[0] * x.shape[1], 2)
    with MOE.routes(MOE.RouteLog(log.calls)):
        again, _ = MOE.moe_apply(tp, cfg, xt)
    assert torch.equal(again, plain)
    other = (log.calls[0] + 1) % cfg.n_experts  # each choice moved
    with MOE.routes(MOE.RouteLog([other])):
        moved, _ = MOE.moe_apply(tp, cfg, xt)
    assert float((moved - plain).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="replayed choices"):
        with MOE.routes(MOE.RouteLog([other[:3]])):
            MOE.moe_apply(tp, cfg, xt)
    assert MOE._ROUTES is None
