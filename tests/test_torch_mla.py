"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the reference's (``repro.models.mla``) in float32, with the
reference's parameters carried across: train mode, prefill (output and the
latent caches) and decode steps (the absorbed attention in the rank-r
space), and the absorbed decode against the expanded attention over the
same cache."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mla as JMLA
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models.config import ModelConfig
from repro_torch.testing import from_jax_params

_BASE = dict(family="moe", d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab_size=64, use_mla=True, kv_lora_rank=32,
             qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
             rope_theta=1e4, dtype="float32")


def _setup(seed=0, **over):
    kw = {**_BASE, **over}
    jcfg, cfg = JModelConfig(name="m", **kw), ModelConfig(name="m", **kw)
    jp = JMLA.mla_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _x(b, s, d, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _close(got, want, scale=None):
    """Within 1e-5 (float32 products summed in other orders)."""
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * max(scale, 1.0))


@pytest.mark.parametrize("s,pos", [(12, 0), (7, 5)])
def test_train_mode_matches(s, pos):
    """The expanded keys (qk dim 24) against values of dim 16 through the
    plain causal attention, at offset ``pos``."""
    jcfg, cfg, jp, tp = _setup()
    x = _x(2, s, cfg.d_model)
    jy, _ = JMLA.mla_apply(jp, jcfg, jnp.asarray(x), mode="train", pos=pos)
    ty, tc = MLA.mla_apply(tp, cfg, torch.tensor(x), mode="train", pos=pos)
    assert tc is None
    _close(ty, jy)


def test_prefill_then_decode_match():
    """Prefill of 9 tokens into a 14-slot latent cache (output and both
    caches), then 4 absorbed decode steps: each output and the caches."""
    jcfg, cfg, jp, tp = _setup(seed=2)
    b, s, steps, max_len = 2, 9, 4, 14
    x = _x(b, s + steps, cfg.d_model, seed=3)
    jc = JMLA.mla_cache_init(jcfg, b, max_len, jnp.float32)
    tc = MLA.mla_cache_init(cfg, b, max_len, torch.float32)
    jy, jc = JMLA.mla_apply(jp, jcfg, jnp.asarray(x[:, :s]), mode="prefill",
                            pos=0, cache=jc)
    ty, tc2 = MLA.mla_apply(tp, cfg, torch.tensor(x[:, :s]), mode="prefill",
                            pos=0, cache=tc)
    assert tc2 is tc  # written in place
    _close(ty, jy)
    for k in ("ckv", "krope"):
        _close(tc[k], jc[k])
    for i in range(steps):
        xi = x[:, s + i:s + i + 1]
        jy, jc = JMLA.mla_apply(jp, jcfg, jnp.asarray(xi), mode="decode",
                                pos=s + i, cache=jc)
        ty, tc = MLA.mla_apply(tp, cfg, torch.tensor(xi), mode="decode",
                               pos=s + i, cache=tc)
        _close(ty, jy)
    for k in ("ckv", "krope"):
        _close(tc[k], jc[k])


def test_absorbed_decode_equals_expanded_attention_over_the_cache():
    """A decode step attends in the latent space; expanding the cached
    latents into keys and values and taking the plain attention of the
    step's query over them gives the same output (float32, 1e-5)."""
    _, cfg, _, tp = _setup(seed=4)
    b, s, max_len = 2, 6, 8
    x = torch.tensor(_x(b, s + 1, cfg.d_model, seed=5))
    cache = MLA.mla_cache_init(cfg, b, max_len, torch.float32)
    MLA.mla_apply(tp, cfg, x[:, :s], mode="prefill", cache=cache)
    y_dec, cache = MLA.mla_apply(tp, cfg, x[:, s:], mode="decode", pos=s,
                                 cache=cache)
    # the expanded path over the same cached latents, the step's query
    h, nope, rope = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = L.dense_apply(tp["wq"], x[:, s:]).reshape(b, 1, h, nope + rope)
    q_nope, q_rope = q.split([nope, rope], dim=-1)
    q_rope = L.apply_rope(q_rope, torch.tensor([s]), cfg.rope_theta)
    k, v = MLA._expand_kv(tp, cfg, cache["ckv"][:, :s + 1],
                          cache["krope"][:, :s + 1], torch.float32)
    out = L.causal_attention(torch.cat([q_nope, q_rope], -1), k, v,
                             q_offset=s)
    y_exp = L.dense_apply(tp["wo"], out.reshape(b, 1, h * cfg.v_head_dim))
    _close(y_dec, y_exp.numpy())


def test_bfloat16_decode_tracks_float32():
    """bfloat16 activations and caches: a decode step within 5e-2 of max
    |y| of the float32 step on the same parameters (the reference's cast
    points: bf16 latents, float32 logits)."""
    _, cfg, _, tp = _setup(seed=6)
    b, s = 2, 5
    x = torch.tensor(_x(b, s + 1, cfg.d_model, seed=7))
    outs = []
    for dt in (torch.float32, torch.bfloat16):
        c = cfg.with_overrides(dtype=str(dt).split(".")[-1])
        cache = MLA.mla_cache_init(c, b, s + 1, dt)
        MLA.mla_apply(tp, c, x[:, :s].to(dt), mode="prefill", cache=cache)
        y, _ = MLA.mla_apply(tp, c, x[:, s:].to(dt), mode="decode", pos=s,
                             cache=cache)
        assert y.dtype == dt and cache["ckv"].dtype == dt
        outs.append(y.float())
    scale = float(outs[0].abs().max())
    assert float((outs[0] - outs[1]).abs().max()) <= 5e-2 * scale


def test_modes_need_a_cache():
    _, cfg, _, tp = _setup()
    x = torch.zeros(1, 1, cfg.d_model)
    for mode in ("prefill", "decode"):
        with pytest.raises(ValueError, match="preallocated cache"):
            MLA.mla_apply(tp, cfg, x, mode=mode)
