"""The port's Mamba2 / SSD block (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``), with the reference's parameters carried
across: ``ssd_chunked`` with and without an initial state, one chunk and
several; ``_causal_conv`` carrying its state; ``ssm_apply`` in train,
prefill (a multiple of the chunk and a padded tail) and decode mode in
float32; the bfloat16 decode state rounded each step as the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JSSM
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ModelConfig
from repro_torch.testing import from_jax_params

_BASE = dict(family="ssm", d_model=64, n_heads=1, n_kv_heads=1, d_ff=0,
             vocab_size=64, ssm_state=16, ssm_expand=2, ssm_head_dim=16,
             ssm_conv_width=4, ssm_chunk=8, dtype="float32")


def _cfgs(**over):
    kw = {**_BASE, **over}
    return JModelConfig(name="s", **kw), ModelConfig(name="s", **kw)


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _ssd_inputs(b, s, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    return xh, dt, a, bm, cm


@pytest.mark.parametrize("s,chunk,g,init", [
    (8, 8, 1, False),     # one chunk
    (32, 8, 1, False),    # four chunks
    (24, 8, 2, True),     # two groups, carried state
    (16, 4, 1, True),
])
def test_ssd_chunked_matches(s, chunk, g, init):
    """Output and final state within 1e-5 (float32)."""
    b, h, p, n = 2, 4, 8, 6
    xh, dt, a, bm, cm = _ssd_inputs(b, s, h, p, g, n, seed=s + chunk)
    st = (np.random.default_rng(9).normal(size=(b, h, p, n)).astype(
        np.float32) if init else None)
    jy, jf = JSSM.ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)), chunk,
                              None if st is None else jnp.asarray(st))
    ty, tf = SSM.ssd_chunked(*map(torch.tensor, (xh, dt, a, bm, cm)), chunk,
                             None if st is None else torch.tensor(st))
    _close(ty, jy)
    _close(tf, jf)


def test_ssd_chunked_refuses_a_ragged_sequence():
    xh, dt, a, bm, cm = _ssd_inputs(1, 10, 2, 4, 1, 3, seed=0)
    with pytest.raises(ValueError, match="multiple of chunk"):
        SSM.ssd_chunked(*map(torch.tensor, (xh, dt, a, bm, cm)), 4)


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv_matches_and_carries_its_state(carry):
    """Output and the trailing W-1 inputs (before the convolution); with a
    carried state, two calls over halves equal one call over the whole."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 10, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    st = rng.normal(size=(2, 3, 12)).astype(np.float32) if carry else None
    jy, jst = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b),
                                None if st is None else jnp.asarray(st))
    ty, tst = SSM._causal_conv(torch.tensor(x), torch.tensor(w),
                               torch.tensor(b),
                               None if st is None else torch.tensor(st))
    _close(ty, jy)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    y1, s1 = SSM._causal_conv(torch.tensor(x[:, :4]), torch.tensor(w),
                              torch.tensor(b),
                              None if st is None else torch.tensor(st))
    y2, s2 = SSM._causal_conv(torch.tensor(x[:, 4:]), torch.tensor(w),
                              torch.tensor(b), s1)
    _close(torch.cat([y1, y2], 1), jy)
    assert torch.equal(s2, tst)


def _block(seed=0, **over):
    jcfg, cfg = _cfgs(**over)
    jp = JSSM.ssm_init(jax.random.PRNGKey(seed), jcfg)
    # nonzero conv bias and a D off 1, so both count
    jp["conv_b"] = jnp.linspace(-0.2, 0.2, jp["conv_b"].shape[0])
    jp["D"] = jnp.linspace(0.5, 1.5, jp["D"].shape[0])
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _x(b, s, d, seed):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("s", [8, 24, 13])
def test_ssm_apply_train_matches(s):
    """One chunk, three chunks, and a padded tail (13 = 8 + 5)."""
    jcfg, cfg, jp, tp = _block()
    x = _x(2, s, cfg.d_model, seed=s)
    jy, _ = JSSM.ssm_apply(jp, jcfg, jnp.asarray(x), mode="train")
    ty, tc = SSM.ssm_apply(tp, cfg, torch.tensor(x), mode="train")
    assert tc is None
    _close(ty, jy)


@pytest.mark.parametrize("s", [16, 11, 2])
def test_ssm_prefill_then_decode_match(s):
    """Prefill (a whole number of chunks, a padded tail, a prompt shorter
    than the conv window) writes the final state and the conv state; then
    5 decode steps, each output and both caches within 1e-5."""
    jcfg, cfg, jp, tp = _block(seed=1)
    b, steps = 2, 5
    x = _x(b, s + steps, cfg.d_model, seed=20 + s)
    jc = JSSM.ssm_cache_init(jcfg, b, jnp.float32)
    tc = SSM.ssm_cache_init(cfg, b, torch.float32)
    jy, jc = JSSM.ssm_apply(jp, jcfg, jnp.asarray(x[:, :s]), mode="prefill",
                            cache=jc)
    ty, tc2 = SSM.ssm_apply(tp, cfg, torch.tensor(x[:, :s]), mode="prefill",
                            cache=tc)
    assert tc2 is tc
    _close(ty, jy)
    _close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])
    for i in range(steps):
        xi = x[:, s + i:s + i + 1]
        jy, jc = JSSM.ssm_apply(jp, jcfg, jnp.asarray(xi), mode="decode",
                                cache=jc)
        ty, tc = SSM.ssm_apply(tp, cfg, torch.tensor(xi), mode="decode",
                               cache=tc)
        _close(ty, jy)
    _close(tc["state"], jc["state"])
    _close(tc["conv"], jc["conv"])


def test_bf16_decode_state_is_rounded_each_step():
    """bfloat16 caches under float32 activations, so only the cache's
    rounding differs from float32: each decode step's output uses the
    unrounded float32 update (within 1e-5 of the reference's), and the
    state it keeps is that update rounded to bfloat16, as the reference's
    (equal but for the rare value that two float32 sums round to
    neighbouring bfloat16s, within one bfloat16 ulp)."""
    jcfg, cfg, jp, tp = _block(seed=2)
    b, s, steps = 2, 8, 4
    x = _x(b, s + steps, cfg.d_model, seed=5)
    jc = JSSM.ssm_cache_init(jcfg, b, jnp.bfloat16)
    tc = SSM.ssm_cache_init(cfg, b, torch.bfloat16)
    _, jc = JSSM.ssm_apply(jp, jcfg, jnp.asarray(x[:, :s]), mode="prefill",
                           cache=jc)
    SSM.ssm_apply(tp, cfg, torch.tensor(x[:, :s]), mode="prefill", cache=tc)
    rounded = 0
    for i in range(steps):
        # both steps start from the reference's bfloat16 caches (its decode
        # hands the conv state back in the activations' dtype)
        jc = {k: v.astype(jnp.bfloat16) for k, v in jc.items()}
        tc = {k: torch.tensor(np.asarray(v.astype(jnp.float32))).to(
            torch.bfloat16) for k, v in jc.items()}
        xi = x[:, s + i:s + i + 1]
        st = tc["state"].float()
        jy, jc = JSSM.ssm_apply(jp, jcfg, jnp.asarray(xi), mode="decode",
                                cache=jc)
        ty, tc = SSM.ssm_apply(tp, cfg, torch.tensor(xi), mode="decode",
                               cache=tc)
        _close(ty, jy)
        assert tc["state"].dtype == torch.bfloat16
        want = np.asarray(jc["state"].astype(jnp.float32))
        got = tc["state"].float().numpy()
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7)
        assert np.mean(got == want) > 0.99
        rounded += int((tc["state"].float() != st).sum())
    assert rounded > 0  # the state moved, in bfloat16 steps


def test_init_shapes_and_values_are_the_references():
    """The parameter tree's keys and shapes; ``A_log`` is ``log(1..H)``,
    ``D`` ones, ``dt_bias`` the inverse softplus of values in [1e-3,
    1e-1]."""
    jcfg, cfg = _cfgs()
    jp = jax.eval_shape(lambda: JSSM.ssm_init(jax.random.PRNGKey(0), jcfg))
    tp = SSM.ssm_init(torch.Generator().manual_seed(0), cfg)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        want = jax.tree_util.tree_leaves(jp[k])
        got = tp[k] if isinstance(tp[k], torch.Tensor) else \
            list(tp[k].values())
        got = got if isinstance(got, list) else [got]
        assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    h = cfg.ssm_n_heads
    assert torch.allclose(tp["A_log"], torch.log(torch.arange(1., h + 1)))
    assert torch.equal(tp["D"], torch.ones(h))
    dt0 = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt0.min()) >= 1e-3 * 0.999 and float(dt0.max()) <= 0.1001


def test_ssd_gradient_stays_finite_where_the_reference_overflows():
    """A 64-step chunk whose decays sum past float32's exp range (dt 0.5,
    A -8): the reference takes ``exp(cum_i - cum_j)`` over the whole
    square and zeroes the upper triangle after, so ``jax.grad`` meets
    ``0 * inf`` there and returns NaN; the port takes the exponential on
    the causal entries only. The outputs agree (1e-5) and the port's
    gradient is finite."""
    rng = np.random.default_rng(0)
    b, s, h, p, g, n = 1, 64, 2, 4, 1, 3
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.full((b, s, h), 0.5, np.float32)
    a = np.array([-8.0, -4.0], np.float32)
    bm = rng.normal(size=(b, s, g, n)).astype(np.float32)
    cm = rng.normal(size=(b, s, g, n)).astype(np.float32)

    def ref_sum(dtj):
        return jnp.sum(JSSM.ssd_chunked(jnp.asarray(xh), dtj, jnp.asarray(a),
                                        jnp.asarray(bm), jnp.asarray(cm),
                                        s)[0])

    ref_grad = jax.grad(ref_sum)(jnp.asarray(dt))
    assert not bool(jnp.all(jnp.isfinite(ref_grad)))
    dtt = torch.tensor(dt, requires_grad=True)
    y, _ = SSM.ssd_chunked(torch.tensor(xh), dtt, torch.tensor(a),
                           torch.tensor(bm), torch.tensor(cm), s)
    y.sum().backward()
    assert bool(torch.isfinite(dtt.grad).all())
    assert float(y.sum().detach()) == pytest.approx(
        float(ref_sum(jnp.asarray(dt))), rel=1e-5)
