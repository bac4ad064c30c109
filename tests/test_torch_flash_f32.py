"""Flash attention at float32: the port's plain forward and backward (what
the CPU runs, and what ``csrc/flash_attention_f32.cu`` is held against on
the card) against the reference's Pallas kernel in interpret mode at
float32 and ``jax.grad`` of its ``attention_ref``, on the reference's own
float32 cases (``tests/test_kernels.py``: the ``test_flash_sweep`` shapes,
the sliding windows 32 and 96, the ``q_offset`` = 128 chunk), and zamba2's
head dim 112 through the zero pad. Inputs in float32 from numpy.

Bars: 1e-5 of the largest entry (rtol and atol 1e-5 scaled by max |want|)
for the forward and the log-sum-exp, 1e-5 of the largest entry for the
gradients: both sides compute in float32 and differ only in summation
order (the interpret-mode kernel's online softmax over 64-key blocks, the
dense softmax here) over at most 256 keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ops import attention as jax_ops_attention
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 attention_bwd_ref,
                                                 attention_fwd_ref,
                                                 flash_attention,
                                                 padded_attention)

# (B, Sq, Sk, H, KV, D, window, q_offset): tests/test_kernels.py's float32
# cases: the four test_flash_sweep shapes, test_flash_sliding_window's
# windows, test_flash_q_offset_decode_chunk
REF_CASES = [(2, 128, 128, 4, 2, 64, None, 0),
             (2, 256, 256, 4, 1, 128, None, 0),
             (2, 64, 192, 4, 4, 64, None, 0),
             (2, 96, 96, 2, 2, 64, None, 0),
             (1, 256, 256, 2, 2, 64, 32, 0),
             (1, 256, 256, 2, 2, 64, 96, 0),
             (2, 64, 192, 4, 4, 64, None, 128)]
IDS = ["sweep_gqa2", "sweep_mqa_d128", "sweep_sq_lt_sk", "sweep_ragged",
       "window_32", "window_96", "q_offset_128"]
BAR = 1e-5


def _inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, kv, d), f(b, sk, kv, d), f(b, sq, h, d)


def _close(got, want, bar=BAR):
    """max |got - want| <= bar * max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= bar * float(np.abs(want).max())


def _jax_lse(q, k, window, q_offset):
    """The reference's float32 log-sum-exp of each row's visible scaled
    logits ``[B, H, Sq]`` (masked entries at its NEG_INF)."""
    h, d = q.shape[2], q.shape[3]
    kr = jnp.repeat(k, h // k.shape[2], axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, kr) / np.sqrt(d)
    qpos = q_offset + jnp.arange(q.shape[1])[:, None]
    kpos = jnp.arange(k.shape[1])[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1)


@pytest.mark.parametrize("case", REF_CASES, ids=IDS)
def test_float32_forward_matches_the_interpret_mode_kernel(case):
    """The kernels' plain forward at float32 (``attention_fwd_ref``, what
    ``FlashAttention`` runs on CPU tensors) against the reference's Pallas
    kernel at float32 in interpret mode (its 64-row, 64-key blocks, as its
    tests run it): out within 1e-5 of the largest entry, float32 out and
    lse, and lse against the reference's own float32 log-sum-exp."""
    b, sq, sk, h, kv, d, window, q_offset = case
    q, k, v, _ = _inputs(b, sq, sk, h, kv, d, sum(case[:6]))
    kern = jax_flash(q, k, v, causal=True, window=window, q_offset=q_offset,
                     block_q=64, block_k=64, interpret=True)
    assert kern.dtype == jnp.float32
    tq, tk, tv = map(torch.tensor, (q, k, v))
    o, lse = attention_fwd_ref(tq, tk, tv, causal=True, window=window,
                               q_offset=q_offset)
    assert o.dtype == lse.dtype == torch.float32
    assert lse.shape == (b, h, sq)
    _close(o.numpy(), kern)
    _close(lse.numpy(), _jax_lse(q, k, window, q_offset))
    fo, flse = FlashAttention.apply(tq, tk, tv, True, window, q_offset)
    assert torch.equal(fo, o) and torch.equal(flse, lse)
    # the dispatching op at float32 on the CPU is the dense plain version
    op = flash_attention(tq, tk, tv, window=window, q_offset=q_offset)
    assert op.dtype == torch.float32
    _close(op.numpy(), kern)


@pytest.mark.parametrize("case", REF_CASES, ids=IDS)
def test_float32_gradients_match_jax_grad_of_the_reference(case):
    """dq, dk, dv of ``sum(out * dout)`` through ``FlashAttention`` (its
    backward the kernels' plain backward, ``attention_bwd_ref``) against
    ``jax.grad`` of the reference's ``attention_ref`` at float32: within
    1e-5 of the largest entry, float32, shaped like q, k, v."""
    b, sq, sk, h, kv, d, window, q_offset = case
    q, k, v, dout = _inputs(b, sq, sk, h, kv, d, 7 + sum(case[:6]))

    def jloss(q, k, v):
        out = jax_attention_ref(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
        return jnp.sum(out * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = FlashAttention.apply(*leaves, True, window, q_offset)[0]
    got = torch.autograd.grad(out, leaves, torch.tensor(dout))
    for g, w, leaf in zip(got, want, leaves):
        assert g.dtype == torch.float32 and g.shape == leaf.shape
        _close(g.numpy(), w)
    # the plain backward called as the kernels are
    o, lse = attention_fwd_ref(*[t.detach() for t in leaves], causal=True,
                               window=window, q_offset=q_offset)
    direct = attention_bwd_ref(*[t.detach() for t in leaves], o, lse,
                               torch.tensor(dout), causal=True,
                               window=window, q_offset=q_offset)
    for g, w in zip(direct, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (32, 64)])
def test_float32_head_dim_112_through_the_pad_matches_the_reference(
        window, q_offset):
    """zamba2's head dim at float32: ``padded_attention`` (q, k, v
    zero-padded to 128 around ``FlashAttention``, the scale 1/sqrt(112)
    passed on) against the reference's ``ops.attention`` on its Pallas
    kernel in interpret mode (which pads to 128 and rescales q) within
    1e-5 of the largest entry, and the gradients against ``jax.grad`` of
    its ``attention_ref`` at 112."""
    sq, sk = 96, 96 + q_offset
    q, k, v, dout = _inputs(2, sq, sk, 4, 2, 112, 112 + q_offset)
    kern = jax_ops_attention(q, k, v, window=window, q_offset=q_offset,
                             use_pallas=True, interpret=True)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]

    def attend(q, k, v, causal, window, q_offset, scale):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    scale)[0]

    got = padded_attention(attend, *leaves, 128, True, window, q_offset)
    assert got.dtype == torch.float32 and got.shape == (2, sq, 4, 112)
    _close(got.detach().numpy(), kern)

    def jloss(q, k, v):
        out = jax_attention_ref(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
        return jnp.sum(out * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    grads = torch.autograd.grad(got, leaves, torch.tensor(dout))
    for g, w in zip(grads, want):
        _close(g.numpy(), w)
