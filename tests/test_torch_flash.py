"""Flash attention of the port against the reference: the plain version
(what the CPU runs, and what the CUDA kernels are held against on the card)
against the reference's Pallas kernel in interpret mode and its
``attention_ref``; its gradients against ``jax.grad`` of ``attention_ref``
(the Pallas kernel has no gradient). Inputs in float32 from numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_ref as jax_attention_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.layers import causal_attention as jax_causal_attention
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_fwd_cuda,
                                                 fully_masked_rows)
from repro_torch.models.layers import causal_attention


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (B, Sq, Sk, H, KV, D, window, q_offset): GQA 2:1 and 4:1, MHA, MQA, a
# sliding window, a continuation chunk at q_offset, D in {64, 80, 128,
# 256}; at 256 (gemma_2b's, MQA) a causal case and a windowed continuation
CASES = [(2, 96, 96, 4, 2, 64, None, 0),
         (1, 128, 128, 4, 1, 80, None, 0),
         (1, 64, 64, 2, 2, 128, None, 0),
         (1, 128, 128, 2, 2, 64, 32, 0),
         (2, 64, 192, 4, 4, 80, None, 128),
         (1, 64, 160, 4, 2, 128, 48, 96),
         (1, 96, 96, 4, 1, 256, None, 0),
         (1, 64, 160, 4, 1, 256, 48, 96)]


def _inputs(b, sq, sk, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return f(b, sq, h, d), f(b, sk, kv, d), f(b, sk, kv, d), f(b, sq, h, d)


@pytest.mark.parametrize("case", CASES)
def test_plain_forward_matches_pallas_and_reference(case):
    """atol 2e-3 against the interpret-mode kernel (its online softmax sums
    in another order; the reference's own bar, ``tests/test_kernels.py``)
    and 1e-5 against ``attention_ref`` (the same dense formula)."""
    b, sq, sk, h, kv, d, window, q_offset = case
    q, k, v, _ = _inputs(b, sq, sk, h, kv, d, sum(case[:6]))
    got = attention_ref(*map(torch.tensor, (q, k, v)), causal=True,
                        window=window, q_offset=q_offset).numpy()
    kern = jax_flash(q, k, v, causal=True, window=window, q_offset=q_offset,
                     block_q=64, block_k=64, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=2e-3)
    want = jax_attention_ref(q, k, v, causal=True, window=window,
                             q_offset=q_offset)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    # the dispatching op runs the plain version on CPU tensors
    op = flash_attention(*map(torch.tensor, (q, k, v)), window=window,
                         q_offset=q_offset)
    assert torch.equal(op, torch.tensor(got))


@pytest.mark.parametrize("case", CASES)
def test_plain_gradients_match_jax_grad(case):
    """dq, dk, dv of ``sum(out * dout)`` against ``jax.grad`` of
    ``attention_ref``: rtol/atol 1e-4 (float32 sums in other orders over up
    to 192 keys)."""
    b, sq, sk, h, kv, d, window, q_offset = case
    q, k, v, dout = _inputs(b, sq, sk, h, kv, d, 7 + sum(case[:6]))

    def jloss(q, k, v):
        out = jax_attention_ref(q, k, v, causal=True, window=window,
                                q_offset=q_offset)
        return jnp.sum(out * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = flash_attention(*leaves, window=window, q_offset=q_offset)
    got = torch.autograd.grad(out, leaves, torch.tensor(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_bf16_plain_forward_matches_reference():
    """bf16 inputs: logits in float32, probabilities cast to bf16 before the
    value product in both packages; within 2 bf16 ulps of |out| <= 4."""
    q, k, v, _ = _inputs(1, 128, 128, 4, 2, 64, 3)
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_attention_ref(*jb), np.float32)
    tb = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    got = attention_ref(*tb).float().numpy()
    np.testing.assert_allclose(got, want, atol=2 * 2.0 ** -8 * 4)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (32, 0), (48, 64)])
def test_plain_path_matches_model_causal_attention(window, q_offset):
    """The model's chunked ``causal_attention`` (the plain path) and the
    flash op's dense version agree, and both agree with the reference's
    ``causal_attention``."""
    q, k, v, _ = _inputs(2, 128, 128 + q_offset, 4, 2, 64, 5)
    want = np.asarray(jax_causal_attention(q, k, v, q_offset=q_offset,
                                           window=window, chunk=64))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    chunked = causal_attention(tq, tk, tv, q_offset=q_offset, window=window,
                               chunk=64).numpy()
    dense = attention_ref(tq, tk, tv, window=window,
                          q_offset=q_offset).numpy()
    np.testing.assert_allclose(chunked, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dense, chunked, rtol=1e-5, atol=1e-5)


def test_fully_masked_rows_are_detected():
    assert not fully_masked_rows(64, 64, True, None, 0)
    assert not fully_masked_rows(64, 192, True, None, 128)
    assert fully_masked_rows(4, 4, True, None, -1)
    # q at 64..159 against 96 keys with a 32-key window: rows from 127 on
    # see nothing
    assert fully_masked_rows(96, 96, True, 32, 64)
    assert not fully_masked_rows(96, 160, True, 40, 64)
    assert not fully_masked_rows(70, 90, False, None, 0)


def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="cpu or cuda"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def _qkv(dtype=torch.bfloat16, d=64, sq=8, sk=8, h=2, kv=2):
    q = torch.zeros(1, sq, h, d, dtype=dtype)
    k = torch.zeros(1, sk, kv, d, dtype=dtype)
    return q, k, k.clone()


@pytest.mark.parametrize("case,match", [
    ("float16", "bfloat16 or float32"),
    ("mixed", "one dtype"),
    ("head_dim_320", "head dims"),
    ("head_dim_48", "head dims"),
    ("strided", "contiguous"),
    ("no_visible_key", "no visible key"),
    ("heads", "multiple of KV"),
    ("window", "window must be positive"),
    ("cpu", "needs CUDA"),
])
def test_supports_states_each_refusal(case, match):
    """``flash.supports`` holds exactly where ``_check`` passes: each input
    the kernel refuses, read on the CPU (the device is checked last)."""
    from repro_torch.kernels.flash_attention import flash as FK
    q, k, v = _qkv()
    kw = {}
    if case == "float16":
        q, k, v = _qkv(torch.float16)
    elif case == "mixed":
        q = _qkv(torch.float32)[0]
    elif case == "head_dim_320":
        q, k, v = _qkv(d=320)
    elif case == "head_dim_48":
        q, k, v = _qkv(d=48)
    elif case == "strided":
        q = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)[:, :, ::2]
    elif case == "no_visible_key":
        kw = {"q_offset": -1}
    elif case == "heads":
        q, k, v = _qkv(h=3, kv=2)
    elif case == "window":
        kw = {"window": 0}
    why = FK.refusal(q, k, v, True, kw.get("window"), kw.get("q_offset", 0))
    assert why is not None and match in why[1]
    assert not FK.supports(q, k, v, True, kw.get("window"),
                           kw.get("q_offset", 0))
    with pytest.raises(why[0], match=match):
        FK._check(q, k, v, True, kw.get("window"), kw.get("q_offset", 0))


@pytest.mark.parametrize("pad", [False, True])
def test_refusal_takes_float32_as_bfloat16(pad):
    """Float32 q, k and v (the float32 kernels') are refused for the same
    reasons as bfloat16 ones and no other: on the CPU only for the
    device, at every head dim both are built for (112 too); at 192 both
    only with the pad."""
    from repro_torch.kernels.flash_attention import flash as FK
    for d in (64, 80, 128, 256, 112, 192):
        got = FK.refusal(*_qkv(torch.float32, d=d), pad=pad)
        want = FK.refusal(*_qkv(torch.bfloat16, d=d), pad=pad)
        assert got is not None and want is not None
        assert ("needs CUDA" in got[1]) == (pad or d != 192)
        assert ("needs CUDA" in want[1]) == (pad or d != 192)


def test_default_attention_takes_the_plain_path_where_the_kernel_cannot():
    """``use_flash_attention=None`` on CPU tensors (where no kernel runs) is
    the chunked ``causal_attention``; ``True`` asks for the kernel path, its
    plain dense version on the CPU; the two agree."""
    from repro_torch.configs import get_arch
    from repro_torch.models import layers as L
    cfg = get_arch("stablelm_3b").model.reduced(n_layers=1, d_model=64) \
        .with_overrides(dtype="float32")
    gen = torch.Generator().manual_seed(0)
    p = L.attn_init(gen, cfg)
    x = torch.randn(2, 16, cfg.d_model, generator=gen)
    plain, _ = L.attn_apply(p, cfg.with_overrides(use_flash_attention=False),
                            x)
    default, _ = L.attn_apply(p, cfg, x)
    asked, _ = L.attn_apply(p, cfg.with_overrides(use_flash_attention=True),
                            x)
    assert torch.equal(default, plain)
    torch.testing.assert_close(asked, plain, rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------- #
# the kernels' Functions under torch.func: the vmap rule folds each mapped
# axis into the batch axis (on CPU tensors the Functions run the plain
# forward and backward, so the plumbing the card runs is exercised here)
# ----------------------------------------------------------------------- #


def _function(q, k, v, window=None, q_offset=0):
    from repro_torch.kernels.flash_attention import FlashAttention
    return FlashAttention.apply(q, k, v, True, window, q_offset)[0]


def _plain(q, k, v, window=None, q_offset=0):
    return attention_ref(q, k, v, causal=True, window=window,
                         q_offset=q_offset)


def _grad_bar(want):
    """Float32 gradients summed in another order: within 1e-5 of the
    largest entry."""
    return 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_of_the_plain_forward(case):
    """``attention_bwd_ref`` (what the backward kernels compute, and what
    ``FlashBackward`` runs on CPU tensors) and ``attention_fwd_ref``'s
    ``lse`` give autograd's gradients of ``attention_ref``."""
    from repro_torch.kernels.flash_attention import (attention_bwd_ref,
                                                     attention_fwd_ref)
    b, sq, sk, h, kv, d, window, q_offset = case
    q, k, v, dout = map(torch.tensor, _inputs(b, sq, sk, h, kv, d, 7))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    o, lse = attention_fwd_ref(q, k, v, **kw)
    assert torch.equal(o, attention_ref(q, k, v, **kw))
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves, **kw), leaves, dout)
    got = attention_bwd_ref(q, k, v, o, lse, dout, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=0, atol=_grad_bar(w))


@pytest.mark.parametrize("dims", [(0, 0, 0), (2, None, None), (None, 1, 0),
                                  (3, 3, 3)])
def test_vmap_rule_folds_as_vmap_of_the_plain_version(dims):
    """One level of ``vmap``, with q, k or v unmapped and the mapped axis
    not first: the Function's fold-and-unfold rule gives ``vmap`` of the
    plain version, and ``grad`` through it the plain gradient."""
    from torch.func import grad, vmap
    gen = torch.Generator().manual_seed(sum(d or 0 for d in dims))
    shapes = {"q": (2, 24, 4, 64), "k": (2, 24, 2, 64)}

    def arg(name, dim):
        shape = shapes["q" if name == "q" else "k"]
        if dim is None:
            return torch.randn(shape, generator=gen)
        return torch.randn(shape[:dim] + (3,) + shape[dim:], generator=gen)

    q, k, v = (arg(n, d) for n, d in zip("qkv", dims))
    w = torch.randn((3,) + shapes["q"], generator=gen)
    got = vmap(_function, in_dims=dims)(q, k, v)
    want = vmap(_plain, in_dims=dims)(q, k, v)
    assert got.shape == want.shape == (3,) + shapes["q"]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)

    def loss(attend):
        return lambda q, k, v: (vmap(attend, in_dims=dims)(q, k, v)
                                * w).sum()

    g = grad(loss(_function), argnums=(0, 1, 2))(q, k, v)
    gw = grad(loss(_plain), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, gw):
        torch.testing.assert_close(a, b, rtol=0, atol=_grad_bar(b))


def test_nested_vmap_of_grad_is_one_call_each_way():
    """``vmap`` over lanes of ``vmap`` over workers of ``grad_and_value``,
    as the simulator takes per-worker gradients: the plain forward and
    backward run once each, over the folded [lanes x workers x B] batch, and
    agree with the plain version under the same transforms."""
    from torch.func import grad_and_value, vmap

    from repro_torch.kernels.flash_attention import flash as FK
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(3, 4, 16, 2, 64, generator=gen)      # workers
    p = torch.randn(2, 64, generator=gen)                # lanes
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = FK.attention_fwd_ref, FK.attention_bwd_ref

    def spy(name, fn):
        def run(q, *args, **kw):
            calls[name].append(tuple(q.shape))
            return fn(q, *args, **kw)
        return run

    def loss(attend):
        def f(pl, xw):
            q = xw * pl
            return (attend(q, xw, xw + pl) ** 2).sum()
        return f

    def lanes(attend):
        return vmap(vmap(grad_and_value(loss(attend)), in_dims=(None, 0)),
                    in_dims=(0, None))

    FK.attention_fwd_ref, FK.attention_bwd_ref = spy("fwd", fwd), spy(
        "bwd", bwd)
    try:
        (g, val) = lanes(_function)(p, x)
    finally:
        FK.attention_fwd_ref, FK.attention_bwd_ref = fwd, bwd
    assert calls == {"fwd": [(24, 16, 2, 64)], "bwd": [(24, 16, 2, 64)]}
    gw, vw = lanes(_plain)(p, x)
    assert g.shape == gw.shape == (2, 3, 64)
    torch.testing.assert_close(val, vw, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g, gw, rtol=0, atol=_grad_bar(gw))


@pytest.mark.parametrize("case", ["ok", "float16", "head_dim_48", "strided",
                                  "window"])
def test_refusal_reads_the_same_under_vmap(case):
    """``refusal`` on a tensor under ``vmap`` (no storage, no data
    pointer) says what it says on the real tensor it stands for."""
    from torch.func import vmap

    from repro_torch.kernels.flash_attention import flash as FK
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    d = 48 if case == "head_dim_48" else 64
    q = torch.zeros(3, 1, 8, 2, d, dtype=dtype)
    k = torch.zeros(3, 1, 8, 2, d, dtype=dtype)
    dim = 3 if case == "strided" else 0
    if case == "strided":
        q = q.movedim(0, 3).contiguous()  # [1, 8, 2, 3, d]: lane axis 3
    window = 0 if case == "window" else None
    seen = []
    vmap(lambda q, k: seen.append(FK.refusal(q, k, k, True, window))
         or q.sum(), in_dims=(dim, 0))(q, k)
    real = FK.refusal(q.select(dim, 0), k[0], k[0], True, window)
    assert seen == [real]
    assert real is not None  # on the CPU every case is refused, for a reason
    if case == "ok":
        assert "needs CUDA" in real[1]


def test_head_dim_112_is_built_and_192_is_taken_through_the_zero_pad():
    """zamba2's 112 is built at bfloat16 (no pad: the launch takes it as it
    is); ``refusal(pad=True)`` takes a head dim up to 256 that the kernel is
    not built for (192: padded to 256), the launch itself does not; 256
    (gemma_2b's) is built; 320 stays refused either way."""
    from repro_torch.kernels.flash_attention import flash as FK
    q, k, v = _qkv(d=112)
    assert FK.padded_dim(112) == 112 and FK.padded_dim(80) == 80
    assert FK.padded_dim(256) == 256 and FK.padded_dim(192) == 256
    assert FK.padded_dim(320) == 320 and 256 in FK.HEAD_DIMS
    assert 112 in FK.HEAD_DIMS
    for pad in (False, True):  # only the device
        why = FK.refusal(q, k, v, True, None, 0, pad=pad)
        assert why is not None and "needs CUDA" in why[1]
    q, k, v = _qkv(d=192)
    assert "head dims" in FK.refusal(q, k, v)[1]
    for d in (192, 256):
        q, k, v = _qkv(d=d)
        why = FK.refusal(q, k, v, True, None, 0, pad=True)
        assert why is not None and "needs CUDA" in why[1]
    q, k, v = _qkv(d=320)
    assert "head dims" in FK.refusal(q, k, v, pad=True)[1]


def _padded_equals_unpadded(d, dp, causal, window, q_offset, kv, h=4,
                            sq=48, seed=0):
    """The plain attention and the kernels' plain forward and backward
    (``FlashAttention`` on CPU tensors) through ``padded_attention`` (q, k,
    v zero-padded from ``d`` to ``dp``, the softmax scale 1/sqrt(d) passed
    on, the output sliced back) equal the plain attention at ``d``, forward
    and gradient (float32, within 1e-5 of the largest entry)."""
    from repro_torch.kernels.flash_attention import (FlashAttention,
                                                     attention_ref,
                                                     padded_attention)
    rng = np.random.default_rng(seed)
    sk = sq + q_offset
    mk = lambda *s: torch.tensor(  # noqa: E731
        rng.normal(size=s).astype(np.float32), requires_grad=True)
    q, k, v = mk(2, sq, h, d), mk(2, sk, kv, d), mk(2, sk, kv, d)
    dout = torch.tensor(rng.normal(size=(2, sq, h, d)).astype(np.float32))

    def ref(q, k, v, causal, window, q_offset, scale=None):
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, scale=scale)

    def kernel_plain(q, k, v, causal, window, q_offset, scale=None):
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    scale)[0]

    want = ref(q, k, v, causal, window, q_offset)
    gw = torch.autograd.grad(want, (q, k, v), dout)
    for attend in (ref, kernel_plain):
        got = padded_attention(attend, q, k, v, dp, causal, window,
                               q_offset)
        assert got.shape == want.shape
        gg = torch.autograd.grad(got, (q, k, v), dout)
        for a, b in [(got, want)] + list(zip(gg, gw)):
            scale = float(b.detach().abs().max())
            assert float((a - b).detach().abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("causal,window,q_offset,kv",
                         [(True, None, 0, 4), (True, 24, 0, 2),
                          (True, None, 16, 1)])
def test_padded_plain_path_equals_unpadded_attention_at_head_dim_112(
        causal, window, q_offset, kv):
    """zamba2's head dim: 112 zero-padded to 128 equals the plain
    attention at 112 (:func:`_padded_equals_unpadded`)."""
    _padded_equals_unpadded(112, 128, causal, window, q_offset, kv,
                            seed=kv)


@pytest.mark.parametrize("window,q_offset", [(None, 0), (24, 16)])
def test_head_dim_192_pads_to_256_and_equals_the_unpadded_attention(
        window, q_offset):
    """A head dim between 128 and 256 is zero-padded to 256, the
    reference's next multiple of 128, and equals the plain attention at
    192 (:func:`_padded_equals_unpadded`), MQA."""
    from repro_torch.kernels.flash_attention import padded_dim
    assert padded_dim(192) == 256
    _padded_equals_unpadded(192, 256, True, window, q_offset, kv=1, sq=40,
                            seed=192 + q_offset)


def test_bf16_at_head_dim_112_unpadded_matches_the_reference():
    """zamba2's head dim at bfloat16 through the port's routing of 112 (no
    pad, the default scale 1/sqrt(112): what the card launches), here on
    the kernels' plain version, against the reference's
    ``ops.attention`` on the CPU (its Pallas kernel in interpret mode,
    which pads to 128 and pre-scales q by sqrt(128/112) in bfloat16) and
    the gradients against ``jax.grad`` of its ``attention_ref`` in float32
    from the same bfloat16 inputs: out within 1e-2 and dq, dk, dv within
    2e-2 of the largest entry (the card's bars: bf16 outputs, P and dS
    rounded to bf16, and the reference's bf16 pre-scaled q)."""
    from repro.kernels.flash_attention import attention as jax_attention
    from repro_torch.kernels.flash_attention import FlashAttention
    from repro_torch.kernels.flash_attention import ops as FO
    rng = np.random.default_rng(112)
    shapes = ((2, 48, 4, 112), (2, 48, 2, 112), (2, 48, 2, 112),
              (2, 48, 4, 112))
    q, k, v, dout = (np.asarray(jnp.asarray(rng.normal(size=s), jnp.bfloat16)
                                .astype(jnp.float32)) for s in shapes)
    seen = []

    def attend(q, k, v, causal, window, q_offset, scale=None):
        seen.append((q.shape[-1], scale))
        return FlashAttention.apply(q, k, v, causal, window, q_offset,
                                    scale)[0]
    leaves = [torch.tensor(a).to(torch.bfloat16).requires_grad_()
              for a in (q, k, v)]
    got = FO.kernel_attention(attend, *leaves, True, None, 0)
    grads = torch.autograd.grad(got, leaves, torch.tensor(dout).to(
        torch.bfloat16))
    assert seen == [(112, None)]
    jb = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    want = np.asarray(jax_attention(*jb, use_pallas=True, interpret=True),
                      np.float32)

    def jloss(q, k, v):
        return jnp.sum(jax_attention_ref(q, k, v) * dout)

    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    for a, w, tol in [(got, want, 1e-2)] + [
            (g, np.asarray(wg), 2e-2) for g, wg in zip(grads, want_grads)]:
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        err = np.abs(a.detach().float().numpy() - w).max()
        assert err <= tol * np.abs(w).max()
