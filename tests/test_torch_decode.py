"""Prefill and greedy decode over KV caches: the port against the
reference, on the configurations of ``tests/test_models.py`` that the
attention families cover (``dense``, ``geglu_mqa``, ``window``, ``vlm``,
``audio``), in float32 with the reference's parameters carried across.

The pieces (``prefill_cache_write``, ``ring_cache_update``,
``decode_attention``) against the reference's functions; prefill hidden
states and caches, then decode steps; ``lm_loss`` and its gradients for the
vlm and the audio model; greedy tokens of ``make_decode_step`` (the one-hot
feed of embedding models included); ``launch.serve.run`` on the CPU
against the reference's CPU branch; the flat layout of the new trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import decode as JD
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.utils import tree as JTree
from repro_torch.launch import serve
from repro_torch.models import decode as D
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.testing import from_jax_params
from repro_torch.utils.tree import make_flat_spec, tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# float32 matmuls and softmaxes summed in other orders, over 2-4 layers
TOL = dict(rtol=1e-4, atol=1e-4)

_BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
             vocab_size=128, dtype="float32")

# tests/test_models.py:25-45, the attention families
CONFIGS = {
    "dense": dict(family="dense", qkv_bias=True),
    "geglu_mqa": dict(family="dense", n_kv_heads=1, mlp="geglu", head_dim=32,
                      tie_embeddings=True),
    "window": dict(family="dense", sliding_window=8),
    "vlm": dict(family="vlm", cross_attn_every=2, n_layers=4,
                n_image_tokens=8),
    "audio": dict(family="audio", n_kv_heads=4, input_kind="embeddings",
                  mlp="gelu", norm="layernorm"),
}


def _cfgs(name, **over):
    kw = {**_BASE, **CONFIGS[name], **over}
    return JModelConfig(name=name, **kw), ModelConfig(name=name, **kw)


def _params(jcfg, seed=0):
    """The reference's parameters, with the zero-initialised ones (biases,
    the vlm's gates) given values so that they count."""
    jp = JT.model_init(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 * jax.random.normal(
            jax.random.PRNGKey(len(path)), a.shape)
        if any(getattr(k, "key", None) in ("b", "gate") for k in path)
        else a, jp)
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _batch(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.input_kind == "tokens":
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    else:
        out["embeddings"] = rng.normal(size=(b, s, cfg.d_model)).astype(
            np.float32)
        out["targets"] = rng.integers(0, cfg.vocab_size, (b, s)).astype(
            np.int32)
    if cfg.family == "vlm":
        out["image_embeddings"] = rng.normal(
            size=(b, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _sub(batch, sl):
    return {k: (v if k == "image_embeddings" else v[:, sl])
            for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _close_trees(got, want, **tol):
    gl, wl = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl) > 0
    for g, w in zip(gl, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)


# ----------------------------------------------------------------------- #
# the cache pieces
# ----------------------------------------------------------------------- #


def _kv(b, s, kv, dh, seed):
    return np.random.default_rng(seed).normal(size=(b, s, kv, dh)).astype(
        np.float32)


@pytest.mark.parametrize("s,w,window", [(5, 8, None), (8, 8, None),
                                        (3, 8, 8), (8, 8, 8), (11, 8, 8),
                                        (16, 8, 8), (21, 8, 8), (9, 4, 4)])
def test_prefill_cache_write_matches(s, w, window):
    """S < W and S == W (slots [0, S)), S > W (the last W, position p at
    slot p % W, every roll shift): bitwise the reference's cache, written
    in place."""
    fresh = _kv(2, s, 3, 4, s)
    cache0 = _kv(2, w, 3, 4, 99)  # nonzero, so untouched slots show
    want = np.asarray(JL.prefill_cache_write(jnp.asarray(cache0),
                                             jnp.asarray(fresh), window))
    cache = torch.from_numpy(cache0.copy())
    got = L.prefill_cache_write(cache, torch.from_numpy(fresh), window)
    assert got is cache
    np.testing.assert_array_equal(cache.numpy(), want)


def test_prefill_longer_than_a_full_cache_raises():
    with pytest.raises(ValueError, match="does not fit"):
        L.prefill_cache_write(torch.zeros(1, 4, 1, 2), torch.zeros(1, 5, 1, 2),
                              None)


@pytest.mark.parametrize("pos", [0, 3, 7, 8, 13])
def test_ring_cache_update_matches(pos):
    ck0, cv0 = _kv(2, 8, 2, 4, 1), _kv(2, 8, 2, 4, 2)
    k, v = _kv(2, 1, 2, 4, 3), _kv(2, 1, 2, 4, 4)
    wk, wv = JL.ring_cache_update(jnp.asarray(ck0), jnp.asarray(cv0),
                                  jnp.asarray(k), jnp.asarray(v), pos)
    ck, cv = torch.from_numpy(ck0.copy()), torch.from_numpy(cv0.copy())
    gk, gv = L.ring_cache_update(ck, cv, torch.from_numpy(k),
                                 torch.from_numpy(v), pos)
    assert gk is ck and gv is cv
    np.testing.assert_array_equal(ck.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(cv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("pos", range(13))
def test_decode_attention_matches(window, pos):
    """A full cache of 13 slots at every position, and a ring of 5 through
    every wrap phase (pos 0-4 filling, then each slot as the newest twice);
    GQA 6:2 heads; rtol/atol 1e-5."""
    w = 5 if window else 13
    ck, cv = _kv(2, w, 2, 8, 5), _kv(2, w, 2, 8, 6)
    q = _kv(2, 1, 6, 8, 7 + pos)
    want = np.asarray(JL.decode_attention(jnp.asarray(q), jnp.asarray(ck),
                                          jnp.asarray(cv), pos, window))
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(ck),
                             torch.from_numpy(cv), pos, window).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_causal_attention_kv_len_matches():
    q, k, v = _kv(2, 6, 4, 8, 1), _kv(2, 9, 2, 8, 2), _kv(2, 9, 2, 8, 3)
    want = JL.causal_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), 3, kv_len=7)
    got = L.causal_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), 3, kv_len=7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ----------------------------------------------------------------------- #
# prefill and decode through the stack
# ----------------------------------------------------------------------- #

PROMPT, STEPS = 12, 3  # the window config's ring (W = 8) wraps in prefill


@pytest.fixture(scope="module", params=list(CONFIGS))
def served(request):
    """The reference's prefill hidden states and caches, then STEPS decode
    steps (hidden states and caches after each), teacher-forced."""
    name = request.param
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg)
    b = 2
    batch = _batch(cfg, b, PROMPT + STEPS)
    caches = JT.cache_init(jcfg, b, PROMPT + STEPS, dtype=jnp.float32)
    h, caches, _ = JT.forward(jp, jcfg, _j(_sub(batch, slice(0, PROMPT))),
                              mode="prefill", pos=0, caches=caches)
    want = [(np.asarray(h), jax.tree.map(np.asarray, caches))]
    for i in range(STEPS):
        at = PROMPT + i
        h, caches, _ = JT.forward(jp, jcfg, _j(_sub(batch, slice(at, at + 1))),
                                  mode="decode", pos=at, caches=caches)
        want.append((np.asarray(h), jax.tree.map(np.asarray, caches)))
    return {"name": name, "cfg": cfg, "params": tp, "batch": batch,
            "want": want, "b": b}


def test_prefill_then_decode_match_reference(served):
    """Hidden states (rtol/atol 1e-4) and every cache leaf after the
    prefill and after each decode step; the caches are written in place
    (the same tensors come back)."""
    cfg, tp, batch, b = (served[k] for k in ("cfg", "params", "batch", "b"))
    caches = T.cache_init(cfg, b, PROMPT + STEPS, dtype=torch.float32)
    leaves = tree_leaves(caches)
    h, out, aux = T.forward(tp, cfg, _t(_sub(batch, slice(0, PROMPT))),
                            mode="prefill", pos=0, caches=caches)
    assert out is caches and float(aux["moe_loss"]) == 0.0
    got = [(h.numpy(), tree_map(lambda a: a.clone(), caches))]
    for i in range(STEPS):
        at = PROMPT + i
        h, out, _ = T.forward(tp, cfg, _t(_sub(batch, slice(at, at + 1))),
                              mode="decode", pos=at, caches=caches)
        got.append((h.numpy(), tree_map(lambda a: a.clone(), caches)))
    assert all(a is c for a, c in zip(tree_leaves(caches), leaves))
    for (gh, gc), (wh, wc) in zip(got, served["want"]):
        np.testing.assert_allclose(gh, wh, **TOL)
        _close_trees(gc, wc, **TOL)


def test_decode_matches_train_forward(served):
    """Self-consistency on the port alone, as the reference's
    ``test_decode_matches_full_forward``: each decode step's hidden state is
    the train-mode forward's at that position (rtol/atol 1e-4)."""
    cfg, tp, batch, b = (served[k] for k in ("cfg", "params", "batch", "b"))
    full, none, _ = T.forward(tp, cfg, _t(batch), mode="train")
    assert none is None
    caches = T.cache_init(cfg, b, PROMPT + STEPS, dtype=torch.float32)
    pre, _, _ = T.forward(tp, cfg, _t(_sub(batch, slice(0, PROMPT))),
                          mode="prefill", pos=0, caches=caches)
    np.testing.assert_allclose(pre.numpy(), full[:, :PROMPT].numpy(), **TOL)
    for i in range(STEPS):
        at = PROMPT + i
        h, _, _ = T.forward(tp, cfg, _t(_sub(batch, slice(at, at + 1))),
                            mode="decode", pos=at, caches=caches)
        np.testing.assert_allclose(h[:, 0].numpy(), full[:, at].numpy(),
                                   **TOL)


def test_modes_need_caches_and_known_names():
    _, cfg = _cfgs("dense")
    tp = T.model_init(cfg, torch.Generator().manual_seed(0))
    toks = {"tokens": torch.zeros((1, 3), dtype=torch.long)}
    for mode in ("prefill", "decode"):
        with pytest.raises(ValueError, match="requires preallocated caches"):
            T.forward(tp, cfg, toks, mode=mode)
    with pytest.raises(ValueError, match="unknown forward mode"):
        T.forward(tp, cfg, toks, mode="score")


# ----------------------------------------------------------------------- #
# losses and gradients of the new families
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("name", ["vlm", "audio"])
def test_lm_loss_and_gradients_match(name):
    """Loss within rtol 1e-5; every gradient leaf within atol 1e-5 of the
    leaf's largest entry plus rtol 1e-3 (the bar of
    ``test_torch_transformer.py``); the vlm's gates and the audio model's
    targets included."""
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg)
    batch = _batch(cfg, 2, 16)
    loss, grads = jax.value_and_grad(JT.lm_loss)(jp, jcfg, _j(batch))
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    got = T.lm_loss(tp, cfg, _t(batch))
    assert float(got.detach()) == pytest.approx(float(loss), rel=1e-5)
    g = torch.autograd.grad(got, leaves)
    want = jax.tree_util.tree_leaves(grads)
    assert len(g) == len(want)
    for a, w in zip(g, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(float(np.abs(w).max()),
                                                   1e-3))


# ----------------------------------------------------------------------- #
# greedy decode and the serving launcher
# ----------------------------------------------------------------------- #


def test_one_hot_is_zero_past_the_width():
    tok = np.array([[0], [5], [63], [64], [127]], np.int32)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(tok), 64,
                                     dtype=jnp.float32))
    got = D.one_hot(torch.from_numpy(tok).long(), 64)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[3:].abs().sum()) == 0.0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_make_decode_step_tokens_match(name):
    """Greedy tokens of ``make_decode_step`` equal the reference's over 4
    steps after a prefill; the audio model starts from ids >= d_model
    (all-zero one-hot rows)."""
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg)
    b, s, steps = 3, 6, 4
    batch = _batch(cfg, b, s, seed=7)
    jc = JT.cache_init(jcfg, b, s + steps, dtype=jnp.float32)
    tc = T.cache_init(cfg, b, s + steps, dtype=torch.float32)
    _, jc, _ = JT.forward(jp, jcfg, _j(batch), mode="prefill", caches=jc)
    T.forward(tp, cfg, _t(batch), mode="prefill", caches=tc)
    start = np.array([[cfg.d_model + 3], [cfg.vocab_size - 1], [1]],
                     np.int32) if cfg.input_kind == "embeddings" else \
        batch["tokens"][:, -1:]
    img = batch.get("image_embeddings")
    jstep = JD.make_decode_step(jcfg, None if img is None else
                                jnp.asarray(img))
    tstep = D.make_decode_step(cfg, None if img is None else
                               torch.from_numpy(img))
    jt, tt = jnp.asarray(start), torch.from_numpy(start).long()
    for i in range(steps):
        jt, jc = jstep(jp, jt, jc, jnp.asarray(s + i, jnp.int32))
        tt, tc = tstep(tp, tt, tc, s + i)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def _reference_serve(arch, b, s, tokens):
    """The reference launcher's CPU branch (``repro/launch/serve.py``),
    step for step; returns its parameters and generated tokens."""
    cfg = jax_get_arch(arch).model.reduced(n_layers=2, d_model=256) \
        .with_overrides(vocab_size=512, dtype="float32")
    rng = np.random.default_rng(0)
    params = JT.model_init(jax.random.PRNGKey(0), cfg)
    batch = {}
    if cfg.input_kind == "tokens":
        batch["tokens"] = jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)),
                                      jnp.int32)
    else:
        batch["embeddings"] = jnp.asarray(rng.normal(size=(b, s, cfg.d_model)),
                                          jnp.float32)
    if cfg.family == "vlm":
        batch["image_embeddings"] = jnp.asarray(
            rng.normal(size=(b, cfg.n_image_tokens, cfg.d_model)),
            jnp.float32)
    caches = JT.cache_init(cfg, b, s + tokens)
    hidden, caches, _ = JT.forward(params, cfg, batch, mode="prefill", pos=0,
                                   caches=caches)
    tok = jnp.argmax(JT.logits_fn(params, cfg, hidden[:, -1:]), -1)
    step = JD.make_decode_step(cfg, batch.get("image_embeddings"))
    out = [tok]
    for i in range(tokens - 1):
        tok, caches = step(params, tok, caches, jnp.asarray(s + i, jnp.int32))
        out.append(tok)
    return params, np.concatenate([np.asarray(t) for t in out], axis=1)


@pytest.mark.parametrize("arch", ["llama32_vision_11b", "musicgen_medium",
                                  "gemma_2b"])
def test_serve_run_on_cpu_matches_reference_cpu_branch(arch):
    """``launch.serve.run --device cpu`` on the reference's parameters:
    the same reduced model, prompts and generated tokens."""
    b, s, tokens = 2, 8, 5
    jparams, want = _reference_serve(arch, b, s, tokens)
    log = []
    res = serve.run(["--arch", arch, "--device", "cpu", "--batch", str(b),
                     "--prompt-len", str(s), "--tokens", str(tokens)],
                    params=from_jax_params(jax.tree.map(np.asarray, jparams)),
                    log=log.append)
    assert res["tokens"].shape == (b, tokens)
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    assert res["peak_mib"] is None and res["decode_ms_per_step"] > 0
    assert log[1].startswith("[serve] prefill") and "tokens/s" in log[2]


def test_serve_run_draws_its_own_parameters_on_the_cpu():
    res = serve.run(["--arch", "musicgen_medium", "--device", "cpu",
                     "--batch", "1", "--prompt-len", "4", "--tokens", "3",
                     "--n-layers", "1"], log=lambda *_: None)
    assert res["cfg"].n_layers == 1 and res["cfg"].d_model == 256
    assert res["tokens"].shape == (1, 3)
    assert bool(torch.isfinite(res["prefill_hidden"]).all())


# ----------------------------------------------------------------------- #
# the flat layout of the new trees
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("name,over", [("vlm", {}), ("vlm", {"n_layers": 5}),
                                       ("audio", {})])
def test_flat_layout_matches_reference(name, over):
    """Same leaves, order, shapes and offsets as ``repro.utils.tree`` (the
    vlm's ``[g, per, ...]`` blocks, its cross blocks and gates, and a
    ``tail_blocks`` that is ``None`` at 4 layers and one block at 5)."""
    jcfg, cfg = _cfgs(name, **over)
    jp = JT.model_init(jax.random.PRNGKey(0), jcfg)
    tp = T.model_init(cfg, None, device="meta")
    assert (tp.get("tail_blocks") is None) == (jp.get("tail_blocks") is None)
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]
    got, want = make_flat_spec(tp, pad_to=8), JTree.make_flat_spec(jp,
                                                                    pad_to=8)
    assert (got.size, got.padded_size, got.offsets) == \
        (want.size, want.padded_size, want.offsets)
    back = from_jax_params(jax.tree.map(np.asarray, jp))
    assert ("tail_blocks" in back) == ("tail_blocks" in jp)
    np.testing.assert_array_equal(
        torch.cat([t.reshape(-1) for t in tree_leaves(back)]).numpy(),
        np.asarray(JTree.tree_ravel(jp)))
