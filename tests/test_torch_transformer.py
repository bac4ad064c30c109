"""The decoder of the port against the reference's, on every ported
architecture reduced (stablelm_3b: MHA, LayerNorm, SwiGLU; qwen25_3b: GQA,
QKV bias; gemma_2b: MQA, GeGLU, tied embeddings; mistral_large_123b;
musicgen_medium: frame embeddings and targets; llama32_vision_11b: gated
cross-attention over image embeddings) in float32: hidden states,
``lm_loss`` and its gradients with the reference's parameters carried
across, plus the pieces (rope, norms, chunked cross entropy) and the
configuration registry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.utils import tree as JTree
from repro_torch.configs import PORTED_ARCHS, get_arch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.testing import from_jax_params
from repro_torch.utils.tree import make_flat_spec, tree_leaves

SEQ, BATCH = 48, 2


def _configs(arch):
    jcfg = jax_get_arch(arch).model.reduced(n_layers=2, d_model=256) \
        .with_overrides(dtype="float32")
    cfg = get_arch(arch).model.reduced(n_layers=2, d_model=256) \
        .with_overrides(dtype="float32")
    return jcfg, cfg


def _np_batch(cfg, rng):
    """Tokens, or frame embeddings and targets; the vlm's image
    embeddings."""
    if cfg.input_kind == "tokens":
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}
    else:
        batch = {"embeddings": rng.normal(size=(BATCH, SEQ, cfg.d_model)),
                 "targets": rng.integers(0, cfg.vocab_size, (BATCH, SEQ))}
    if cfg.family == "vlm":
        batch["image_embeddings"] = rng.normal(
            size=(BATCH, cfg.n_image_tokens, cfg.d_model))
    return {k: v.astype(np.int32 if v.dtype.kind == "i" else np.float32)
            for k, v in batch.items()}


def _torch_batch(model):
    return {k: torch.tensor(v) for k, v in model["batch"].items()}


@pytest.fixture(scope="module", params=PORTED_ARCHS)
def model(request):
    """Reference parameters, batch, and the reference's hidden states, loss
    and gradients, computed once per architecture."""
    jcfg, cfg = _configs(request.param)
    jparams = JT.model_init(jax.random.PRNGKey(3), jcfg)
    # qkv biases and the vlm's gates start at zero: give them values so
    # their gradients and effect are checked
    jparams = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.01 * jax.random.normal(
            jax.random.PRNGKey(len(path)), a.shape)
        if any(getattr(k, "key", None) in ("b", "gate") for k in path)
        else a, jparams)
    np_batch = _np_batch(cfg, np.random.default_rng(4))
    batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    hidden, _, aux = JT.forward(jparams, jcfg, batch, mode="train")
    loss, grads = jax.value_and_grad(JT.lm_loss)(jparams, jcfg, batch)
    np_params = jax.tree.map(np.asarray, jparams)
    return {"cfg": cfg, "jcfg": jcfg, "params": np_params, "batch": np_batch,
            "hidden": np.asarray(hidden), "loss": float(loss),
            "moe_loss": float(aux["moe_loss"]),
            "grads": jax.tree.map(np.asarray, grads)}


def test_hidden_states_match(model):
    """rtol/atol 1e-4: float32 matmuls and transcendental functions in
    other implementations, over 2 layers."""
    params = from_jax_params(model["params"])
    hidden, _, aux = T.forward(params, model["cfg"], _torch_batch(model))
    np.testing.assert_allclose(hidden.numpy(), model["hidden"], rtol=1e-4,
                               atol=1e-4)
    # the MoE layers' aux loss (0 for the other families)
    assert float(aux["moe_loss"]) == pytest.approx(model["moe_loss"],
                                                   rel=1e-5)


def test_lm_loss_and_gradients_match(model):
    """Loss within rtol 1e-5; every gradient leaf within atol 1e-5 of the
    leaf's largest entry plus rtol 1e-3 (float32 sums in other orders; the
    embedding and head gradients sum over all tokens)."""
    params = from_jax_params(model["params"])
    leaves = [t.requires_grad_() for t in tree_leaves(params)]
    loss = T.lm_loss(params, model["cfg"], _torch_batch(model))
    assert float(loss.detach()) == pytest.approx(model["loss"], rel=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = tree_leaves(model["grads"])
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3,
                                   atol=1e-5 * max(scale, 1e-3))


def test_plain_attention_path_matches_kernel_path(model):
    """``use_flash_attention=False`` (chunked ``causal_attention``) and the
    kernel path asked for with ``True`` (its dense plain version on the
    CPU) give the same loss."""
    params = from_jax_params(model["params"])
    batch = _torch_batch(model)
    a = T.lm_loss(params, model["cfg"].with_overrides(
        use_flash_attention=True), batch)
    b = T.lm_loss(params, model["cfg"].with_overrides(
        use_flash_attention=False), batch)
    assert float(a) == pytest.approx(float(b), rel=1e-6)


def test_flat_layout_matches_reference(model):
    """Same leaves, same order, same shapes: the flat vector is the
    reference's (the server bank's layout)."""
    jleaves, _ = jax.tree_util.tree_flatten(model["params"])
    shape_only = T.model_init(model["cfg"], None, device="meta")
    assert [tuple(t.shape) for t in tree_leaves(shape_only)] == \
        [a.shape for a in jleaves]
    got = make_flat_spec(shape_only, pad_to=8)
    want = JTree.make_flat_spec(model["params"], pad_to=8)
    assert (got.size, got.padded_size) == (want.size, want.padded_size)


def test_stablelm_flat_width_at_full_width():
    """Full-width stablelm_3b cut to 1 and 2 layers: D = 336,870,400 and
    416,179,200, multiples of the 512-wide blocks (shape-only trees)."""
    for layers, want in ((1, 336_870_400), (2, 416_179_200)):
        cfg = get_arch("stablelm_3b").model.with_overrides(n_layers=layers)
        spec = make_flat_spec(T.model_init(cfg, None, device="meta"),
                              pad_to=8)
        jcfg = jax_get_arch("stablelm_3b").model.with_overrides(
            n_layers=layers)
        abstract = jax.eval_shape(
            lambda: JT.model_init(jax.random.PRNGKey(0), jcfg))
        assert spec.padded_size == want == JTree.make_flat_spec(
            abstract, pad_to=8).padded_size
        assert want % 512 == 0


@pytest.mark.parametrize("s,chunk", [(300, 128), (256, 64), (40, 64)])
def test_chunked_xent_matches(s, chunk):
    """Both branches (``s <= chunk`` and the padded per-chunk sum) against
    the reference, with a loss mask; rtol 1e-5."""
    jcfg, cfg = _configs("stablelm_3b")
    rng = np.random.default_rng(s)
    hidden = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    targets = rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    mask = (rng.uniform(size=(2, s)) < 0.8).astype(np.float32)
    head = (rng.normal(size=(cfg.d_model, cfg.vocab_size)) * 0.02
            ).astype(np.float32)
    want = JT.chunked_xent({"lm_head": head}, jcfg, hidden, targets, mask,
                           chunk=chunk)
    got = T.chunked_xent({"lm_head": torch.tensor(head)}, cfg,
                         torch.tensor(hidden), torch.tensor(targets),
                         torch.tensor(mask), chunk=chunk)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_rope_rotates_interleaved_pairs():
    """Lanes (0, 1), (2, 3), ... rotate together, as the reference's
    ``apply_rope`` (not the half split)."""
    x = np.random.default_rng(0).normal(size=(2, 16, 3, 8)).astype(
        np.float32)
    pos = np.arange(5, 21)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), 1e4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # position 0 leaves x as it is; lane pairs keep their norm
    at0 = L.apply_rope(torch.tensor(x), torch.zeros(16, dtype=torch.long),
                       1e4)
    assert torch.equal(at0, torch.tensor(x))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_uses_eps_1e6_in_float32(kind):
    x = (np.random.default_rng(1).normal(size=(3, 64)) * 1e-3).astype(
        np.float32)
    p = {"scale": np.linspace(0.5, 1.5, 64, dtype=np.float32)}
    if kind == "layernorm":
        p["bias"] = np.linspace(-1, 1, 64, dtype=np.float32)
    want = np.asarray(JL.norm_apply(jax.tree.map(jnp.asarray, p),
                                    jnp.asarray(x), kind))
    got = L.norm_apply(from_jax_params(p), torch.tensor(x), kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 32)).astype(np.float32)
    p = JL.mlp_init(jax.random.PRNGKey(0), 32, 64, kind)
    want = np.asarray(JL.mlp_apply(p, jnp.asarray(x), kind))
    got = L.mlp_apply(from_jax_params(jax.tree.map(np.asarray, p)),
                      torch.tensor(x), kind).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_model_config_fields_and_reduced_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(JModelConfig)]
    tf_ = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    assert jf == tf_
    for arch in PORTED_ARCHS:
        jm, m = jax_get_arch(arch).model, get_arch(arch).model
        assert dataclasses.asdict(jm) == dataclasses.asdict(m)
        assert dataclasses.asdict(jm.reduced()) == dataclasses.asdict(
            m.reduced())
        assert jm.resolved_head_dim == m.resolved_head_dim


def test_unknown_arch_and_family_raise():
    """Every architecture of the reference builds; an unknown arch raises
    ``KeyError`` and an unknown family ``ValueError``."""
    from repro_torch.configs import ARCH_IDS
    assert PORTED_ARCHS == ARCH_IDS
    with pytest.raises(KeyError):
        get_arch("no_such_arch")
    with pytest.raises(ValueError, match="unknown family"):
        T.model_init(ModelConfig(family="rnn"), None, device="meta")
    with pytest.raises(ValueError, match="unknown family"):
        T.cache_init(ModelConfig(family="rnn"), 1, 8, device="meta")
