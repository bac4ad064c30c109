"""The model zoo in the port: the registry (every architecture builds),
the allocate-once ``model_init``, the flat layout and caches at full size
(shape-only trees), the serve step under ``long_500k`` (the 8,192-token
ring), the train launcher's embedding and image batches, the MoE, MLA, SSM
and hybrid families' loss and gradients against the reference, and the
train launcher on the CPU for the audio and vlm models. The families'
forward in every mode and both launchers on the CPU for their
architectures are in ``tests/test_torch_zoo_families.py`` (the file was
split in two to share its time between two workers)."""

import collections
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ArchSpec as JArchSpec
from repro.configs.base import InputShape as JInputShape
from repro.configs.base import model_for_shape as j_model_for_shape
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.utils import tree as JTree
from repro_torch.configs import INPUT_SHAPES, PORTED_ARCHS, get_arch
from repro_torch.configs.base import ArchSpec, model_for_shape
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.testing import from_jax_params
from repro_torch.utils.tree import make_flat_spec, tree_leaves

NEW_ARCHS = ["gemma_2b", "mistral_large_123b", "musicgen_medium",
             "llama32_vision_11b"]
# the MoE, MLA, SSM and hybrid architectures
FAMILY_ARCHS = ["mamba2_1_3b", "deepseek_v2_lite_16b", "dbrx_132b",
                "zamba2_7b"]

SMALL = {
    "dense": ModelConfig(name="d", family="dense", n_layers=4, d_model=32,
                         n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=50,
                         qkv_bias=True, norm="layernorm"),
    "vlm": ModelConfig(name="v", family="vlm", n_layers=5, d_model=32,
                       n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=50,
                       cross_attn_every=2, n_image_tokens=4),
    "audio": ModelConfig(name="a", family="audio", n_layers=4, d_model=32,
                         n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=50,
                         mlp="gelu", input_kind="embeddings"),
}


# ----------------------------------------------------------------------- #
# the registry
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_every_arch_is_ported(arch):
    """``get_arch`` builds the reference's configuration field for field."""
    assert arch in PORTED_ARCHS
    jm, m = jax_get_arch(arch).model, get_arch(arch).model
    assert {f: getattr(m, f) for f in ModelConfig.__dataclass_fields__} == \
        {f: getattr(jm, f) for f in ModelConfig.__dataclass_fields__}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_families_build_at_full_size_on_meta(arch):
    """``model_init`` and ``cache_init`` of the full-size MoE, MLA, SSM and
    hybrid models (shape-only trees); an unknown family raises."""
    cfg = get_arch(arch).model
    p = T.model_init(cfg, None, device="meta")
    c = T.cache_init(cfg, 1, 8, device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(p) +
               tree_leaves(c))
    with pytest.raises(ValueError, match="unknown family"):
        T.model_init(cfg.with_overrides(family="unknown"), None,
                     device="meta")


# ----------------------------------------------------------------------- #
# model_init: each stacked leaf allocated once, the per-layer draws
# ----------------------------------------------------------------------- #


class _FreshBytes(TorchDispatchMode):
    """New CPU storage each op makes (outputs that share no storage with
    the op's inputs: not views, not in-place): its shapes, and the peak of
    the bytes of those storages still alive."""

    def __init__(self):
        super().__init__()
        self.live, self.peak, self.shapes = 0, 0, []

    def _free(self, nbytes):
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr()
                for t in _pytree.tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor) and t.device.type == "cpu"}
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu" and \
                    t.untyped_storage().data_ptr() not in seen:
                st = t.untyped_storage()
                self.live += st.nbytes()
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, st.nbytes())
                self.shapes.append(tuple(t.shape))
        return out


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("family", list(SMALL))
def test_model_init_allocates_each_leaf_once(family):
    """Each stacked leaf of the 4-layer blocks is allocated once (no stack
    of per-layer copies), and at its peak ``model_init`` holds the
    parameters, one fresh block and one leaf's draws, not the blocks
    twice (the vlm: 2 groups of 2 self-attention blocks and a cross
    block)."""
    cfg = SMALL[family]
    if family == "vlm":
        cfg = cfg.with_overrides(n_layers=6, cross_attn_every=3)
    with _FreshBytes() as seen:
        p = T.model_init(cfg, torch.Generator().manual_seed(0))
    lead = (2, 2) if family == "vlm" else (4,)  # the vlm: [g, per, ...]
    stacked = tree_leaves(p["blocks"])
    assert all(tuple(t.shape[:len(lead)]) == lead for t in stacked)
    n = math.prod(lead)
    made = collections.Counter(seen.shapes)
    flat = collections.Counter(
        [(n,) + tuple(t.shape[len(lead):]) for t in stacked]
        + [tuple(t.shape) for k in ("cross_blocks", "tail_blocks")
           if p.get(k) is not None for t in tree_leaves(p[k])])
    assert all(made[s] == c for s, c in flat.items()), seen.shapes
    leaves = tree_leaves(p)
    per = {"blocks": n, "cross_blocks": 2}  # blocks of each stack
    block = max(sum(_nbytes(t) for t in tree_leaves(p[k])) // m
                for k, m in per.items() if p.get(k) is not None)
    leaf = max([_nbytes(t) for k in ("embed", "lm_head") if k in p
                for t in [p[k]]] + [_nbytes(t) // n for t in stacked])
    assert seen.peak <= sum(_nbytes(t) for t in leaves) + block + leaf
    assert seen.live >= sum(_nbytes(t) for t in leaves)


def _per_layer_draws(cfg, gen):
    """The draws of fresh per-layer blocks stacked afterwards (what
    ``model_init`` computed before it allocated once)."""
    p = {}
    if cfg.input_kind == "tokens":
        p["embed"] = torch.randn((cfg.vocab_size, cfg.d_model),
                                 generator=gen) * 0.02
    p["final_norm"] = L.norm_init(cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings or cfg.input_kind != "tokens":
        p["lm_head"] = torch.randn((cfg.d_model, cfg.vocab_size),
                                   generator=gen) * 0.02

    def stack(make, n):
        if n == 0:
            return None
        blocks = [make(gen, cfg) for _ in range(n)]
        return jax.tree.map(lambda *ls: torch.stack(ls), *blocks)

    if cfg.family == "vlm":
        g, per, rem = T._vlm_groups(cfg)
        p["blocks"] = jax.tree.map(
            lambda a: a.reshape((g, per) + a.shape[1:]),
            stack(T._attn_block_init, g * per))
        p["cross_blocks"] = stack(T._cross_block_init, g)
        p["tail_blocks"] = stack(T._attn_block_init, rem)
    else:
        p["blocks"] = stack(T._attn_block_init, cfg.n_layers)
    return p


@pytest.mark.parametrize("family", list(SMALL))
def test_model_init_draws_are_the_per_layer_draws(family):
    """Bitwise the draws of fresh per-layer blocks from the same generator
    in the same order."""
    cfg = SMALL[family]
    got = T.model_init(cfg, torch.Generator().manual_seed(5))
    want = _per_layer_draws(cfg, torch.Generator().manual_seed(5))
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    assert all(torch.equal(a, b) for a, b in zip(gl, wl))


# ----------------------------------------------------------------------- #
# full-size shapes (shape-only trees)
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", NEW_ARCHS + FAMILY_ARCHS)
def test_full_size_flat_layout_matches_reference(arch):
    """The full-size tree on ``meta``: the reference's leaf shapes, order
    and flat width (JAX ``eval_shape``)."""
    tp = T.model_init(get_arch(arch).model, None, device="meta")
    jp = jax.eval_shape(lambda: JT.model_init(jax.random.PRNGKey(0),
                                              jax_get_arch(arch).model))
    assert [tuple(t.shape) for t in tree_leaves(tp)] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]
    got, want = make_flat_spec(tp, pad_to=8), JTree.make_flat_spec(jp,
                                                                    pad_to=8)
    assert (got.size, got.offsets) == (want.size, want.offsets)


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", NEW_ARCHS + ["qwen25_3b"] + FAMILY_ARCHS)
def test_cache_shapes_match_reference(arch, shape):
    """Caches for the decode shapes at full size: ``long_500k`` gives
    attention archs the 8,192-token window, so a ring of 8,192 slots."""
    cfg = model_for_shape(get_arch(arch), INPUT_SHAPES[shape])
    jcfg = j_model_for_shape(jax_get_arch(arch), J_SHAPES[shape])
    assert cfg.sliding_window == jcfg.sliding_window
    n = INPUT_SHAPES[shape].seq_len
    got = T.cache_init(cfg, 2, n, device="meta")
    want = jax.eval_shape(lambda: JT.cache_init(jcfg, 2, n))
    assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
            for t in tree_leaves(got)] == \
        [(a.shape, str(a.dtype)) for a in jax.tree_util.tree_leaves(want)]
    assert sorted(got) == sorted(want)
    if shape == "long_500k" and cfg.family not in ("ssm", "hybrid") and \
            not cfg.use_mla:
        assert tree_leaves(got)[0].shape[-3] == 8192


# ----------------------------------------------------------------------- #
# the serve step under long_500k: the real window, wrapped
# ----------------------------------------------------------------------- #


def test_serve_step_rings_at_the_long_context_window():
    """``build_serve_step`` on a narrow qwen25_3b: the prefill step of the
    ``long_500k`` model (the 8,192-token window) over a 9,216-token prompt
    wraps the ring, then 2 decode steps under ``long_500k``; logits and
    caches against the reference's serve steps (rtol/atol 1e-4)."""
    jm = jax_get_arch("qwen25_3b").model.reduced(n_layers=1, d_model=32) \
        .with_overrides(dtype="float32", n_heads=2, n_kv_heads=1,
                        head_dim=16, vocab_size=64)
    tm = ModelConfig(**{f: getattr(jm, f)
                        for f in ModelConfig.__dataclass_fields__})
    long_j, long_t = J_SHAPES["long_500k"], INPUT_SHAPES["long_500k"]
    jspec, tspec = JArchSpec(model=jm, citation=""), ArchSpec(model=tm,
                                                              citation="")
    s, steps = 9216, 2
    toks = np.random.default_rng(0).integers(0, 64, (1, s + steps)) \
        .astype(np.int32)
    jp = JT.model_init(jax.random.PRNGKey(1), jm)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jwin = JArchSpec(model=j_model_for_shape(jspec, long_j), citation="")
    twin = ArchSpec(model=model_for_shape(tspec, long_t), citation="")
    jc = JT.cache_init(jwin.model, 1, s + steps)
    tc = T.cache_init(twin.model, 1, s + steps)
    assert tree_leaves(tc)[0].shape[2] == 8192
    jl, jc = JS.build_serve_step(jwin, JInputShape("p", s, 1, "prefill"),
                                 None)(jp, {"tokens": jnp.asarray(
                                     toks[:, :s])}, jc)
    tl, tc = S.build_serve_step(twin, long_t.__class__("p", s, 1,
                                                       "prefill"))(
        tp, {"tokens": torch.from_numpy(toks[:, :s])}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)
    jdec = JS.build_serve_step(jspec, long_j, None)
    tdec = S.build_serve_step(tspec, long_t)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        jl, jc = jdec(jp, {"tokens": jnp.asarray(tok)}, jc,
                      jnp.asarray(s + i, jnp.int32))
        tl, tc = tdec(tp, {"tokens": torch.from_numpy(tok)}, tc, s + i)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)


# ----------------------------------------------------------------------- #
# the train launcher's batches for embedding inputs and the vlm
# ----------------------------------------------------------------------- #


def _reference_make_batch(gen, cfg, n, lb, seq):
    """``make_batch`` of ``repro/launch/train.py:105-120`` (a closure
    there), line for line."""
    toks = gen.integers(0, cfg.vocab_size, (n, lb, seq))
    toks[..., 1::2] = (toks[..., 0::2] + 1) % cfg.vocab_size
    batch = {"tokens": np.asarray(toks, np.int32)}
    if cfg.input_kind != "tokens":
        batch = {
            "embeddings": np.asarray(gen.normal(size=(n, lb, seq,
                                                      cfg.d_model)),
                                     np.float32),
            "targets": np.asarray(toks % cfg.vocab_size, np.int32),
        }
    if cfg.family == "vlm":
        batch["image_embeddings"] = np.asarray(
            gen.normal(size=(n, lb, cfg.n_image_tokens, cfg.d_model)),
            np.float32)
    return batch


@pytest.mark.parametrize("arch", ["stablelm_3b", "musicgen_medium",
                                  "llama32_vision_11b"])
def test_train_batches_are_the_references(arch):
    cfg = get_arch(arch).model.reduced()
    got = TR.make_model_batch(np.random.default_rng(3), cfg, 4, 2, 16)
    want = _reference_make_batch(np.random.default_rng(3), cfg, 4, 2, 16)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("arch", ["musicgen_medium", "llama32_vision_11b"])
def test_train_launcher_runs_the_new_families_on_the_cpu(arch):
    """``launch.train --device cpu`` (the reference's reduced CPU model):
    two finite steps of the embedding-input and the vlm model."""
    res = TR.run(["--arch", arch, "--steps", "2", "--f", "1", "--device",
                  "cpu"], log=lambda *_: None)
    assert len(res["losses"]) == 2
    assert all(math.isfinite(v) for v in res["losses"] + res["dir_norms"])
    want = JTree.make_flat_spec(jax.eval_shape(lambda: JT.model_init(
        jax.random.PRNGKey(0), jax_get_arch(arch).model.reduced(
            n_layers=2, d_model=256).with_overrides(vocab_size=512))),
        pad_to=8).padded_size
    assert res["plan"].flat_spec.padded_size == want


# ----------------------------------------------------------------------- #
# the MoE, MLA, SSM and hybrid families against the reference
# ----------------------------------------------------------------------- #

_SMALL_BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                   d_ff=128, vocab_size=128, dtype="float32")
# tests/test_models.py:30-40
FAMILY_CONFIGS = {
    "moe": dict(family="moe", n_experts=4, top_k=2, n_shared_experts=1,
                first_k_dense=1, n_layers=3, capacity_factor=8.0),
    "mla_moe": dict(family="moe", n_kv_heads=4, n_experts=4, top_k=2,
                    capacity_factor=8.0, use_mla=True, kv_lora_rank=32,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
    "ssm": dict(family="ssm", ssm_state=16, ssm_head_dim=32, ssm_chunk=8),
    "hybrid": dict(family="hybrid", n_kv_heads=4, ssm_state=16,
                   ssm_head_dim=32, ssm_chunk=8, attn_every=2, n_layers=5),
}


def _family(name):
    """The reference's and the port's configs, parameters (the reference's
    carried across) and a token batch of 2 x 20."""
    kw = {**_SMALL_BASE, **FAMILY_CONFIGS[name]}
    from repro.models.config import ModelConfig as JModelConfig
    jcfg, cfg = JModelConfig(name=name, **kw), ModelConfig(name=name, **kw)
    jp = JT.model_init(jax.random.PRNGKey(7), jcfg)
    toks = np.random.default_rng(8).integers(0, 128, (2, 20)).astype(
        np.int32)
    return jcfg, cfg, jp, from_jax_params(jax.tree.map(np.asarray, jp)), toks


def _close(got, want, tol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("name", list(FAMILY_CONFIGS))
def test_family_lm_loss_and_gradients_match(name):
    """``lm_loss`` (with 0.01 x the MoE aux loss) within rtol 1e-5, every
    gradient leaf within 1e-4 of its largest entry of ``jax.grad``'s."""
    jcfg, cfg, jp, tp, toks = _family(name)
    jl, jg = jax.value_and_grad(JT.lm_loss)(jp, jcfg,
                                            {"tokens": jnp.asarray(toks)})
    leaves = [t.requires_grad_() for t in tree_leaves(tp)]
    loss = T.lm_loss(tp, cfg, {"tokens": torch.from_numpy(toks)})
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(jg)
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()),
                                                   1e-3))
