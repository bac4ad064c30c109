"""The MoE, MLA, SSM and hybrid families of ``tests/test_models.py`` in
every mode against the reference, and both launchers on the CPU for their
architectures (split from ``tests/test_torch_zoo.py``, whose configs and
helpers these cases use, to share its time between two workers)."""

import math

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import transformer as JT
from repro.utils import tree as JTree
from repro_torch.launch import train as TR
from repro_torch.models import transformer as T
from repro_torch.utils.tree import tree_leaves
from test_torch_zoo import FAMILY_ARCHS, FAMILY_CONFIGS, _close, _family


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """One intra-op thread: the suite's parallel workers each starting a
    thread per core slow the CPU steps down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(FAMILY_CONFIGS))
def test_family_forward_in_every_mode_matches(name):
    """Train mode (with the MoE aux loss), then prefill of 14 tokens and 4
    decode steps: hidden states and every cache leaf within 1e-5."""
    jcfg, cfg, jp, tp, toks = _family(name)
    jh, _, jaux = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    th, _, taux = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks)})
    _close(th, jh)
    assert float(taux["moe_loss"]) == pytest.approx(
        float(jaux["moe_loss"]), rel=1e-5, abs=1e-7)
    assert (float(taux["moe_loss"]) > 0) == (cfg.family == "moe")
    s, steps = 14, 4
    jc = JT.cache_init(jcfg, 2, s + steps)
    tc = T.cache_init(cfg, 2, s + steps)
    jh, jc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks[:, :s])},
                           mode="prefill", caches=jc)
    th, tc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(toks[:, :s])},
                          mode="prefill", caches=tc)
    _close(th, jh)
    for i in range(steps):
        tok = toks[:, s + i:s + i + 1]
        jh, jc, _ = JT.forward(jp, jcfg, {"tokens": jnp.asarray(tok)},
                               mode="decode", pos=s + i, caches=jc)
        th, tc, _ = T.forward(tp, cfg, {"tokens": torch.from_numpy(tok)},
                              mode="decode", pos=s + i, caches=tc)
        _close(th, jh)
    gl, wl = tree_leaves(tc), jax.tree_util.tree_leaves(jc)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        _close(g, w)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launchers_run_the_families_on_the_cpu(arch):
    """``launch.train`` (one step) and ``launch.serve`` (2 tokens) with
    ``--device cpu`` at the reference's reduced CPU model: finite loss,
    the reference's flat width, tokens in the vocabulary."""
    from repro_torch.launch import serve
    res = TR.run(["--arch", arch, "--steps", "1", "--f", "1", "--device",
                  "cpu"], log=lambda *_: None)
    assert all(math.isfinite(v) for v in res["losses"] + res["dir_norms"])
    want = JTree.make_flat_spec(jax.eval_shape(lambda: JT.model_init(
        jax.random.PRNGKey(0), jax_get_arch(arch).model.reduced(
            n_layers=2, d_model=256).with_overrides(vocab_size=512))),
        pad_to=8).padded_size
    assert res["plan"].flat_spec.padded_size == want
    out = serve.run(["--arch", arch, "--device", "cpu", "--batch", "2",
                     "--prompt-len", "6", "--tokens", "2"],
                    log=lambda *_: None)
    assert out["tokens"].shape == (2, 2)
    assert int(out["tokens"].max()) < out["cfg"].vocab_size
