"""Compression and wire accounting of the port against
``repro.core.compression`` / ``repro.core.wire``, with the reference's own
draws injected."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.core import wire as JW
from repro_torch.core import compression as C
from repro_torch.core import wire as W
from repro_torch.testing import ReplayDraws, TorchDraws

N, D = 13, 1000


def _grads(seed=0):
    return (np.random.default_rng(seed).normal(size=(N, D)) * 2
            ).astype(np.float32)


def _cfg(kind, ratio, local):
    return (JC.SparsifierConfig(kind=kind, ratio=ratio, local=local),
            C.SparsifierConfig(kind=kind, ratio=ratio, local=local))


@pytest.mark.parametrize("ratio", [0.1, 0.37])
@pytest.mark.parametrize("local", [False, True])
def test_randk_compressed_estimate_bitwise(ratio, local):
    jcfg, cfg = _cfg("randk", ratio, local)
    g = _grads()
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda g, k: JC.compressed_estimate(g, k, jcfg))(
        g, key))
    k = jcfg.k(D)
    keys = jax.random.split(key, N) if local else [key]
    perms = [np.asarray(jax.random.permutation(kk, D)[:k]) for kk in keys]
    draws = ReplayDraws("cpu", permutations=perms)
    got = C.compressed_estimate(torch.tensor(g), draws, cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert draws.remaining == 0


@pytest.mark.parametrize("local", [False, True])
def test_bernoulli_compressed_estimate_bitwise(local):
    jcfg, cfg = _cfg("bernoulli", 0.2, local)
    g = _grads(1)
    key = jax.random.PRNGKey(9)
    want = np.asarray(JC.compressed_estimate(g, key, jcfg))
    keys = jax.random.split(key, N) if local else [key]
    unif = [np.asarray(jax.random.uniform(kk, (D,))) for kk in keys]
    got = C.compressed_estimate(torch.tensor(g),
                                ReplayDraws("cpu", uniforms=unif), cfg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_none_and_full_ratio_pass_through():
    g = torch.tensor(_grads(2))
    for cfg in (C.SparsifierConfig(kind="none"),
                C.SparsifierConfig(kind="randk", ratio=1.0)):
        out = C.compressed_estimate(g, TorchDraws(0, "cpu"), cfg)
        assert torch.equal(out, g)


def test_torch_draws_randk_mask_is_exact_k():
    cfg = C.SparsifierConfig(kind="randk", ratio=0.1)
    m = C.make_mask(TorchDraws(3, "cpu"), 11958, cfg)
    assert int(m.sum()) == cfg.k(11958) == 1196
    g = torch.ones(2, 11958)
    est = C.compress(g, m, cfg)
    assert torch.equal(est[0], est[1])
    assert float(est.sum()) == pytest.approx(2 * 1196 * 10.0)


def test_unported_kind_raises():
    """A kind neither package has raises the reference's error."""
    with pytest.raises(ValueError, match="unknown sparsifier kind"):
        C.make_mask(TorchDraws(0, "cpu"), 64,
                    C.SparsifierConfig(kind="topk", ratio=0.5))
    with pytest.raises(ValueError, match="unknown sparsifier kind"):
        JC.make_mask(jax.random.PRNGKey(0), 64,
                     JC.SparsifierConfig(kind="topk", ratio=0.5))


@pytest.mark.parametrize("local", [False, True])
def test_natural_compression_bitwise(local):
    """Natural compression (stochastic power-of-two rounding) from the
    reference's uniform draws: bitwise, exact zeros and powers of two among
    the inputs, and the reference's rounding of ``exp2`` (not an exact power
    of two) included; its 9-bit-a-coordinate payload the reference's."""
    jcfg, cfg = _cfg("natural", 1.0, local)
    g = _grads(4)
    g[0, :6] = [0.0, -0.0, 1.0, -2.0, 0.5, 3.0]
    key = jax.random.PRNGKey(11)
    want = np.asarray(JC.compressed_estimate(g, key, jcfg))
    keys = jax.random.split(key, N) if local else [key]
    unif = [np.asarray(jax.random.uniform(kk, (D,))) for kk in keys]
    draws = ReplayDraws("cpu", uniforms=unif)
    got = C.compressed_estimate(torch.tensor(g), draws, cfg).numpy()
    np.testing.assert_array_equal(got, want)
    assert draws.remaining == 0
    for d in (1, 64, 11958, 1048576):
        assert C.payload_bytes(d, cfg) == JC.payload_bytes(d, jcfg)


@pytest.mark.parametrize("d", [1, 2, 255, 256, 11958, 65537, 1048576])
@pytest.mark.parametrize("kind,ratio,local", [
    ("randk", 0.1, False), ("randk", 0.1, True), ("bernoulli", 0.25, True),
    ("none", 1.0, False), ("randk", 1.0, True)])
def test_byte_accounting_equal(d, kind, ratio, local):
    jcfg, cfg = _cfg(kind, ratio, local)
    assert C.index_bytes(d) == JC.index_bytes(d)
    assert C.payload_floats(d, cfg) == JC.payload_floats(d, jcfg)
    for idx in (False, True):
        assert (C.payload_bytes(d, cfg, with_mask_indices=idx)
                == JC.payload_bytes(d, jcfg, with_mask_indices=idx))
    for algo in W.WIRE_ALGORITHMS:
        assert (W.per_worker_payload_bytes(algo, d, cfg)
                == JW.per_worker_payload_bytes(algo, d, jcfg))
        assert (W.round_payload_bytes(algo, d, cfg, 13)
                == JW.round_payload_bytes(algo, d, jcfg, 13))
