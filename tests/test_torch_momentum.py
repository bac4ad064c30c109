"""The fused RoSDHB momentum update of the port against the reference: the
plain ``momentum_scatter_ref`` against the reference's Pallas
``momentum_scatter`` (interpret mode) and its oracle; the payload route of
``server_round`` bitwise against the dense route for every ported
stateless attack; and a Block-RandK round, float32 and bfloat16 banks,
against the reference's compiled ``server_round`` with its own block ids."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import attacks as JA
from repro.core import compression as JC
from repro.kernels.randk import momentum_scatter, momentum_scatter_ref as JRef
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.kernels.randk import (momentum_scatter_cuda,
                                       momentum_scatter_ref, momentum_update)
from repro_torch.testing import ReplayDraws


def _bits(t):
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


@pytest.mark.parametrize("beta", [0.0, 0.9, 0.99])
@pytest.mark.parametrize("local", [False, True])
def test_plain_momentum_matches_pallas(beta, local):
    """Within atol 1e-5 of the Pallas kernel and of the reference's oracle,
    row by row (``tests/test_kernels.py``'s bar): the reference rounds
    ``beta * m`` and then the sum, the port takes one fused multiply-add,
    as the dense step does."""
    n, d, bs, kb = 3, 4096, 256, 5
    nb = d // bs
    rng = np.random.default_rng(int(beta * 100) + local)
    m = rng.normal(size=(n, d)).astype(np.float32)
    p = rng.normal(size=(n, kb * bs)).astype(np.float32)
    ids = (np.stack([rng.permutation(nb)[:kb] for _ in range(n)]) if local
           else rng.permutation(nb)[:kb]).astype(np.int32)
    got = momentum_scatter_ref(torch.tensor(m), torch.tensor(p),
                               torch.tensor(ids), bs, beta).numpy()
    for r in range(n):
        row_ids = jnp.asarray(ids[r] if local else ids)
        want = momentum_scatter(jnp.asarray(m[r]), jnp.asarray(p[r]), row_ids,
                                bs, beta, interpret=True)
        oracle = JRef(jnp.asarray(m[r]), jnp.asarray(p[r]), row_ids, bs, beta)
        np.testing.assert_allclose(got[r], np.asarray(want), atol=1e-5)
        np.testing.assert_allclose(got[r], np.asarray(oracle), atol=1e-5)


def test_momentum_update_is_the_dense_step_in_place():
    """Bitwise ``(wire * (1-beta)).add_(m, alpha=beta)`` with the wire the
    decompressed payload, in place on the bank; a -0.0 momentum off the
    selected blocks gives +0.0 as the dense step does; a bfloat16 bank
    takes ``(m * beta).add_(wire, alpha=1-beta)``, the bfloat16 dense step,
    and keeps the rounding of the float32 result it hands back."""
    n, d, bs, beta = 2, 1024, 128, 0.9
    rng = np.random.default_rng(0)
    m = torch.tensor(rng.normal(size=(n, d)).astype(np.float32))
    m[:, :bs] = -0.0
    p = torch.tensor(rng.normal(size=(n, 3 * bs)).astype(np.float32))
    ids = torch.tensor([6, 2, 4])
    wire = torch.zeros(n, d)
    wire.view(n, -1, bs)[:, ids] = p.view(n, 3, bs)
    want = (wire * (1.0 - beta)).add_(m, alpha=beta)
    bank = m.clone()
    out = momentum_update(bank, p, ids, block_size=bs, beta=beta)
    assert out is bank
    assert torch.equal(_bits(bank), _bits(want))
    assert (_bits(bank[:, :bs]) == 0).all()  # +0.0, not -0.0
    mb = m.to(torch.bfloat16)
    buf = torch.empty(n, d)
    out32 = momentum_update(mb, p.to(torch.bfloat16), ids, block_size=bs,
                            beta=beta, out=buf)
    assert out32 is buf
    want32 = (m.to(torch.bfloat16).float() * beta).add_(
        wire.to(torch.bfloat16).float(), alpha=1.0 - beta)
    assert out32.dtype == torch.float32
    assert torch.equal(_bits(out32), _bits(want32))
    assert torch.equal(_bits(mb), _bits(want32.to(torch.bfloat16)))


def test_momentum_wrappers_refuse_what_they_do_not_take():
    with pytest.raises(ValueError, match="CUDA"):
        momentum_scatter_cuda(torch.zeros(2, 512), torch.zeros(2, 512),
                              torch.tensor([0]), 512, 0.9)
    with pytest.raises(ValueError, match="cpu or cuda"):
        momentum_update(torch.zeros(2, 512, device="meta"),
                        torch.zeros(2, 512), torch.tensor([0]),
                        block_size=512, beta=0.9)


# ----------------------------------------------------------------------- #
# the payload route against the dense route
# ----------------------------------------------------------------------- #

N, BS, NB, RATIO = 8, 128, 24, 0.25
D = BS * NB
KB = max(1, int(round(RATIO * NB)))


def _cfg(attack="alie", f=1, dtype="float32", local=False, name="rosdhb"):
    return Alg.AlgorithmConfig(
        name=name, n_workers=N, f=f, beta=0.9, momentum_dtype=dtype,
        sparsifier=C.SparsifierConfig(kind="block", ratio=RATIO,
                                      block_size=BS, local=local),
        aggregator=G.AggregatorConfig(name="cwtm", f=max(f, 1)),
        attack=A.AttackConfig(name=attack))


ATTACKS = ["none", "linear", "alie", "signflip", "ipm", "foe", "zero"]


def test_every_zero_preserving_attack_is_tested():
    assert tuple(ATTACKS) == A.ZERO_PRESERVING


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f", [0, 1, 3])
@pytest.mark.parametrize("attack", ATTACKS)
def test_payload_route_is_bitwise_the_dense_route(attack, f, dtype):
    """Same bank, momentum and block ids: the payload route (attack on the
    payload, the momentum update on the payload) against the dense route
    (decompressed wire, dense attack, dense momentum): momentum and
    direction bitwise. Every honest column off the selected blocks is zero,
    and each of these attacks sends zero there."""
    cfg = _cfg(attack, f, dtype)
    assert Alg._payload_route(cfg, D)
    rng = np.random.default_rng(f * 31 + len(attack))
    mdt = Alg.BANK_DTYPES[dtype]
    g = torch.tensor(rng.normal(size=(N, D)).astype(np.float32)).to(mdt)
    m0 = torch.tensor(rng.normal(size=(N, D)).astype(np.float32)).to(mdt)
    ids = rng.permutation(NB)[:KB]
    coeffs = (1.0, -1.5) if attack == "linear" else None
    agg = G.make_aggregator(cfg.aggregator, device="cpu")
    state = Alg.init_state(cfg, D, device="cpu")._replace(momentum=m0)
    wire = Alg._compressed_wire(cfg, g, ReplayDraws("cpu", permutations=[ids]),
                                coeffs)
    r_d, dense = Alg._rosdhb_apply(cfg, agg, state, wire,
                                   Alg.static_hparams(cfg))
    r_p, fused, aux = Alg.server_round(
        cfg, state._replace(momentum=m0.clone()), g,
        ReplayDraws("cpu", permutations=[ids]), agg=agg, attack_params=coeffs)
    assert fused.momentum.dtype == mdt and fused.step == 1
    assert torch.equal(_bits(fused.momentum), _bits(dense.momentum))
    assert torch.equal(_bits(r_p), _bits(r_d))
    assert aux["payload_floats_per_worker"] == KB * BS


def test_payload_route_only_where_it_is_bitwise():
    assert Alg._payload_route(_cfg(), D)
    assert not Alg._payload_route(_cfg(local=True), D)
    assert not Alg._payload_route(_cfg(name="dgd"), D)
    assert not Alg._payload_route(_cfg(), D + 1)
    # without the kernels the route runs their plain versions
    cfg = _cfg()
    assert Alg._payload_route(Alg.AlgorithmConfig(**{
        **cfg.__dict__, "sparsifier": C.SparsifierConfig(
            kind="block", ratio=RATIO, block_size=BS, use_kernels=False)}), D)


def test_payload_route_updates_the_bank_in_place():
    cfg = _cfg()
    m0 = torch.ones(N, D)
    state = Alg.init_state(cfg, D, device="cpu")._replace(momentum=m0)
    _, new, _ = Alg.server_round(cfg, state, torch.ones(N, D),
                                 ReplayDraws("cpu", permutations=[
                                     np.arange(KB)]))
    assert new.momentum is m0


# ----------------------------------------------------------------------- #
# against the reference's compiled round
# ----------------------------------------------------------------------- #

RN, RF = 13, 3


def _ref_round(dtype):
    jcfg = JAlg.AlgorithmConfig(
        name="rosdhb", n_workers=RN, f=RF, gamma=0.05, beta=0.9,
        momentum_dtype=dtype,
        sparsifier=JC.SparsifierConfig(kind="block", ratio=RATIO,
                                       block_size=BS),
        aggregator=JG.AggregatorConfig(name="cwtm", f=RF),
        attack=JA.AttackConfig(name="alie"))
    cfg = Alg.AlgorithmConfig(
        name="rosdhb", n_workers=RN, f=RF, gamma=0.05, beta=0.9,
        momentum_dtype=dtype,
        sparsifier=C.SparsifierConfig(kind="block", ratio=RATIO,
                                      block_size=BS),
        aggregator=G.AggregatorConfig(name="cwtm", f=RF),
        attack=A.AttackConfig(name="alie"))
    rng = np.random.default_rng(5)
    g = rng.normal(size=(RN, D)).astype(np.float32)
    m0 = rng.normal(size=(RN, D)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    # the block ids along the reference's key chain (algorithms.py:819,
    # compression.py:275)
    ids = np.asarray(jax.random.permutation(jax.random.split(key)[0],
                                            NB)[:KB])
    jdt = jnp.dtype(dtype)
    st = JAlg.init_state(jcfg, D)._replace(momentum=jnp.asarray(m0, jdt))

    @jax.jit
    def ref(st, g, key):
        r, new, _ = JAlg.server_round(jcfg, st, g, key)
        mask_key, atk_key = jax.random.split(key)
        wire = JAlg._compressed_wire(jcfg, None, g, mask_key, atk_key)[0]
        return r, new.momentum, wire

    r, mom, wire = ref(st, jnp.asarray(g, jdt), key)
    tdt = Alg.BANK_DTYPES[dtype]
    tg = torch.tensor(g).to(tdt)
    state = Alg.init_state(cfg, D, device="cpu")._replace(
        momentum=torch.tensor(m0).to(tdt))
    twire = Alg._compressed_wire(cfg, tg, ReplayDraws("cpu",
                                                      permutations=[ids]))
    tr, new, _ = Alg.server_round(cfg, state, tg,
                                  ReplayDraws("cpu", permutations=[ids]))
    f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return {"r": np.asarray(r), "mom": f32(mom), "wire": f32(wire),
            "tr": tr.numpy(), "tmom": new.momentum.float().numpy(),
            "twire": twire.float().numpy()}


def test_block_round_matches_the_compiled_reference():
    """float32 banks, the reference on its default compressor here (the jnp
    mask multiply; with ``use_pallas=True`` XLA contracts the other product
    of the momentum into its FMA, 1 ulp apart, ROADMAP Queue 3): honest
    momentum rows bitwise; the Byzantine rows within 4 ulp of their largest
    value (the compiled reference fuses ALIE's statistics, Queue 3); the
    direction within rtol 1e-5."""
    o = _ref_round("float32")
    mom, tmom = o["mom"], o["tmom"]
    np.testing.assert_array_equal(tmom[RF:], mom[RF:])
    np.testing.assert_allclose(tmom[:RF], mom[:RF], rtol=0,
                               atol=4 * np.spacing(np.abs(mom[:RF]).max()))
    np.testing.assert_allclose(o["tr"], o["r"], rtol=1e-5,
                               atol=1e-5 * np.abs(o["r"]).max())


def test_bf16_block_round_matches_the_compiled_reference():
    """bfloat16 banks and wire. The wire is bitwise, Byzantine rows
    included: the compress rounds ``alpha * g`` once to bfloat16 in both,
    and the port's ALIE rounds where the reference's does on bfloat16 rows
    (mean and variance in float32, each rounded to bfloat16, ``z`` rounded
    to bfloat16, each bfloat16 product and difference rounded). The
    momentum is bitwise: on bfloat16 banks the port takes ``fma(1-beta, w,
    beta m)``, the product XLA contracts in this compiled round (ROADMAP
    Queue 3). The direction within rtol 1e-5."""
    o = _ref_round("bfloat16")
    np.testing.assert_array_equal(o["twire"], o["wire"])
    np.testing.assert_array_equal(o["tmom"], o["mom"])
    np.testing.assert_allclose(o["tr"], o["r"], rtol=1e-5,
                               atol=1e-5 * np.abs(o["r"]).max())


# ----------------------------------------------------------------------- #
# server_compute_dtype="bfloat16"
# ----------------------------------------------------------------------- #


def _fig1_pair(cdt, mdt):
    """The fig1-alie cell (NNM + CWTM, ALIE, global RandK 0.1) in both
    packages, computing in ``cdt`` over ``mdt`` banks."""
    kw = dict(name="rosdhb", n_workers=13, f=3, gamma=0.05, beta=0.9,
              momentum_dtype=mdt, server_compute_dtype=cdt)
    ref = JAlg.AlgorithmConfig(
        sparsifier=JC.SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=JG.AggregatorConfig(name="cwtm", f=3, pre_nnm=True),
        attack=JA.AttackConfig(name="alie", z=1.5), **kw)
    port = Alg.AlgorithmConfig(
        sparsifier=C.SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=G.AggregatorConfig(name="cwtm", f=3, pre_nnm=True),
        attack=A.AttackConfig(name="alie", z=1.5), **kw)
    return ref, port


@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_bf16_compute_dtype_matches_the_reference(mdt):
    """One RoSDHB round computing in bfloat16 against the reference's
    compiled ``server_round``: the bank bitwise (the rounding of
    ``algorithms._momentum``), the direction within one bfloat16 ulp of
    max |R|, at most 2% of its coordinates off (5 of 500 here)."""
    ref, port = _fig1_pair("bfloat16", mdt)
    d = 500
    rng = np.random.default_rng(0)
    g = rng.normal(size=(13, d)).astype(np.float32)
    m0 = rng.normal(size=(13, d)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    perm = np.asarray(jax.random.permutation(jax.random.split(key)[0], d)[
        :ref.sparsifier.k(d)])
    st = JAlg.init_state(ref, d)._replace(
        momentum=jnp.asarray(m0).astype(mdt))
    r, new, _ = jax.jit(lambda st, g: JAlg.server_round(ref, st, g, key))(
        st, g)
    want_m = np.asarray(new.momentum.astype(jnp.float32))
    tst = Alg.init_state(port, d, device="cpu")._replace(
        momentum=torch.tensor(m0).to(Alg.BANK_DTYPES[mdt]))
    tr, tnew, _ = Alg.server_round(port, tst, torch.tensor(g),
                                   ReplayDraws("cpu", permutations=[perm]))
    assert tr.dtype == torch.bfloat16 and str(r.dtype) == "bfloat16"
    got_m = tnew.momentum.float().numpy()
    np.testing.assert_array_equal(got_m, want_m)
    want_r = np.asarray(r.astype(jnp.float32))
    got_r = tr.float().numpy()
    # NNM's float32 mixing product sums in another order, so a few
    # coordinates round across a bfloat16 midpoint (and CWTM then trims a
    # neighbour): within one bfloat16 ulp of max |R|
    scale = np.abs(want_r).max()
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.abs(got_r - want_r).max() <= ulp
    assert (got_r != want_r).mean() <= 0.02
