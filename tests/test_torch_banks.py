"""The grid's banks in the port against the reference: the geometric median,
the aggregator bank, the algorithm bank, and the plan-time values a bank
carries per lane (Theorem 1's hyperparameters, ``static_hparams``,
``algo_index``, the clip, the per-lane keep-ratio, the payload counts).

Tolerances (the ROADMAP's bars): aggregation rtol 1e-5; compression,
momentum, mirrors and the update bitwise. A bank lane against its lone
rule or lone algorithm in the port: bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import compression as JC
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.testing import GridDraws, ReplayDraws

N, F, D = 10, 2, 200


def _x(b, n=N, d=D, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, d)).astype(np.float32)
    x[:, :F] *= 8.0  # outliers in the first rows
    return x


@pytest.mark.parametrize("n,d,iters", [(13, 64, 8), (5, 300, 3), (10, 11, 1)])
def test_geometric_median_matches_the_reference(n, d, iters):
    x = _x(1, n, d, seed=n + d)[0]
    want = np.asarray(JG.geometric_median(jnp.asarray(x), iters=iters))
    got = G.geometric_median(torch.tensor(x), iters=iters)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    batched = G.geometric_median(torch.tensor(_x(3, n, d, seed=n)),
                                 iters=iters)
    for i, row in enumerate(_x(3, n, d, seed=n)):
        torch.testing.assert_close(
            batched[i], G.geometric_median(torch.tensor(row), iters=iters),
            rtol=0, atol=0)


def test_bank_constants_match_the_reference():
    assert G.BANK_NAMES == JG.BANK_NAMES
    assert G.DEFAULT_BANK == JG.DEFAULT_BANK
    assert Alg.ALGO_BANK == JAlg.ALGO_BANK
    assert C.TRACED_RATIO_KINDS == JC.TRACED_RATIO_KINDS
    for name, pre in G.DEFAULT_BANK + (("mean", True),):
        cfg = G.AggregatorConfig(name=name, f=F, pre_nnm=pre)
        jcfg = JG.AggregatorConfig(name=name, f=F, pre_nnm=pre)
        assert G.bank_index(cfg) == JG.bank_index(jcfg)
        sub = (("mean", False), (name, pre and name != "mean"))
        assert G.bank_index(cfg, sub) == JG.bank_index(jcfg, sub)
    with pytest.raises(ValueError, match="not a branch"):
        G.bank_index(G.AggregatorConfig(name="krum"), (("mean", False),))


@pytest.mark.parametrize("use_kernels", [True, False])
def test_every_aggregator_branch_equals_its_lone_rule(use_kernels):
    """A mixed [B, n, d] batch, lane i on branch idx[i] of the default
    bank: each lane is its lone rule's result, bitwise; and the reference's
    switch bank's within rtol 1e-5."""
    b = 2 * len(G.DEFAULT_BANK)
    x = _x(b, seed=4)
    idx = [(5 * i + 2) % len(G.DEFAULT_BANK) for i in range(b)]
    bank = G.make_aggregator_bank(G.AggregatorConfig(
        name="bank", f=F, use_kernels=use_kernels), device="cpu")
    out = bank(torch.tensor(x), idx)
    jbank = JG.make_aggregator_bank(JG.AggregatorConfig(name="bank", f=F,
                                                        use_pallas=False))
    for i, e in enumerate(idx):
        name, pre = G.DEFAULT_BANK[e]
        lone = G.make_aggregator(G.AggregatorConfig(
            name=name, f=F, pre_nnm=pre, use_kernels=use_kernels), "cpu")
        assert torch.equal(out[i], lone(torch.tensor(x[i]))), (name, pre)
        want = np.asarray(jbank(jnp.asarray(x[i]), e))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(out[i].numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale)


def test_aggregator_bank_one_lane_and_subsets():
    x = _x(4, seed=8)
    entries = (("cwtm", True), ("median", False))
    bank = G.make_aggregator_bank(G.AggregatorConfig(
        name="bank", f=F, bank=entries), device="cpu")
    out = bank(torch.tensor(x), torch.tensor([1, 0, 0, 1]))
    assert torch.equal(bank(torch.tensor(x[2]), 0), out[2])
    assert torch.equal(bank(torch.tensor(x[:2]), [1, 0]), out[:2])
    with pytest.raises(ValueError, match="outside the bank"):
        bank(torch.tensor(x), [0, 1, 2, 0])
    with pytest.raises(ValueError, match="branch indices"):
        bank(torch.tensor(x), [0, 1])


# ----------------------------------------------------------------------- #
# the algorithm bank
# ----------------------------------------------------------------------- #

K = max(1, int(round(0.1 * D)))


def _base(name="rosdhb", attack="alie"):
    agg = ("mean", False) if name == "dgd" else ("cwtm", True)
    return Alg.AlgorithmConfig(
        name=name, n_workers=N, f=F, gamma=0.05, beta=0.9,
        sparsifier=C.SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=G.AggregatorConfig(name=agg[0], f=F, pre_nnm=agg[1]),
        attack=A.AttackConfig(name=attack, z=1.5))


def _seed_perms(seed):
    """A seed's round: the global mask's indices, then one per worker."""
    rng = np.random.default_rng(seed)
    return ([rng.permutation(D)[:K]], [rng.permutation(D)[:K]
                                       for _ in range(N)])


def test_mixed_algorithm_bank_equals_each_lone_server_round():
    """Lane i runs ALGO_BANK[i % 4] on seed i // 4's draws; each lane's
    direction, momentum, mirror and previous gradients are its lone
    ``server_round``'s (ALIE as the bank's linear branch)."""
    rng = np.random.default_rng(21)
    b = 8
    algo_idx = [i % 4 for i in range(b)]
    seed_of = [i // 4 for i in range(b)]
    grads = torch.tensor(rng.normal(size=(b, N, D)).astype(np.float32))
    bank_cfg = dataclasses.replace(
        _base(), name="bank",
        attack=A.AttackConfig(name="bank", bank=("linear",)),
        aggregator=G.AggregatorConfig(name="bank", f=F, bank=(
            ("cwtm", True), ("mean", False))))
    state = Alg.init_state(bank_cfg, D, device="cpu", lanes=b)
    state = state._replace(step=1, **{
        k: torch.tensor(rng.normal(size=(b, N, D)).astype(np.float32))
        for k in ("momentum", "mirror", "prev_grad")})
    perms = [_seed_perms(s) for s in (0, 1)]
    draws = GridDraws([ReplayDraws("cpu", permutations=g + loc)
                       for g, loc in perms], seed_of)
    sc = Alg.ScenarioParams(
        attack_coeffs=torch.tensor([(1.0, -1.5)] * b),
        attack_idx=torch.zeros(b, dtype=torch.int32),
        agg_idx=torch.tensor([1 if a == 3 else 0 for a in algo_idx]),
        algo_idx=torch.tensor(algo_idx),
        hparams=torch.tensor([Alg.static_hparams(_base(Alg.ALGO_BANK[a]))
                              for a in algo_idx], dtype=torch.float32))
    r, new, aux = Alg.server_round(bank_cfg, state, grads, draws, scenario=sc)
    assert new.step == 2 and r.shape == (b, D)
    for i, a in enumerate(algo_idx):
        name = Alg.ALGO_BANK[a]
        cfg = _base(name)
        g_perm, l_perms = perms[seed_of[i]]
        lone_draws = ReplayDraws("cpu", permutations={
            "rosdhb": g_perm, "dgd": g_perm, "dasha": l_perms,
            "robust_dgd": []}[name])
        dasha = name == "dasha"
        lone = Alg.ServerState(state.momentum[i].clone(),
                               state.mirror[i] if dasha else None,
                               state.prev_grad[i] if dasha else None, 1)
        lr, ln, laux = Alg.server_round(cfg, lone, grads[i], lone_draws)
        assert lone_draws.remaining == 0
        assert torch.equal(r[i], lr), name
        assert torch.equal(new.momentum[i], ln.momentum), name
        if dasha:
            assert torch.equal(new.mirror[i], ln.mirror)
            assert torch.equal(new.prev_grad[i], ln.prev_grad)
        else:  # the slots a branch does not own pass through untouched
            assert torch.equal(new.mirror[i], state.mirror[i])
            assert torch.equal(new.prev_grad[i], state.prev_grad[i])
        assert float(aux["payload_floats_per_worker"][i]) == \
            laux["payload_floats_per_worker"]
        p = torch.tensor(rng.normal(size=D).astype(np.float32))
        assert torch.equal(Alg.apply_direction(p, r[i], 0.05),
                           Alg.apply_direction(p, lr, 0.05))


def test_algorithm_bank_lane_matches_the_reference_bank():
    """One dasha lane of the port's bank against the reference's compiled
    ``server_round(name='bank')`` with the same mask draws: momentum and
    mirror bitwise on the honest rows, direction rtol 1e-5."""
    rng = np.random.default_rng(3)
    g = rng.normal(size=(N, D)).astype(np.float32)
    m0, h0, p0 = (rng.normal(size=(N, D)).astype(np.float32)
                  for _ in range(3))
    key = jax.random.PRNGKey(11)
    ref = JAlg.AlgorithmConfig(
        name="bank", n_workers=N, f=F, beta=0.9, bank=("rosdhb", "dasha"),
        sparsifier=JC.SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=JG.AggregatorConfig(name="cwtm", f=F, pre_nnm=True),
        attack=JA_alie())
    hp = JAlg.static_hparams(dataclasses.replace(ref, name="dasha"))
    jsc = JAlg.ScenarioParams(algo_idx=jnp.int32(1),
                              hparams=jnp.asarray(hp, jnp.float32))
    jst = JAlg.init_state(ref, D)._replace(
        momentum=jnp.asarray(m0), mirror=jnp.asarray(h0),
        prev_grad=jnp.asarray(p0), step=jnp.int32(1))
    jr, jnew, _ = jax.jit(lambda s, g, k: JAlg.server_round(
        ref, s, g, k, scenario=jsc))(jst, g, key)
    mask_key = jax.random.split(key)[0]
    perms = [np.asarray(jax.random.permutation(k, D)[:K])
             for k in jax.random.split(mask_key, N)]
    port = dataclasses.replace(_base(), name="bank", bank=("rosdhb", "dasha"))
    st = Alg.init_state(port, D, device="cpu")._replace(
        momentum=torch.tensor(m0), mirror=torch.tensor(h0),
        prev_grad=torch.tensor(p0), step=1)
    sc = Alg.ScenarioParams(algo_idx=torch.tensor(1),
                            hparams=torch.tensor(hp, dtype=torch.float32))
    r, new, _ = Alg.server_round(port, st, torch.tensor(g),
                                 ReplayDraws("cpu", permutations=perms),
                                 scenario=sc)
    np.testing.assert_array_equal(new.momentum.numpy(),
                                  np.asarray(jnew.momentum))
    np.testing.assert_array_equal(new.mirror.numpy()[F:],
                                  np.asarray(jnew.mirror)[F:])
    scale = float(np.abs(np.asarray(jr)).max())
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-5,
                               atol=1e-5 * scale)


def JA_alie():
    from repro.core import attacks as JA
    return JA.AttackConfig(name="alie", z=1.5)


def test_bank_needs_its_selectors_and_a_full_layout_for_dasha():
    cfg = dataclasses.replace(_base(), name="bank")
    st = Alg.init_state(cfg, D, device="cpu", lanes=2)
    g = torch.zeros(2, N, D)
    with pytest.raises(ValueError, match="algo_idx"):
        Alg.server_round(cfg, st, g, ReplayDraws("cpu"))
    with pytest.raises(ValueError, match="hparams"):
        Alg.server_round(cfg, st, g, ReplayDraws("cpu"),
                         scenario=Alg.ScenarioParams(algo_idx=[0, 0]))
    pruned = dataclasses.replace(cfg, state_layout=Alg.StateLayout(
        mirror=False, prev_grad=False))
    with pytest.raises(ValueError, match="dasha"):
        Alg.make_algorithm_bank(pruned)
    with pytest.raises(ValueError, match="dasha"):
        Alg.init_state(pruned, D, device="cpu")
    assert Alg.init_state(dataclasses.replace(pruned, bank=(
        "rosdhb", "dgd")), D, device="cpu").mirror is None
    with pytest.raises(ValueError, match="unknown algorithm-bank"):
        Alg.make_algorithm_bank(cfg, ("rosdhb", "sgd"))
    with pytest.raises(ValueError, match="at least one"):
        Alg.make_algorithm_bank(cfg, ())
    atk = dataclasses.replace(cfg, attack=A.AttackConfig(name="bank"))
    assert Alg.init_state(atk, D, device="cpu", lanes=3).attack.vec.shape \
        == (3, D)


# ----------------------------------------------------------------------- #
# plan-time values
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("L,ratio", [(1.0, 0.1), (2.5, 0.01), (0.3, 1.0)])
def test_theorem1_hparams(L, ratio):
    assert Alg.theorem1_hparams(L, ratio) == JAlg.theorem1_hparams(L, ratio)
    assert Alg.theorem1_hparams(L, ratio, c=100.0) == \
        JAlg.theorem1_hparams(L, ratio, c=100.0)


@pytest.mark.parametrize("name", Alg.ALGO_BANK)
def test_static_hparams_and_algo_index(name):
    for beta, mvr_a in ((0.9, None), (None, 0.3), (0.5, 0.2)):
        kw = dict(name=name, beta=beta, mvr_a=mvr_a, gamma=0.001,
                  smoothness_L=2.0)
        assert Alg.static_hparams(Alg.AlgorithmConfig(**kw)) == \
            JAlg.static_hparams(JAlg.AlgorithmConfig(**kw))
    assert Alg.algo_index(name) == JAlg.algo_index(name)
    assert Alg.algo_index(name, ("dgd", name)) == \
        JAlg.algo_index(name, ("dgd", name))
    with pytest.raises(ValueError, match="not a branch"):
        Alg.algo_index(name, ())
    cfg = Alg.AlgorithmConfig(name="bank", bank=(name,))
    jcfg = JAlg.AlgorithmConfig(name="bank", bank=(name,))
    assert cfg.algorithms() == jcfg.algorithms()
    assert cfg.resolved_state_layout() == Alg.StateLayout(
        **dataclasses.asdict(jcfg.resolved_state_layout()))


@pytest.mark.parametrize("clip", [0.5, 3.0])
def test_clip_norm_matches_the_reference(clip):
    rng = np.random.default_rng(2)
    g = (rng.normal(size=(N, D)) * np.linspace(0.1, 2, N)[:, None]).astype(
        np.float32)
    kw = dict(name="robust_dgd", n_workers=N, f=0, clip_norm=clip)
    ref = JAlg.AlgorithmConfig(aggregator=JG.AggregatorConfig(name="mean"),
                               **kw)
    jr, _, _ = jax.jit(lambda g: JAlg.server_round(
        ref, JAlg.init_state(ref, D), g, jax.random.PRNGKey(0)))(g)
    port = Alg.AlgorithmConfig(aggregator=G.AggregatorConfig(name="mean"),
                               **kw)
    r, _, _ = Alg.server_round(port, Alg.init_state(port, D, device="cpu"),
                               torch.tensor(g), ReplayDraws("cpu"))
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("kind", ["bernoulli", "block_hash"])
@pytest.mark.parametrize("local", [False, True])
def test_per_lane_ratio_masks_and_rescale(kind, local):
    """One draw read by lanes of three ratios: each lane's mask and
    ``(g / ratio) * mask`` are the reference's with that traced ratio."""
    ratios = np.array([0.1, 0.37, 0.8], np.float32)
    cfg = C.SparsifierConfig(kind=kind, ratio=0.5, block_size=16,
                             local=local)
    jcfg = JC.SparsifierConfig(kind=kind, ratio=0.5, block_size=16,
                               local=local)
    key = jax.random.PRNGKey(5)
    n = 4
    want = [np.asarray(JC.make_masks(key, n, D, jcfg, ratio=jnp.float32(r)))
            for r in ratios]
    keys = jax.random.split(key, n) if local else [key]
    if kind == "bernoulli":
        draws = ReplayDraws("cpu", uniforms=[np.asarray(
            jax.random.uniform(k, (D,))) for k in keys])
    else:
        draws = ReplayDraws("cpu", bits=[int(jax.random.bits(k, (), jnp.uint32))
                                         for k in keys])
    got = C.make_masks(draws, n, D, cfg, ratio=torch.tensor(ratios))
    assert draws.remaining == 0
    g = np.random.default_rng(1).normal(size=(3, n, D)).astype(np.float32)
    out = C.compress(torch.tensor(g), got if local else got[:, None],
                     cfg, ratio=torch.tensor(ratios))
    for i, r in enumerate(ratios):
        np.testing.assert_array_equal(
            np.broadcast_to(got[i].numpy(), (n, D)),
            np.broadcast_to(want[i], (n, D)))
        jout = JC.compress(jnp.asarray(g[i]), jnp.asarray(want[i]), jcfg,
                           ratio=jnp.float32(r))
        np.testing.assert_array_equal(out[i].numpy(), np.asarray(jout))
    with pytest.raises(ValueError, match="per-lane ratio"):
        C.make_mask(draws, D, C.SparsifierConfig(kind="randk", ratio=0.1),
                    ratio=torch.tensor(ratios))


@pytest.mark.parametrize("ratio", [None, 0.25])
def test_bank_payload_floats(ratio):
    sp = C.SparsifierConfig(kind="randk", ratio=0.1)
    jsp = JC.SparsifierConfig(kind="randk", ratio=0.1)
    got = Alg._bank_payload_floats(Alg.ALGO_BANK, 11958, sp, ratio)
    want = JAlg._bank_payload_floats(
        JAlg.ALGO_BANK, 11958, jsp,
        None if ratio is None else jnp.float32(ratio))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
