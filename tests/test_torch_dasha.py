"""Byz-DASHA-PAGE of the port against the reference: one compiled server
round (first and later steps), the state layout and its bytes, and a
20-round fig1-alie quadratic trajectory through ``Simulator.rollout`` with
the reference's per-worker RandK draws replayed (``ReplayDraws``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import attacks as JA
from repro.core import compression as JC
from repro.core.simulator import Simulator as JSimulator
from repro.core.sweep import quadratic_testbed as jax_quadratic
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.core import Simulator, quadratic_testbed
from repro_torch.testing import ReplayDraws

N, F = 13, 3


def cell(kind="randk", ratio=0.1, block_size=512, mdt="float32"):
    """The fig1-alie cell with algo dasha, in both packages."""
    ref = JAlg.AlgorithmConfig(
        name="dasha", n_workers=N, f=F, gamma=0.05, beta=0.9,
        momentum_dtype=mdt,
        sparsifier=JC.SparsifierConfig(kind=kind, ratio=ratio,
                                       block_size=block_size),
        aggregator=JG.AggregatorConfig(name="cwtm", f=F, pre_nnm=True),
        attack=JA.AttackConfig(name="alie", z=1.5))
    port = Alg.AlgorithmConfig(
        name="dasha", n_workers=N, f=F, gamma=0.05, beta=0.9,
        momentum_dtype=mdt,
        sparsifier=C.SparsifierConfig(kind=kind, ratio=ratio,
                                      block_size=block_size),
        aggregator=G.AggregatorConfig(name="cwtm", f=F, pre_nnm=True),
        attack=A.AttackConfig(name="alie", z=1.5))
    return ref, port


def local_draws(mask_key, n, draw):
    """One mask draw per worker: make_masks splits the mask key n ways
    (``compression.py:175``)."""
    return [np.asarray(draw(k)) for k in jax.random.split(mask_key, n)]


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("kind", ["randk", "block"])
def test_one_round(step, kind):
    """From the same momentum, mirror, previous gradients and masks: the
    momentum, the previous gradients and the honest mirror rows bitwise
    (the MVR update and the compressed difference are single FMAs, as XLA
    contracts them); the Byzantine mirror rows within 1 ulp of their
    largest value (the compiled reference fuses ALIE's statistics, ROADMAP
    Queue 3); the direction within 4 ulp of its largest value (NNM and
    CWTM sum in another order). ``block`` runs the compress and decompress
    kernels' plain versions with local ids: bitwise the mask multiply."""
    d = 512 * 4 if kind == "block" else 500
    ratio = 0.25 if kind == "block" else 0.1
    ref, port = cell(kind, ratio)
    rng = np.random.default_rng(step)
    g, m, h, pg = (rng.normal(size=(N, d)).astype(np.float32)
                   for _ in range(4))
    key = jax.random.PRNGKey(3 + step)
    mask_key = jax.random.split(key)[0]
    if kind == "block":
        perms = local_draws(mask_key, N, lambda k: jax.random.permutation(
            k, d // 512)[:1])
    else:
        perms = local_draws(mask_key, N, lambda k: jax.random.permutation(
            k, d)[:port.sparsifier.k(d)])
    st = JAlg.init_state(ref, d)._replace(
        momentum=jnp.asarray(m), mirror=jnp.asarray(h),
        prev_grad=jnp.asarray(pg), step=jnp.asarray(step, jnp.int32))
    r, new, _ = jax.jit(lambda st, g, key: JAlg.server_round(ref, st, g, key)
                        )(st, jnp.asarray(g), key)
    tst = Alg.init_state(port, d, device="cpu")._replace(
        momentum=torch.tensor(m), mirror=torch.tensor(h),
        prev_grad=torch.tensor(pg), step=step)
    draws = ReplayDraws("cpu", permutations=perms)
    tr, tnew, aux = Alg.server_round(port, tst, torch.tensor(g), draws)
    assert draws.remaining == 0 and tnew.step == step + 1
    np.testing.assert_array_equal(tnew.momentum.numpy(),
                                  np.asarray(new.momentum))
    np.testing.assert_array_equal(tnew.prev_grad.numpy(),
                                  np.asarray(new.prev_grad))
    mir, tmir = np.asarray(new.mirror), tnew.mirror.numpy()
    np.testing.assert_array_equal(tmir[F:], mir[F:])
    np.testing.assert_allclose(tmir[:F], mir[:F], rtol=0,
                               atol=np.spacing(np.abs(mir[:F]).max()))
    r = np.asarray(r)
    np.testing.assert_allclose(tr.numpy(), r, rtol=0,
                               atol=4 * np.spacing(np.abs(r).max()))
    assert aux["payload_floats_per_worker"] == C.payload_floats(
        d, port.sparsifier)


def test_state_layout_dtypes_and_bytes():
    """The full layout: momentum and mirror in momentum_dtype, previous
    gradients float32, as the reference's; a pruned layout raises."""
    for mdt, tdt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        ref, port = cell(mdt=mdt)
        st = Alg.init_state(port, 64, device="cpu")
        jst = JAlg.init_state(ref, 64)
        assert st.momentum.dtype == st.mirror.dtype == tdt
        assert st.prev_grad.dtype == torch.float32
        assert str(jst.momentum.dtype) == mdt
        assert Alg.server_state_bytes(port, 1000) == \
            JAlg.server_state_bytes(ref, 1000)
    pruned = dataclasses.replace(port, state_layout=Alg.StateLayout(
        mirror=False, prev_grad=False))
    with pytest.raises(ValueError, match="prunes"):
        Alg.init_state(pruned, 64, device="cpu")
    with pytest.raises(ValueError, match="mirror/prev_grad"):
        Alg.server_round(port, Alg.init_state(
            dataclasses.replace(port, name="rosdhb"), 64, device="cpu"),
            torch.zeros(N, 64), ReplayDraws("cpu"))


QD, QSTEPS = 200, 20


def test_fig1_alie_dasha_quadratic_rollout():
    """20 rounds of fig1-alie with dasha against the reference's
    ``Simulator.rollout``, its per-worker draws replayed along its key chain
    (``simulator.py:142`` splits (key, mask_key), ``algorithms.py:819``
    (mask_key, atk_key), ``compression.py:175`` n worker keys). Bound: 8
    ulp of the largest parameter, as RoSDHB's rollout: the rounds agree up
    to the aggregation's summation order and ALIE's fused rows (a few ulp a
    round, damped by the step); 1 ulp was seen."""
    ref, port = cell()
    loss_fn, params0, batch_fn, tg = jax_quadratic(N, d=QD, seed=0)
    jsim = JSimulator(loss_fn, params0, ref)
    jstate, jm = jsim.rollout(jsim.init(0), batch_fn, steps=QSTEPS)
    want = np.asarray(jstate.params_flat)

    k = port.sparsifier.k(QD)
    key, perms = jax.random.PRNGKey(0), []
    for _ in range(QSTEPS):
        key, mask_key = jax.random.split(key)
        mask_key, _ = jax.random.split(mask_key)
        perms += local_draws(mask_key, N, lambda kk: jax.random.permutation(
            kk, QD)[:k])
    tloss, tparams, tbatch, _ = quadratic_testbed(N, d=QD, targets=tg,
                                                 device="cpu")
    sim = Simulator(tloss, tparams, port, device="cpu")
    draws = ReplayDraws("cpu", permutations=perms)
    state, m = sim.rollout(sim.init(draws=draws), tbatch, steps=QSTEPS)
    assert draws.remaining == 0 and state.server.step == QSTEPS
    got = state.params_flat.numpy()
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 8 * ulp, np.abs(got - want).max() / ulp
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    opt = tg[F:].mean(axis=0)
    assert np.linalg.norm(got - opt) < np.linalg.norm(opt)
    assert sim.server_state_bytes() == jsim.server_state_bytes()
    assert sim.payload_bytes_per_round() == jsim.payload_bytes_per_round()
