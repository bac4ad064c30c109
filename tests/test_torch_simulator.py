"""One server round and whole fig1-alie trajectories of the port against the
reference's compiled ``server_round`` and ``Simulator.rollout``, with the
reference's own RandK draws injected (``ReplayDraws``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary.heterogeneity import dirichlet_mnist as jax_dirichlet
from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import attacks as JA
from repro.core import compression as JC
from repro.core.simulator import Simulator as JSimulator
from repro.core.sweep import quadratic_testbed as jax_quadratic
from repro.models import cnn_init as jax_cnn_init
from repro.models import cnn_loss as jax_cnn_loss
from repro_torch.adversary.heterogeneity import dirichlet_mnist
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.core import Simulator, quadratic_testbed
from repro_torch.models import cnn_loss
from repro_torch.testing import ReplayDraws, from_jax_params

N, F = 13, 3


def fig1_alie(name="rosdhb"):
    """The fig1-alie registry cell in both packages (``grid_scenarios``
    defaults: global RandK 0.1, ALIE z=1.5, NNM+CWTM with f=max(f,1); dgd
    pairs with the mean)."""
    agg = "mean" if name == "dgd" else "cwtm"
    ref = JAlg.AlgorithmConfig(
        name=name, n_workers=N, f=F, gamma=0.05, beta=0.9,
        sparsifier=JC.SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=JG.AggregatorConfig(name=agg, f=max(F, 1), pre_nnm=True),
        attack=JA.AttackConfig(name="alie", z=1.5))
    port = Alg.AlgorithmConfig(
        name=name, n_workers=N, f=F, gamma=0.05, beta=0.9,
        sparsifier=C.SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=G.AggregatorConfig(name=agg, f=max(F, 1), pre_nnm=True),
        attack=A.AttackConfig(name="alie", z=1.5))
    return ref, port


def reference_draws(seed, steps, d, k):
    """RandK prefixes along the reference's key chain: simulator.py:142
    splits (key, mask_key), algorithms.py:819 splits (mask_key, atk_key),
    compression.py:77 permutes."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, mask_key = jax.random.split(key)
        mask_key, _ = jax.random.split(mask_key)
        out.append(np.asarray(jax.random.permutation(mask_key, d)[:k]))
    return out


# ----------------------------------------------------------------------- #
# one round
# ----------------------------------------------------------------------- #

D = 500


def _round_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(D,)).astype(np.float32))


@pytest.mark.parametrize("name", ["rosdhb", "dgd", "robust_dgd"])
def test_one_round(name):
    """Compression, momentum and apply are bitwise; aggregation rtol 1e-5.

    The reference's round is compiled, and XLA fuses ALIE's statistics with
    the rest of the round: the f Byzantine rows then differ from the eager
    ``attacks.alie`` (which the port matches bitwise, test_torch_attacks)
    by at most 4 ulp. Honest rows are bitwise."""
    ref, port = fig1_alie(name)
    g, m0, p0 = _round_inputs()
    key = jax.random.PRNGKey(3)
    mask_key = jax.random.split(key)[0]
    perm = np.asarray(jax.random.permutation(mask_key, D)[:ref.sparsifier.k(D)])
    st = JAlg.init_state(ref, D)._replace(momentum=jnp.asarray(m0))

    @jax.jit
    def ref_round(st, g, key, p):
        r, new, _ = JAlg.server_round(ref, st, g, key)
        wire = JAlg._compressed_wire(ref, None, g, jax.random.split(key)[0],
                                     None)[0]
        return r, new.momentum, JAlg.apply_direction(p, r, ref.gamma), wire

    r, mom, _, wire = (np.asarray(a) for a in ref_round(st, g, key, p0))

    tst = Alg.init_state(port, D, device="cpu")._replace(
        momentum=torch.tensor(m0))
    twire = Alg._compressed_wire(port, torch.tensor(g),
                                 ReplayDraws("cpu", permutations=[perm]))
    tr, tnew, aux = Alg.server_round(port, tst, torch.tensor(g),
                                     ReplayDraws("cpu", permutations=[perm]))
    if name == "robust_dgd":
        twire = Alg._byzantine_overwrite(port, torch.tensor(g))
        wire = np.asarray(jax.jit(lambda g: JAlg._byzantine_overwrite(
            ref, None, g, key)[0])(g))
    np.testing.assert_array_equal(twire.numpy()[F:], wire[F:])
    np.testing.assert_array_max_ulp(twire.numpy()[:F], wire[:F], maxulp=4)
    scale = float(np.abs(r).max())
    np.testing.assert_allclose(tr.numpy(), r, rtol=1e-5, atol=1e-5 * scale)
    assert aux["payload_floats_per_worker"] == (
        D if name == "robust_dgd" else ref.sparsifier.k(D))
    if name == "rosdhb":
        np.testing.assert_array_equal(tnew.momentum.numpy()[F:], mom[F:])
        # (1-beta) times a few-ulp wire difference, near cancellation
        np.testing.assert_allclose(tnew.momentum.numpy()[:F], mom[:F],
                                   rtol=0, atol=4 * np.spacing(np.float32(
                                       np.abs(wire[:F]).max())))
        # momentum from the same wire: bitwise, Byzantine rows included
        mj = jax.jit(lambda st, w: JAlg._rosdhb_apply(
            ref, JG.make_aggregator(ref.aggregator), st, w,
            JAlg.static_hparams(ref))[1].momentum)(st, wire)
        mt = Alg._rosdhb_apply(port, G.make_aggregator(port.aggregator, "cpu"),
                               tst, torch.tensor(wire),
                               Alg.static_hparams(port))[1].momentum
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    else:
        np.testing.assert_array_equal(tnew.momentum.numpy(), m0)
    assert tnew.step == 1
    # apply from the same direction: bitwise
    pj = jax.jit(lambda p, r: JAlg.apply_direction(p, r, ref.gamma))(p0, r)
    np.testing.assert_array_equal(
        Alg.apply_direction(torch.tensor(p0), torch.tensor(r),
                            port.gamma).numpy(), np.asarray(pj))


@pytest.mark.parametrize("name", ["rosdhb", "dasha", "robust_dgd", "dgd"])
@pytest.mark.parametrize("d", [64, 11958, 1048576])
def test_accounting_matches(name, d):
    ref, port = fig1_alie("rosdhb")
    ref = JAlg.AlgorithmConfig(**{**ref.__dict__, "name": name})
    port = Alg.AlgorithmConfig(**{**port.__dict__, "name": name})
    assert Alg.server_state_bytes(port, d) == JAlg.server_state_bytes(ref, d)
    assert Alg.algo_payload_bytes(port, d) == JAlg.algo_payload_bytes(ref, d)
    assert Alg.static_hparams(port) == JAlg.static_hparams(ref)


def test_theorem1_beta():
    ref = JAlg.AlgorithmConfig(beta=None, gamma=0.001, smoothness_L=2.0)
    port = Alg.AlgorithmConfig(beta=None, gamma=0.001, smoothness_L=2.0)
    assert port.resolved_beta() == ref.resolved_beta()
    with pytest.raises(ValueError, match="too large"):
        Alg.AlgorithmConfig(beta=None, gamma=1.0).resolved_beta()


# ----------------------------------------------------------------------- #
# whole trajectories
# ----------------------------------------------------------------------- #

QD, QSTEPS = 200, 20


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fig1_alie_quadratic_rollout(seed):
    """Bound: 8 ulp of the largest parameter after 20 rounds. Gradients,
    compression and momentum are bitwise; the aggregation sums in another
    order (rtol ~1e-7 a round) and the compiled reference fuses ALIE's rows
    (<= 4 ulp a round), and both are damped by the momentum and the step."""
    ref, port = fig1_alie()
    loss_fn, params0, batch_fn, tg = jax_quadratic(N, d=QD, seed=seed)
    jsim = JSimulator(loss_fn, params0, ref)
    jstate, jm = jsim.rollout(jsim.init(seed), batch_fn, steps=QSTEPS)
    want = np.asarray(jstate.params_flat)

    tloss, tparams, tbatch, _ = quadratic_testbed(N, d=QD, targets=tg,
                                                 device="cpu")
    sim = Simulator(tloss, tparams, port, device="cpu")
    draws = ReplayDraws("cpu", permutations=reference_draws(
        seed, QSTEPS, QD, port.sparsifier.k(QD)))
    state, m = sim.rollout(sim.init(draws=draws), tbatch, steps=QSTEPS)
    assert draws.remaining == 0
    got = state.params_flat.numpy()
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 8 * ulp, np.abs(got - want).max() / ulp
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(m["dir_norm"].numpy(),
                               np.asarray(jm["dir_norm"]), rtol=1e-5)
    opt = tg[F:].mean(axis=0)
    assert np.linalg.norm(got - opt) < np.linalg.norm(opt)


CNN_STEPS = 20


def test_fig1_alie_cnn_honest_loss_curve():
    """fig1-alie on the paper's CNN for 20 rounds, the reference's weights
    and draws. Bound: rtol 1e-4 on the honest-loss curve (ROADMAP's bar):
    float32 convolutions in another order feed the same robust round."""
    ref, port = fig1_alie()
    params = jax_cnn_init(jax.random.PRNGKey(0))
    jds = jax_dirichlet(n_workers=N, per_worker=120, seed=0)
    jsim = JSimulator(jax_cnn_loss, params, ref)
    _, jm = jsim.rollout(jsim.init(0), jds.worker_batches(32),
                         steps=CNN_STEPS)
    want = np.asarray(jm["loss"])

    ds = dirichlet_mnist(n_workers=N, per_worker=120, seed=0)
    sim = Simulator(cnn_loss, from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)), port, device="cpu")
    draws = ReplayDraws("cpu", permutations=reference_draws(
        0, CNN_STEPS, sim.d, port.sparsifier.k(sim.d)))
    _, m = sim.rollout(sim.init(draws=draws), ds.worker_batches(32),
                       steps=CNN_STEPS)
    got = m["loss"].numpy()
    assert np.isfinite(got).all() and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_run_records_eval_and_bytes():
    _, port = fig1_alie()
    loss_fn, params0, batch_fn, tg = quadratic_testbed(N, d=50, seed=4,
                                                      device="cpu")
    sim = Simulator(loss_fn, params0, port,
                    eval_fn=lambda p, b: {"err": torch.linalg.vector_norm(
                        p["w"] - b)}, device="cpu")
    state, hist = sim.run(sim.init(0), batch_fn, steps=7, eval_every=3,
                          eval_batch=tg[F:].mean(0))
    assert hist["step"] == [0, 3, 6]
    assert hist["comm_bytes"] == [sim.payload_bytes_per_round() * (t + 1)
                                  for t in (0, 3, 6)]
    assert hist["err"][-1] < hist["err"][0]
    assert state.server.step == 7
    assert sim.payload_bytes_per_round() == 13 * 5 * 4
