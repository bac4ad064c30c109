"""The port's adversaries (``repro_torch.adversary``) against the reference's
``repro.adversary``: one step and 10 carried rounds of each adversary on the
same honest rows with the reference's own draws (gauss's normals and
ipm_greedy's coins from the key ``step`` takes), the attack bank against
the lone steps, and the bank metadata.

Tolerances: linear and gauss bitwise (the row statistics sum in the
reference's order); mimic and spectral rtol 1e-5 on rows and state (the
power iteration's reductions run in another order); ipm_greedy the same
arm every round and rows within rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adversary import core as JADV
from repro.core import attacks as JA
from repro_torch.adversary import core as ADV
from repro_torch.core import attacks as A
from repro_torch.testing import ReplayDraws

H, F, D, ROUNDS = 10, 3, 64, 10
COEFFS = {"linear": (1.0, -1.5), "mimic": (0.0, 0.0), "gauss": (0.7, 0.0),
          "spectral": (1.5, 0.0), "ipm_greedy": (0.5, 5.0)}


def _honest(t, h=H, d=D):
    rng = np.random.default_rng(100 + t)
    drift = np.linspace(0.0, 1.0, d, dtype=np.float32) * 0.1 * t
    return (rng.normal(size=(h, d)) + drift).astype(np.float32)


def _reference_draws(name, key, f=F, d=D):
    """What the reference's step draws from ``key``, for ReplayDraws."""
    if name == "gauss":
        return {"normals": [np.asarray(jax.random.normal(key, (f, d)))]}
    if name == "ipm_greedy":
        k1, k2 = jax.random.split(key)
        return {"uniforms": [np.array([jax.random.uniform(k1, ()),
                                       jax.random.uniform(k2, ())],
                                      np.float32)]}
    return {}


def _run_both(name, rounds):
    """``rounds`` carried steps of adversary ``name`` in both packages."""
    jstate = JADV.init_attack_state(D)
    state = ADV.init_attack_state(D)
    coeffs = COEFFS[name]
    out = []
    for t in range(rounds):
        honest = _honest(t)
        key = jax.random.PRNGKey(7 + t)
        jstate, jbyz = JADV.ADVERSARIES[name].step(
            jstate, jnp.asarray(honest), F, key, jnp.asarray(coeffs,
                                                             jnp.float32))
        draws = ReplayDraws("cpu", **_reference_draws(name, key))
        state, byz = ADV.ADVERSARIES[name].step(state, torch.tensor(honest),
                                                F, draws, coeffs)
        assert draws.remaining == 0
        out.append((jstate, np.asarray(jbyz), state, byz.numpy()))
    return out


@pytest.mark.parametrize("rounds", [1, ROUNDS])
@pytest.mark.parametrize("name", ["linear", "gauss"])
def test_stateless_adversaries_bitwise(name, rounds):
    for jstate, jbyz, state, byz in _run_both(name, rounds):
        np.testing.assert_array_equal(byz, jbyz)
        assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("rounds", [1, ROUNDS])
@pytest.mark.parametrize("name", ["mimic", "spectral"])
def test_tracked_adversaries_match(name, rounds):
    for jstate, jbyz, state, byz in _run_both(name, rounds):
        np.testing.assert_allclose(byz, jbyz, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state.vec.numpy(), np.asarray(jstate.vec),
                                   rtol=1e-5, atol=1e-6)
        assert int(state.step) == int(jstate.step)


@pytest.mark.parametrize("rounds", [1, ROUNDS])
def test_ipm_greedy_same_arms_under_same_draws(rounds):
    arms = []
    for jstate, jbyz, state, byz in _run_both("ipm_greedy", rounds):
        assert float(state.scalars[2]) == float(jstate.scalars[2])
        arms.append(int(state.scalars[2]))
        np.testing.assert_allclose(byz, jbyz, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(state.scalars.numpy(),
                                   np.asarray(jstate.scalars), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu),
                                   rtol=1e-5, atol=1e-6)
    if rounds == ROUNDS:
        assert set(arms) == {0, 1}  # both arms are played


def test_linear_step_is_the_stateless_alie():
    honest = torch.tensor(_honest(3))
    _, byz = ADV.ADVERSARIES["linear"].step(
        ADV.init_attack_state(D), honest, F, None, (1.0, -1.5))
    assert torch.equal(byz, A.alie(honest, F, z=1.5))


def _mixed_lanes(b=15, seed=5):
    rng = np.random.default_rng(seed)
    entries = ADV.DEFAULT_ATTACK_BANK
    idx = [(3 * i + 1) % len(entries) for i in range(b)]
    honest = torch.tensor(rng.normal(size=(b, H, D)).astype(np.float32))
    coeffs = torch.tensor([COEFFS[entries[i]] for i in idx],
                          dtype=torch.float32)
    state = ADV.init_attack_state(D, lanes=b)._replace(
        vec=torch.tensor(rng.normal(size=(b, D)).astype(np.float32)),
        mu=torch.tensor(rng.normal(size=(b, D)).astype(np.float32)),
        scalars=torch.tensor(np.tile([0.3, 0.5, 1.0, 0.0], (b, 1)),
                             dtype=torch.float32),
        step=torch.tensor([i % 3 for i in range(b)], dtype=torch.int32))
    draws = ADV.AttackDraws(
        normal=torch.tensor(rng.normal(size=(b, F, D)).astype(np.float32)),
        uniform=torch.tensor(rng.uniform(size=(b, 2)).astype(np.float32)))
    return entries, idx, honest, coeffs, state, draws


def test_every_attack_bank_branch_equals_its_lone_step():
    """A mixed [B, h, d] batch, each lane's branch chosen by ``idx``: every
    lane's rows and state are its lone step's, bitwise."""
    entries, idx, honest, coeffs, state, draws = _mixed_lanes()
    new, byz = ADV.make_attack_bank(entries, F)(state, honest, draws, idx,
                                                coeffs)
    assert byz.shape == (len(idx), F, D)
    for i, e in enumerate(idx):
        lone = ADV.AttackState(*(t[i] for t in state))
        replay = ReplayDraws("cpu", normals=[draws.normal[i].numpy()],
                             uniforms=[draws.uniform[i].numpy()])
        st, b = ADV.ADVERSARIES[entries[e]].step(lone, honest[i], F, replay,
                                                 coeffs[i])
        assert torch.equal(b, byz[i]), entries[e]
        for got, want in zip(new, st):
            assert torch.equal(got[i], want), entries[e]


def test_attack_bank_matches_the_reference_switch():
    """The port's bank against the reference's ``lax.switch`` bank, lane by
    lane. ``lax.switch`` compiles its branches, and XLA fuses the row
    statistics there, so the stateless lanes differ from the eager step's
    rows (which the port matches bitwise, above) by a few ulp, as the
    compiled round's ALIE rows do (``test_torch_simulator.test_one_round``):
    rtol 1e-6 with atol 1e-6 for them (near-cancelling entries), rtol 1e-5
    for the rest."""
    entries, idx, honest, coeffs, state, draws = _mixed_lanes(b=5, seed=9)
    new, byz = ADV.make_attack_bank(entries, F)(state, honest, draws, idx,
                                                coeffs)
    jbank = JADV.make_attack_bank(entries, F)
    for i, e in enumerate(idx):
        jstate = JADV.AttackState(*(jnp.asarray(t[i].numpy())
                                    for t in state))
        key = jax.random.PRNGKey(i)
        name = entries[e]
        got_draws = ADV.AttackDraws(normal=None, uniform=None)
        if name == "gauss":
            got_draws = ADV.AttackDraws(normal=torch.tensor(np.asarray(
                jax.random.normal(key, (F, D))))[None])
        if name == "ipm_greedy":
            u = _reference_draws(name, key)["uniforms"][0]
            got_draws = ADV.AttackDraws(uniform=torch.tensor(u)[None])
        js, jb = jbank(jstate, jnp.asarray(honest[i].numpy()), key, e,
                       jnp.asarray(coeffs[i].numpy()))
        st, b = ADV.make_attack_bank(entries, F)(
            ADV.AttackState(*(t[i:i + 1] for t in state)), honest[i:i + 1],
            got_draws, [e], coeffs[i:i + 1])
        if name in ("linear", "gauss"):
            np.testing.assert_allclose(b[0].numpy(), np.asarray(jb),
                                       rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(b[0].numpy(), np.asarray(jb),
                                       rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(st.vec[0].numpy(), np.asarray(js.vec),
                                   rtol=1e-5, atol=1e-6)
        assert int(st.step[0]) == int(js.step)
    assert byz.shape == (5, F, D) and new.step.shape == (5,)


@pytest.mark.parametrize("n,f", [(13, 3), (10, 2), (9, 1), (5, 0)])
def test_bank_metadata_matches_the_reference(n, f):
    assert ADV.DEFAULT_ATTACK_BANK == JADV.DEFAULT_ATTACK_BANK
    assert ADV.KNOWN_ATTACKS == JADV.KNOWN_ATTACKS
    assert tuple(ADV.ADVERSARIES) == tuple(JADV.ADVERSARIES)
    for name in ADV.ADVERSARIES:
        assert ADV.ADVERSARIES[name].stateful == JADV.ADVERSARIES[
            name].stateful
        assert ADV.ADVERSARIES[name].default_coeffs == JADV.ADVERSARIES[
            name].default_coeffs
    for name in ADV.KNOWN_ATTACKS + ("linear", "bank"):
        for scale in (None, 2.0):
            cfg = A.AttackConfig(name=name, scale=scale)
            jcfg = JA.AttackConfig(name=name, scale=scale)
            assert ADV.bank_entry(cfg, n, f) == JADV.bank_entry(jcfg, n, f)
            if JADV.bank_entry(jcfg, n, f) is not None:
                np.testing.assert_array_equal(
                    ADV.static_coeffs(cfg, n, f).numpy(),
                    np.asarray(JADV.static_coeffs(jcfg, n, f)))
            else:
                with pytest.raises(ValueError, match="no bank entry"):
                    ADV.static_coeffs(cfg, n, f)
        assert ADV.is_stateful(name) == JADV.is_stateful(name)
        assert (ADV.needs_attack_state(name, f)
                == JADV.needs_attack_state(name, f))
    for name in ADV.DEFAULT_ATTACK_BANK:
        assert ADV.attack_index(name) == JADV.attack_index(name)
        assert (ADV.attack_index(name, ("gauss", name))
                == JADV.attack_index(name, ("gauss", name)))
    with pytest.raises(ValueError, match="not a branch"):
        ADV.attack_index("mimic", ("linear",))


def test_attack_bank_refuses_unknown_entries_and_indices():
    with pytest.raises(ValueError, match="unknown attack-bank entries"):
        ADV.make_attack_bank(("linear", "alie"), F)
    with pytest.raises(ValueError, match="at least one"):
        ADV.make_attack_bank((), F)
    entries, idx, honest, coeffs, state, draws = _mixed_lanes(b=3)
    with pytest.raises(ValueError, match="outside the bank"):
        ADV.make_attack_bank(("linear",), F)(state, honest, draws,
                                             [0, 1, 0], coeffs)


def test_init_attack_state_shapes():
    st = ADV.init_attack_state(D)
    jst = JADV.init_attack_state(D)
    for got, want in zip(st, jst):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    lanes = ADV.init_attack_state(D, lanes=6)
    assert lanes.vec.shape == (6, D) and lanes.step.shape == (6,)
