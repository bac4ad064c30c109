"""The LLM train step of the port against the reference's
``build_train_step`` (host mesh, naive flatten): reduced ``stablelm_3b``,
n = 8 workers, global Block-RandK at 0.05 with 512-wide blocks (the
reference on its Pallas round trip in interpret mode), ALIE, CWTM with
f = 1, float32 momentum, three steps from the same parameters, batches and
block ids. The reference's attention runs its plain XLA path: its gradient
through the Pallas flash kernel fails."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ArchSpec as JArchSpec
from repro.configs.base import InputShape as JInputShape
from repro.core import AggregatorConfig as JAgg
from repro.core import AttackConfig as JAtk
from repro.core import SparsifierConfig as JSp
from repro.core import algorithms as JAlg
from repro.launch import steps as JS
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.configs.base import ArchSpec, InputShape
from repro_torch.core import AggregatorConfig, AttackConfig, SparsifierConfig
from repro_torch.core import algorithms as Alg
from repro_torch.launch import steps as S
from repro_torch.launch import train as TR
from repro_torch.testing import ReplayDraws, from_jax_params
from repro_torch.utils.tree import tree_leaves

N, SEQ, STEPS, GAMMA = 8, 128, 3, 0.5


def _overrides(sp, agg, atk):
    return {"name": "rosdhb", "f": 1, "gamma": GAMMA,
            "momentum_dtype": "float32",
            "sparsifier": sp(kind="block", ratio=0.05, block_size=512),
            "aggregator": agg(name="cwtm", f=1),
            "attack": atk(name="alie")}


@pytest.fixture(scope="module")
def runs():
    """Three steps of the reference (compiled once) and of the port, from
    the same parameters, batches and block ids."""
    jmodel = jax_get_arch("stablelm_3b").model.reduced(
        n_layers=2, d_model=256).with_overrides(vocab_size=512,
                                                use_flash_attention=False)
    shape = ("host_train", SEQ, N, "train")
    mesh = make_host_mesh()
    jov = _overrides(JSp, JAgg, JAtk)
    jov["sparsifier"] = JSp(kind="block", ratio=0.05, block_size=512,
                            use_pallas=True)
    jplan = JS.make_train_plan(JArchSpec(jmodel, "test"), JInputShape(*shape),
                               mesh, jov, n_workers=N)
    jstep = jax.jit(JS.build_train_step(jplan, mesh))
    d = jplan.flat_spec.padded_size
    params = JT.model_init(jax.random.PRNGKey(0), jplan.model)
    p0 = jax.tree.map(np.asarray, params)
    key = jax.random.PRNGKey(1)
    jstate = JS.TrainState(params, JAlg.init_state(jplan.algo, d),
                           jnp.zeros((), jnp.int32), key)
    rng = np.random.default_rng(0)
    batches = [TR.make_batch(rng, jmodel.vocab_size, N, 1, SEQ)
               for _ in range(STEPS)]
    # the block ids along the reference's key chain: steps.py:131 splits
    # (key, round_key), algorithms.py:819 (mask_key, atk_key),
    # compression.py:275 permutes the block ids
    nb = d // 512
    kb = max(1, int(round(0.05 * nb)))
    ids = []
    ref = {"loss": [], "dir_norm": [], "payload": []}
    for b in batches:
        key, round_key = jax.random.split(key)
        mask_key, _ = jax.random.split(round_key)
        ids.append(np.asarray(jax.random.permutation(mask_key, nb)[:kb]))
        with mesh:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(b)})
        ref["loss"].append(float(m["loss"]))
        ref["dir_norm"].append(float(m["dir_norm"]))
        ref["payload"].append(float(m["payload_floats_per_worker"]))
    ref["params"] = [np.asarray(a) for a in
                     jax.tree_util.tree_leaves(jstate.params)]

    model = get_arch("stablelm_3b").model.reduced(
        n_layers=2, d_model=256).with_overrides(vocab_size=512)
    plan = S.make_train_plan(ArchSpec(model, "test"), InputShape(*shape),
                             _overrides(SparsifierConfig, AggregatorConfig,
                                        AttackConfig), n_workers=N)
    step = S.build_train_step(plan, device="cpu")
    state = S.TrainState(from_jax_params(p0),
                         Alg.init_state(plan.algo, d, device="cpu"), 0,
                         ReplayDraws("cpu", permutations=ids))
    port = {"loss": [], "dir_norm": [], "payload": []}
    for b in batches:
        state, m = step(state, {"tokens": torch.from_numpy(b)})
        port["loss"].append(float(m["loss"]))
        port["dir_norm"].append(float(m["dir_norm"]))
        port["payload"].append(m["payload_floats_per_worker"])
    port["params"] = [t.numpy() for t in tree_leaves(state.params)]
    port["draws_left"] = state.draws.remaining
    port["plan"] = plan
    ref["plan"] = jplan
    ref["p0"] = jax.tree_util.tree_leaves(p0)
    ref["ids"] = ids
    return ref, port


def test_plans_agree(runs):
    ref, port = runs
    jp, p = ref["plan"], port["plan"]
    assert p.flat_spec.padded_size == jp.flat_spec.padded_size == 1_313_280
    assert (p.n_workers, p.local_batch) == (jp.n_workers, jp.local_batch)
    assert (p.algo.f, p.algo.gamma, p.algo.beta) == (jp.algo.f, jp.algo.gamma,
                                                     jp.algo.beta)
    assert port["payload"] == ref["payload"]
    assert port["draws_left"] == 0


def test_losses_and_directions_match(runs):
    """Honest loss within rtol 2e-3 and |R| within rtol 2e-2 at each of the
    three steps. Both sides differentiate with respect to bf16 parameters,
    so activations and gradients round to bf16 (relative 2^-9) at places
    the two frameworks choose differently; the loss averages 7 x 127 token
    losses, |R| is a norm over the 5% of coordinates CWTM keeps of the
    momentum of those bf16 gradients."""
    ref, port = runs
    np.testing.assert_allclose(port["loss"], ref["loss"], rtol=2e-3)
    np.testing.assert_allclose(port["dir_norm"], ref["dir_norm"], rtol=2e-2)


def test_parameters_after_three_steps_match(runs):
    """Each parameter leaf after three steps: its distance to the
    reference's within 5e-2 of the reference's own update (the bf16
    gradient noise above, at most 3 steps of it). Coordinates in no block
    any step selected have zero momentum, so a zero direction: both
    packages leave them bitwise as they were."""
    ref, port = runs
    for got, want, p0 in zip(port["params"], ref["params"], ref["p0"]):
        update = np.abs(want - p0).max()
        assert np.abs(got - want).max() <= 5e-2 * update + 1e-7
    flat = lambda leaves: np.concatenate(  # noqa: E731
        [np.ravel(a) for a in leaves])
    p0, got, want = flat(ref["p0"]), flat(port["params"]), flat(ref["params"])
    sel = np.zeros(port["plan"].flat_spec.padded_size // 512, bool)
    for ids in ref["ids"]:
        sel[ids] = True
    untouched = ~np.repeat(sel, 512)[:p0.size]
    assert 0.8 < untouched.mean() < 0.9
    np.testing.assert_array_equal(got[untouched], p0[untouched])
    np.testing.assert_array_equal(want[untouched], p0[untouched])
