"""``repro_torch.optim`` against ``repro.optim``: each optimizer's update
trees and states over 5 steps from the same numpy parameters and
gradients (the reference run eagerly, each operation rounded as it
lands), ``apply_updates``' cast to the parameter's dtype, the quadratic
the reference's own test minimises, and the cosine schedule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim
from repro_torch.utils.tree import tree_leaves

import jax

STEPS = 5


def _tree(rng):
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(3, 4)).astype(np.float32)},
                       {"w": rng.normal(size=(4, 2)).astype(np.float32)}]}


def _to_torch(t):
    if isinstance(t, dict):
        return {k: _to_torch(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_to_torch(v) for v in t]
    return torch.tensor(t)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _equal(port, ref):
    pl = tree_leaves(port)
    rl = jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(rl)
    for p, r in zip(pl, rl):
        np.testing.assert_array_equal(_bits(p.numpy()), _bits(r))


MAKERS = {
    "sgd": (lambda m: m.sgd(0.1)),
    "heavy_ball": (lambda m: m.heavy_ball(0.1, beta=0.8)),
    "adamw": (lambda m: m.adamw(0.05, weight_decay=0.01)),
    "adamw_defaults": (lambda m: m.adamw(1e-3)),
}


@pytest.mark.parametrize("make", list(MAKERS))
def test_updates_and_states_are_the_references(make):
    rng = np.random.default_rng(7)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(STEPS)]
    opt, jo = MAKERS[make](optim), MAKERS[make](jopt)
    params, jparams = _to_torch(p0), jax.tree_util.tree_map(jnp.asarray, p0)
    state, jstate = opt.init(params), jo.init(jparams)
    for g in grads:
        upd, state = opt.update(_to_torch(g), state, params)
        jupd, jstate = jo.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jstate, jparams)
        _equal(upd, jupd)
        _equal(state, jstate) if make != "adamw" and make != \
            "adamw_defaults" else (_equal(state.mu, jstate.mu),
                                   _equal(state.nu, jstate.nu))
        params = optim.apply_updates(params, upd)
        jparams = jopt.apply_updates(jparams, jupd)
        _equal(params, jparams)
    if make.startswith("adamw"):
        assert int(state.count) == int(jstate.count) == STEPS
        assert state.count.dtype == torch.int32


def test_apply_updates_casts_to_the_parameters_dtype():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    u = {"a": torch.full((3,), 1e-3), "b": torch.full((2,), 1e-3,
                                                        dtype=torch.float64)}
    out = optim.apply_updates(p, u)
    assert out["a"].dtype == torch.bfloat16 and out["b"].dtype == \
        torch.float32
    jp = {"a": jnp.ones(3, jnp.bfloat16), "b": jnp.ones(2)}
    ju = {"a": jnp.full((3,), 1e-3), "b": jnp.full((2,), 1e-3)}
    jout = jopt.apply_updates(jp, ju)
    np.testing.assert_array_equal(out["a"].float().numpy(),
                                  np.asarray(jout["a"].astype(jnp.float32)))


@pytest.mark.parametrize("make", ["sgd", "heavy_ball", "adamw"])
def test_optimizers_minimise_quadratic(make):
    opt = {"sgd": optim.sgd(0.1), "heavy_ball": optim.heavy_ball(0.1),
           "adamw": optim.adamw(0.05)}[make]
    params = {"x": torch.ones(4) * 5.0}
    state = opt.init(params)
    for _ in range(300):
        upd, state = opt.update({"x": 2 * params["x"]}, state, params)
        params = optim.apply_updates(params, upd)
    assert float(params["x"].abs().max()) < 1e-2


def test_cosine_schedule_is_the_references():
    lr, jlr = (m.cosine_schedule(0.3, warmup=10, total=100)
               for m in (optim, jopt))
    for step in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        got, want = float(lr(step)), float(jlr(step))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9), step
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(0.3, abs=1e-6)
    assert float(lr(100)) == pytest.approx(0.0, abs=1e-6)
    assert lr(torch.tensor(3)).dtype == torch.float32
