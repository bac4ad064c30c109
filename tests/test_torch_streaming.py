"""Streamed rollouts of the port (``Simulator.rollout_streaming``, the
streamed grid and ``execute_plan``), ``rollout_with_snapshots``,
``run_per_round`` and ``stack_batches``' limit: against the port's own
materialised runs (bitwise) and against the reference's on the quadratic
testbed with its own RandK draws replayed (``ReplayDraws``).

Bounds: trajectories within 8 ulp of max |w| of the reference's (the
bar of ``ROADMAP.md``, as ``test_torch_simulator``), per-round metrics
rtol 1e-5; early-exit decisions equal, for thresholds with a clear margin
at every chunk boundary."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as JG
from repro.core import algorithms as JAlg
from repro.core import attacks as JA
from repro.core import compression as JC
from repro.core import simulator as JSim
from repro.core import sweep as JS
from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as Alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.core import simulator as Sim
from repro_torch.core import sweep as S
from repro_torch.testing import ReplayDraws

N, F, D, STEPS = 13, 3, 48, 50


def _cfgs(algo="rosdhb", local=False, attack="alie"):
    """The fig1-alie cell's shape in both packages (dgd takes the mean)."""
    agg = "mean" if algo == "dgd" else "cwtm"
    ratio = 1.0 if algo == "robust_dgd" else 0.2
    kw = dict(name=algo, n_workers=N, f=F, gamma=0.05, beta=0.9)
    z = 1.5 if attack == "alie" else None
    ref = JAlg.AlgorithmConfig(
        sparsifier=JC.SparsifierConfig(kind="randk", ratio=ratio,
                                       local=local),
        aggregator=JG.AggregatorConfig(name=agg, f=F, pre_nnm=agg != "mean"),
        attack=JA.AttackConfig(name=attack, z=z), **kw)
    port = Alg.AlgorithmConfig(
        sparsifier=C.SparsifierConfig(kind="randk", ratio=ratio, local=local),
        aggregator=G.AggregatorConfig(name=agg, f=F, pre_nnm=agg != "mean"),
        attack=A.AttackConfig(name=attack, z=z), **kw)
    return ref, port


def _noisy_batches(tg):
    """A per-round batch that is a pure function of t (so a stream and a
    stacked schedule see the same rounds)."""
    def batch_fn(t):
        rng = np.random.default_rng((1, t))
        return {"target": (np.asarray(tg) + 0.05 * rng.normal(
            size=np.shape(tg))).astype(np.float32)}
    return batch_fn


def _port_sim(cfg, eval_fn=None):
    loss, p0, _, tg = S.quadratic_testbed(N, d=D, device="cpu")
    return Sim.Simulator(loss, p0, cfg, eval_fn=eval_fn, device="cpu"), \
        _noisy_batches(tg.numpy())


def _ref_draws(cfg, seed, steps):
    """RandK prefixes along the reference's key chain (``simulator.py:142``,
    ``algorithms.py:819``; local masks split the mask key per worker)."""
    key = jax.random.PRNGKey(seed)
    k = cfg.sparsifier.k(D)
    perms = []
    for _ in range(steps):
        key, mask_key = jax.random.split(key)
        mask_key, _ = jax.random.split(mask_key)
        if cfg.sparsifier.ratio >= 1.0:
            continue
        keys = (jax.random.split(mask_key, N) if cfg.sparsifier.local
                or cfg.name == "dasha" else [mask_key])
        perms += [np.asarray(jax.random.permutation(kk, D)[:k])
                  for kk in keys]
    return ReplayDraws("cpu", permutations=perms)


def _ulps(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.spacing(
        np.float32(np.abs(want).max()))


# ----------------------------------------------------------------------- #
# streamed == materialised, bitwise (the port against itself)
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("chunk,depth,source", [
    (16, 2, "stacked"), (10, 1, "callable"), (25, 2, "callable"),
    (50, 1, "stacked")])
@pytest.mark.parametrize("algo,local", [("rosdhb", False), ("rosdhb", True),
                                        ("dasha", False),
                                        ("robust_dgd", False)])
def test_streaming_is_bitwise_rollout(algo, local, chunk, depth, source):
    """Parameters, the server banks and every per-round metric equal
    ``rollout``'s on the same schedule and draws, with and without a tail,
    from a stacked tree and through the prefetch thread."""
    sim, batch_fn = _port_sim(_cfgs(algo, local)[1])
    stacked = Sim.stack_batches(batch_fn, STEPS)
    want, wm = sim.rollout(sim.init(3), stacked)
    feed = stacked if source == "stacked" else batch_fn
    got, gm, info = sim.rollout_streaming(sim.init(3), feed, STEPS,
                                          chunk_size=chunk,
                                          prefetch_depth=depth)
    assert info["rounds_run"] == STEPS and not info["early_exit"]
    assert info["dispatches"] == -(-(STEPS // chunk) // depth)
    assert info["chunk_bytes"] == chunk * N * D * 4
    assert info["device_buffer_bytes"] == depth * info["chunk_bytes"]
    assert info["host_high_water_bytes"] <= (depth + 1) * info["chunk_bytes"]
    assert torch.equal(got.params_flat, want.params_flat)
    for a, b in zip(got.server, want.server):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    assert set(gm) == set(wm)
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    assert info["last_metric"] == float(wm["loss"][(STEPS // chunk) * chunk
                                                   - 1])


def test_streaming_rejects_what_it_cannot_run():
    sim, batch_fn = _port_sim(_cfgs()[1])
    with pytest.raises(ValueError, match="tau_mode"):
        sim.rollout_streaming(sim.init(0), batch_fn, 4, chunk_size=2,
                              tau=1.0, tau_mode="<")
    with pytest.raises(ValueError, match="positive"):
        sim.rollout_streaming(sim.init(0), batch_fn, 4, chunk_size=0)
    with pytest.raises(ValueError, match="steps"):
        sim.rollout_streaming(sim.init(0), batch_fn, chunk_size=2)
    with pytest.raises(ValueError, match="single run"):
        sim.rollout_streaming(sim.init_lanes([0, 1]), batch_fn, 4,
                              chunk_size=2, tau=1.0)


# ----------------------------------------------------------------------- #
# against the reference's rollout_streaming
# ----------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def quad():
    """Both packages' quadratic testbed (the reference's targets) and the
    reference's fixed-length fig1-alie run over STEPS rounds."""
    jloss, jp0, jbatch, tg = JS.quadratic_testbed(N, D)
    loss, p0, batch, _ = S.quadratic_testbed(N, d=D, targets=np.asarray(tg),
                                             device="cpu")
    ref, port = _cfgs()
    jsim = JSim.Simulator(loss_fn=jloss, params0=jp0, cfg=ref)
    stacked = JSim.stack_batches(jbatch, STEPS)
    _, jm = jsim.rollout(jsim.init(0), stacked)
    return {"jsim": jsim, "stacked": stacked, "ref": ref, "port": port,
            "loss": loss, "p0": p0, "tg": np.asarray(tg),
            "jloss": np.asarray(jm["loss"])}


def _port(quad, eval_fn=None):
    return Sim.Simulator(quad["loss"], quad["p0"], quad["port"],
                         eval_fn=eval_fn, device="cpu")


@pytest.mark.parametrize("chunk,depth", [(16, 2), (10, 4)])
def test_trajectory_matches_the_references_stream(quad, chunk, depth):
    jst, jm, jinfo = quad["jsim"].rollout_streaming(
        quad["jsim"].init(0), quad["stacked"], chunk_size=chunk,
        prefetch_depth=depth)
    sim = _port(quad)
    st, m, info = sim.rollout_streaming(
        sim.init(draws=_ref_draws(quad["ref"], 0, STEPS)), quad["stacked"],
        chunk_size=chunk, prefetch_depth=depth)
    assert _ulps(st.params_flat.numpy(), jst.params_flat) <= 8
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), jm[k], rtol=1e-5,
                                   err_msg=k)
    for k in ("rounds_run", "early_exit", "tau", "tau_metric", "tau_mode",
              "dispatches", "chunk_size", "prefetch_depth", "chunk_bytes",
              "device_buffer_bytes"):
        assert info[k] == jinfo[k], k
    assert set(info) == set(jinfo)


def test_early_exit_matches_the_reference(quad):
    """A loss threshold halfway between the losses at two chunk
    boundaries (rounds 24 and 32): both runs stop at round 32 with the
    reference's info, and the metrics are the fixed run's prefix."""
    chunk, loss = 8, quad["jloss"]
    tau = float(0.5 * (loss[23] + loss[31]))
    _, jm, jinfo = quad["jsim"].rollout_streaming(
        quad["jsim"].init(0), quad["stacked"], chunk_size=chunk,
        prefetch_depth=2, tau=tau, tau_metric="loss", tau_mode="<=")
    sim = _port(quad)
    st, m, info = sim.rollout_streaming(
        sim.init(draws=_ref_draws(quad["ref"], 0, STEPS)), quad["stacked"],
        chunk_size=chunk, prefetch_depth=2, tau=tau, tau_metric="loss",
        tau_mode="<=")
    assert info["early_exit"] and jinfo["early_exit"]
    assert info["rounds_run"] == jinfo["rounds_run"] == 32
    assert info["tau_mode"] == jinfo["tau_mode"] == "<="
    assert info["dispatches"] == jinfo["dispatches"]
    np.testing.assert_allclose(m["loss"].numpy(), loss[:32], rtol=1e-5)
    np.testing.assert_allclose(info["last_metric"], jinfo["last_metric"],
                               rtol=1e-5)
    assert int(st.server.step) == 32


def test_tau_never_crossed_runs_full_length(quad):
    sim = _port(quad)
    _, m, info = sim.rollout_streaming(
        sim.init(draws=_ref_draws(quad["ref"], 0, STEPS)), quad["stacked"],
        chunk_size=16, prefetch_depth=2, tau=-1.0)
    _, _, jinfo = quad["jsim"].rollout_streaming(
        quad["jsim"].init(0), quad["stacked"], chunk_size=16,
        prefetch_depth=2, tau=-1.0)
    assert not info["early_exit"] and not jinfo["early_exit"]
    assert info["rounds_run"] == jinfo["rounds_run"] == STEPS
    assert m["loss"].shape == (STEPS,)


def test_eval_metric_path_crosses_upward_as_the_reference(quad):
    """tau on ``eval_fn``'s metric defaults to ``'>='``; a threshold
    halfway between the eval gaps after rounds 20 and 30 stops both at
    round 30."""
    opt = quad["tg"][F:].mean(axis=0)
    jeval = lambda p, b: {"gap": -jnp.linalg.norm(p["w"] - b)}  # noqa
    teval = lambda p, b: {"gap": -torch.linalg.vector_norm(  # noqa: E731
        p["w"] - b)}
    jsim = JSim.Simulator(loss_fn=quad["jsim"].loss_fn,
                          params0=quad["jsim"].params0, cfg=quad["ref"],
                          eval_fn=jeval)
    _, _, snaps = jsim.rollout_with_snapshots(jsim.init(0), quad["stacked"],
                                              [19, 29])
    gaps = [-float(np.linalg.norm(np.asarray(s)[:D] - opt)) for s in snaps]
    tau = 0.5 * (gaps[0] + gaps[1])
    _, _, jinfo = jsim.rollout_streaming(
        jsim.init(0), quad["stacked"], chunk_size=10, prefetch_depth=2,
        tau=tau, tau_metric="gap", eval_batch=jnp.asarray(opt))
    sim = _port(quad, eval_fn=teval)
    _, _, info = sim.rollout_streaming(
        sim.init(draws=_ref_draws(quad["ref"], 0, STEPS)), quad["stacked"],
        chunk_size=10, prefetch_depth=2, tau=tau, tau_metric="gap",
        eval_batch=torch.tensor(opt))
    assert info["tau_mode"] == jinfo["tau_mode"] == ">="
    assert info["early_exit"] and jinfo["early_exit"]
    assert info["rounds_run"] == jinfo["rounds_run"] == 30
    assert info["last_metric"] >= tau
    np.testing.assert_allclose(info["last_metric"], jinfo["last_metric"],
                               rtol=1e-5)


def test_snapshots_match_the_reference(quad):
    rounds = [0, 7, 31, STEPS - 1]
    jst, jm, jsnaps = quad["jsim"].rollout_with_snapshots(
        quad["jsim"].init(0), quad["stacked"], rounds)
    sim = _port(quad)
    st, m, snaps = sim.rollout_with_snapshots(
        sim.init(draws=_ref_draws(quad["ref"], 0, STEPS)), quad["stacked"],
        rounds)
    assert snaps.shape == jsnaps.shape == (len(rounds), D)
    assert _ulps(snaps.numpy(), jsnaps) <= 8
    assert torch.equal(snaps[-1], st.params_flat)
    np.testing.assert_allclose(m["loss"].numpy(), jm["loss"], rtol=1e-5)
    for bad in ([3, 3], [5, 2], [-1], [STEPS]):
        with pytest.raises(ValueError, match="strictly increasing"):
            sim.rollout_with_snapshots(sim.init(0), quad["stacked"], bad)


def test_run_per_round_matches_the_reference(quad):
    """Eval records every 5 rounds and the last; the run stops at the
    first record whose loss is below the fixed run's loss at round 27
    (rounded up: a clear margin)."""
    opt = quad["tg"][F:].mean(axis=0)
    jeval = lambda p, b: {"err": jnp.linalg.norm(p["w"] - b)}  # noqa
    teval = lambda p, b: {"err": torch.linalg.vector_norm(  # noqa: E731
        p["w"] - b)}
    thr = float(quad["jloss"][27]) * (1 + 1e-3)
    stop = lambda rec: rec["loss"] <= thr  # noqa: E731
    jsim = JSim.Simulator(loss_fn=quad["jsim"].loss_fn,
                          params0=quad["jsim"].params0, cfg=quad["ref"],
                          eval_fn=jeval)
    jbatch = lambda t: {"target": quad["stacked"]["target"][t]}  # noqa
    jst, jh = jsim.run_per_round(jsim.init(0), jbatch, STEPS, eval_every=5,
                                 eval_batch=jnp.asarray(opt), stop_fn=stop)
    sim = _port(quad, eval_fn=teval)
    st, h = sim.run_per_round(sim.init(draws=_ref_draws(quad["ref"], 0,
                                                        STEPS)),
                              jbatch, STEPS, eval_every=5,
                              eval_batch=torch.tensor(opt), stop_fn=stop)
    assert h["step"] == jh["step"] and h["step"][-1] < STEPS - 1
    assert h["comm_bytes"] == jh["comm_bytes"]
    assert set(h) == set(jh)
    for k in ("loss", "err", "grad_norm"):
        np.testing.assert_allclose(h[k], jh[k], rtol=1e-5, err_msg=k)
    assert _ulps(st.params_flat.numpy(), jst.params_flat) <= 8


# ----------------------------------------------------------------------- #
# the streamed grid and execute_plan: bitwise the materialised ones
# ----------------------------------------------------------------------- #


def _grid():
    cells = S.grid_scenarios(["rosdhb", "dasha"], ["alie", "foe", "none"],
                             ["cwtm"], n_honest=10, f=3, ratio=0.2)
    loss, p0, _, tg = S.quadratic_testbed(N, d=D, device="cpu")
    return cells, loss, p0, _noisy_batches(tg.numpy())


def test_streamed_grid_is_bitwise_the_materialised_grid():
    cells, loss, p0, batch_fn = _grid()
    (bank,) = S.plan_grid(cells).banks
    sim = Sim.Simulator(loss, p0, bank.cfg, device="cpu")
    want, wm = S.fused_grid_rollout(sim, bank.scenario_params(), (0, 1),
                                    batch_fn, 11)
    got, gm = S.fused_grid_rollout_streaming(
        sim, bank.scenario_params(), (0, 1), batch_fn, 11, chunk_size=4,
        prefetch_depth=2)
    assert got.params_flat.shape == (bank.n_cells, 2, D)
    assert torch.equal(got.params_flat, want.params_flat)
    assert torch.equal(got.server.momentum, want.server.momentum)
    for k in wm:
        assert gm[k].shape == (bank.n_cells, 2, 11)
        assert torch.equal(gm[k], wm[k]), k
    single = Sim.Simulator(loss, p0, cells[0].cfg, device="cpu")
    want, wm = S.rollout_over_seeds(single, (0, 1, 2), batch_fn, 9)
    got, gm = S.rollout_over_seeds_streaming(single, (0, 1, 2), batch_fn, 9,
                                             chunk_size=3, prefetch_depth=1)
    assert torch.equal(got.params_flat, want.params_flat)
    assert torch.equal(gm["loss"], wm["loss"])


def test_streamed_execute_plan_gives_the_same_rows():
    cells, loss, p0, batch_fn = _grid()
    plan = S.plan_grid(cells)
    assert plan.banks and plan.singles
    kw = dict(loss_fn=loss, params0=p0, batches=batch_fn, seeds=(0, 1),
              steps=10, device="cpu")
    want = S.execute_plan(plan, **kw)
    got = S.execute_plan(plan, streaming=True, stream_chunk_size=4,
                         prefetch_depth=2, **kw)
    assert got == want
    rows = S.run_scenarios(cells, streaming=True, stream_chunk_size=3, **kw)
    assert [r["scenario"] for r in rows] == [
        sc.label for sc in cells for _ in (0, 1)]
    assert rows == [r for sc in cells for r in want[sc.label]]


# ----------------------------------------------------------------------- #
# stack_batches' host limit
# ----------------------------------------------------------------------- #


def test_stack_batches_raises_over_its_limit():
    big = lambda t: {"x": np.zeros((1024, 1024), np.float32)}  # noqa
    with pytest.raises(ValueError, match="rollout_streaming"):
        Sim.stack_batches(big, steps=100, max_bytes=16 * 1024 ** 2)
    assert Sim.stack_batches(big, steps=2, max_bytes=16 * 1024 ** 2)[
        "x"].shape == (2, 1024, 1024)


def test_stack_batches_env_override(monkeypatch):
    """``REPRO_STACK_BYTES_LIMIT`` sets the limit (``0`` disables it), as
    in the reference (``tests/test_stream.py``)."""
    big = lambda t: {"x": np.zeros((1024,), np.float32)}  # noqa: E731
    monkeypatch.setenv("REPRO_STACK_BYTES_LIMIT", "1024")
    with pytest.raises(ValueError, match="REPRO_STACK_BYTES_LIMIT"):
        Sim.stack_batches(big, steps=10)
    with pytest.raises(ValueError, match="REPRO_STACK_BYTES_LIMIT"):
        JSim.stack_batches(big, steps=10)
    monkeypatch.setenv("REPRO_STACK_BYTES_LIMIT", "0")
    assert Sim.stack_batches(big, steps=10)["x"].shape == (10, 1024)
