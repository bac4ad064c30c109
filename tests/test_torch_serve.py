"""The port's streaming parameter server (``repro_torch.serve``) against the
port's simulator and against the reference's server (``repro.serve``), on
the quadratic testbed at d = 64.

Bars: a served trajectory at full participation is bitwise the port's
``Simulator.rollout`` on the same per-round draws (parameters and momentum
bank). Against the reference's server with its own draws replayed: within 8
ulp of max |w|, the simulator parity bar (the compiled reference fuses
ALIE's statistics and sums the aggregation in another order); 1.5 ulp
measured at full participation, 2 ulp under drops and staleness, where both
servers are driven lock-step (``run_lockstep``) so that they aggregate the
same rows every round."""

import glob
import json
import os
import time

import jax
import numpy as np
import pytest
import torch

from repro.core import algorithms as JAlg
from repro.core.sweep import grid_scenarios as j_grid_scenarios
from repro.core.sweep import quadratic_testbed as j_quadratic
from repro.serve import ByzantineRobustServer as JServer
from repro.serve import ClientBehavior as JBehavior
from repro.serve import ClientPool as JPool
from repro.serve import RoundBuffer as JBuffer
from repro.serve import ServeConfig as JServeConfig
from repro.serve import run_service as j_run_service
from repro.serve.metrics import ServeMetrics as JMetrics
from repro.serve.metrics import percentile as j_percentile
from repro.serve.protocol import ClientUpdate as JUpdate
from repro_torch.core import Simulator
from repro_torch.core import algorithms as Alg
from repro_torch.core import wire as W
from repro_torch.core.sweep import grid_scenarios, quadratic_testbed
from repro_torch.serve import (
    ByzantineRobustServer, ClientBehavior, ClientPool, RoundBuffer,
    ServeConfig, ServeTimeout, mask_id, run_lockstep, run_service,
)
from repro_torch.serve import __main__ as cli
from repro_torch.serve import server as server_mod
from repro_torch.serve.metrics import ServeMetrics, percentile
from repro_torch.serve.protocol import ClientUpdate
from repro_torch.testing import RecordingDraws, ReplayDraws, SeedWordDraws

D = 64
ROUNDS = 8


def _cfg(algo="rosdhb", attack="alie", **kw):
    return grid_scenarios((algo,), (attack,), ("cwtm",), n_honest=10, f=3,
                          **kw)[0].cfg


def _jcfg(algo="rosdhb", attack="alie"):
    return j_grid_scenarios((algo,), (attack,), ("cwtm",), n_honest=10,
                            f=3)[0].cfg


@pytest.fixture(scope="module")
def targets():
    return np.asarray(j_quadratic(13, d=D)[3])


def _testbed(targets):
    return quadratic_testbed(13, d=D, targets=targets, device="cpu")


def _served(cfg, targets, rounds=ROUNDS, serve=None, behavior=None,
            draws_for=None, run=run_service, seed=0):
    loss_fn, params0, batch_fn, _ = _testbed(targets)
    server = ByzantineRobustServer(cfg, params0, serve or ServeConfig(),
                                   seed=seed, device="cpu")
    pool = ClientPool(loss_fn, params0, cfg, batch_fn, behavior=behavior,
                      device="cpu", draws_for=draws_for)
    results = run(server, pool, rounds)
    return server, pool, results


class _Recorder:
    """The pool's per-round draws from the announcements' seed words, kept
    to replay into ``Simulator.rollout``."""

    def __init__(self):
        self.rounds = []

    def __call__(self, ann):
        rec = RecordingDraws(SeedWordDraws(ann.mask_key, ann.atk_key, "cpu"))
        self.rounds.append(rec)
        return rec

    def replay(self):
        return ReplayDraws(
            "cpu", permutations=[p for r in self.rounds
                                 for p in r.permutations],
            uniforms=[u for r in self.rounds for u in r.uniforms],
            normals=[z for r in self.rounds for z in r.normals])


# ----------------------------------------------------------------------- #
# served trajectory == the port's simulator, bitwise
# ----------------------------------------------------------------------- #


@pytest.mark.parametrize("algo,attack,cdt", [
    ("rosdhb", "alie", "float32"), ("robust_dgd", "alie", "float32"),
    ("dgd", "signflip", "float32"), ("rosdhb", "mimic", "float32"),
    ("rosdhb", "alie", "bfloat16")])
def test_served_trajectory_is_the_simulators(targets, algo, attack, cdt):
    """Full participation, zero timeout: the served parameters and
    momentum bank are bitwise ``Simulator.rollout``'s on the same draws (a
    stateful adversary's memory carried pool-side; bfloat16 server
    arithmetic too)."""
    import dataclasses
    cfg = dataclasses.replace(_cfg(algo, attack), server_compute_dtype=cdt)
    rec = _Recorder()
    server, pool, results = _served(cfg, targets, draws_for=rec)
    loss_fn, params0, batch_fn, _ = _testbed(targets)
    sim = Simulator(loss_fn, params0, cfg, device="cpu")
    draws = rec.replay()
    st, _ = sim.rollout(sim.init(draws=draws), batch_fn, ROUNDS)
    assert draws.remaining == 0
    assert torch.equal(server.params_flat, st.params_flat)
    assert torch.equal(server.server_state.momentum, st.server.momentum) \
        or algo != "rosdhb"
    assert server.server_state.step == ROUNDS
    assert server.step_traces == 1
    assert all(r.fired_by == "quorum" and r.n_updates == 13
               for r in results)
    assert (pool.attack_state is not None) == (attack == "mimic")
    if attack == "mimic":
        assert torch.equal(pool.attack_state.vec, st.server.attack.vec)


# ----------------------------------------------------------------------- #
# against the reference's server, its draws replayed
# ----------------------------------------------------------------------- #


def _reference_run(targets, behavior=None, serve=None, lockstep=False):
    """The reference's server and pool; returns its final parameters, its
    round results and each announcement's mask key."""
    jcfg = _jcfg()
    loss_fn, params0, batch_fn, _ = j_quadratic(13, d=D)
    server = JServer(jcfg, params0, JServeConfig(**(serve or {})), seed=0)
    pool = JPool(loss_fn, params0, jcfg, batch_fn,
                 behavior=JBehavior(**behavior) if behavior else None)
    keys = []
    round_payloads = pool.round_payloads

    def recording(ann):
        keys.append(np.asarray(ann.mask_key))
        return round_payloads(ann)

    pool.round_payloads = recording
    run = run_lockstep if lockstep else j_run_service
    results = run(server, pool, ROUNDS)
    k = jcfg.sparsifier.k(D)
    perms = [np.asarray(jax.random.permutation(jax.numpy.asarray(mk), D)[:k])
             for mk in keys]
    return np.asarray(server.params_flat), results, perms


@pytest.fixture(scope="module")
def reference_runs(targets):
    beh = dict(drop_prob=0.2, late_prob=0.2, late_rounds=1, seed=1)
    return {
        "full": (_reference_run(targets), None, None),
        "drops": (_reference_run(targets, behavior=beh,
                                 serve=dict(staleness_window=2),
                                 lockstep=True), beh,
                  dict(staleness_window=2)),
    }


@pytest.mark.parametrize("case", ["full", "drops"])
def test_matches_the_reference_server(targets, reference_runs, case):
    (want, jresults, perms), beh, serve = reference_runs[case]
    server, _, results = _served(
        _cfg(), targets, serve=ServeConfig(**(serve or {})),
        behavior=ClientBehavior(**beh) if beh else None,
        draws_for=lambda ann: ReplayDraws(
            "cpu", permutations=[perms[ann.round_id]]),
        run=run_lockstep if case == "drops" else run_service)
    assert [(r.client_ids, r.staleness) for r in results] == \
        [(r.client_ids, r.staleness) for r in jresults]
    if case == "drops":
        assert len({r.n_updates for r in results}) > 1
        assert any(max(r.staleness) > 0 for r in results)
    got = server.params_flat.numpy()
    ulp = np.spacing(np.float32(np.abs(want).max()))
    assert np.abs(got - want).max() <= 8 * ulp


def test_host_discount_is_the_references_float32_power():
    """beta^k in numpy float32 (the batcher's discount) underflows to
    exactly 0.0 at large k, as the reference's does."""
    beta = np.float32(_cfg().resolved_beta())
    with np.errstate(under="ignore"):
        assert beta ** 5000 == np.float32(0.0)
        assert np.isfinite(beta ** 400)
    server = ByzantineRobustServer(_cfg(), {"w": torch.zeros(D)},
                                   device="cpu")
    assert server._beta.dtype == np.float32 and server._beta == beta


def test_discount_and_absent_rows_in_the_apply_half():
    """Absent rows keep their momentum bitwise; a late row enters as
    discount * wire; all present with discount 1 is the simulator's
    apply."""
    cfg = _cfg()
    rng = np.random.default_rng(0)
    m0 = torch.tensor(rng.normal(size=(13, D)).astype(np.float32))
    wire = torch.tensor(rng.normal(size=(13, D)).astype(np.float32))
    agg = lambda x: x.mean(0)  # noqa: E731
    st = Alg.init_state(cfg, D, device="cpu")._replace(momentum=m0)
    apply_fn = Alg.make_serve_apply_fn(cfg, agg)
    present = torch.ones(13, dtype=torch.bool)
    r, new = apply_fn(st, wire, present, torch.ones(13))
    r0, new0 = Alg._rosdhb_apply(cfg, agg, st, wire, Alg.static_hparams(cfg))
    assert torch.equal(r, r0) and torch.equal(new.momentum, new0.momentum)
    present[4] = False
    disc = torch.ones(13)
    disc[7] = 0.81
    _, new = apply_fn(st, wire, present, disc)
    assert torch.equal(new.momentum[4], m0[4])
    want = (0.1 * (wire[7] * 0.81)).add_(m0[7], alpha=0.9)
    assert torch.equal(new.momentum[7], want)


# ----------------------------------------------------------------------- #
# configuration and edge cases
# ----------------------------------------------------------------------- #


def test_dasha_rejected_loudly():
    cfg = _cfg("dasha")
    with pytest.raises(ValueError, match="stale"):
        ByzantineRobustServer(cfg, {"w": torch.zeros(D)}, device="cpu")
    with pytest.raises(ValueError, match="streaming"):
        Alg.make_wire_fn(cfg)
    with pytest.raises(ValueError, match="streaming"):
        Alg.make_serve_apply_fn(cfg, None)
    assert Alg.SERVE_ALGORITHMS == JAlg.SERVE_ALGORITHMS


def test_quorum_below_2f_plus_1_raises():
    with pytest.raises(ValueError, match="2f\\+1"):
        ByzantineRobustServer(_cfg(), {"w": torch.zeros(D)},
                              ServeConfig(quorum=6), device="cpu")
    with pytest.raises(ValueError, match="2f\\+1"):
        RoundBuffer(n_clients=13, f=3, quorum=6)


def _buffer_script(Buffer, Update):
    """The reference's buffer rules, run on either package's buffer:
    staleness window, duplicates, replacement, future updates, bad client
    and bad mask, the window's inclusive boundary and quorum-only
    firing."""
    out = []
    buf = Buffer(n_clients=13, f=3, quorum=13, timeout_s=0.0,
                 staleness_window=1, stale_policy="discount")
    mk = lambda cid, rid, m=None: Update(  # noqa: E731
        client_id=cid, round_id=rid, mask_id=rid if m is None else m,
        values=np.zeros(4), payload_bytes=1)
    buf.open(2, now=0.0, mask_id=2)
    buf._mask_ids.update({0: 0, 1: 1, 3: 3})
    for u in (mk(0, 2), mk(1, 1), mk(2, 0), mk(0, 2), mk(1, 2), mk(3, 3),
              mk(99, 2), mk(4, 2, 777)):
        out.append(buf.add(u, 0.0))
    out.append(buf.count)
    out.append([(u.client_id, s) for u, s in buf.open(3, now=1.0,
                                                      mask_id=3)])
    out.append(buf.ready(now=1e9))
    edge = Buffer(n_clients=13, f=3, quorum=13, staleness_window=3)
    edge.open(5, now=0.0, mask_id=5)
    edge._mask_ids.update({r: r for r in range(8)})
    out += [edge.add(mk(1, 2), 0.0), edge.rows()[1].staleness,
            edge.add(mk(2, 1), 0.0)]
    drop = Buffer(n_clients=13, f=3, quorum=7, timeout_s=0.1,
                  staleness_window=2, stale_policy="drop")
    drop.open(3, now=0.0, mask_id=3)
    drop._mask_ids.update({2: 2})
    out += [drop.add(mk(5, 2), 0.0), drop.ready(0.05)]
    drop.add(mk(6, 3), 0.0)
    out += [drop.ready(0.05), drop.ready(0.2), drop.fired_by()]
    drop.set_quorum(7)
    with pytest.raises(ValueError, match="floor"):
        drop.set_quorum(6)
    return out


def test_buffer_rules_are_the_references():
    got = _buffer_script(RoundBuffer, ClientUpdate)
    assert got == _buffer_script(JBuffer, JUpdate)
    assert got[:9] == ["accepted", "accepted", "stale_dropped", "duplicate",
                       "replaced", "future", "bad_client", "bad_mask", 2]


def test_timeout_fires_partial_round(targets):
    """Quorum unreachable (2 clients always too late) + a wall-clock
    timeout: rounds fire by timeout with the updates that arrived, and one
    step serves every participation level."""
    beh = ClientBehavior(stragglers=(11, 12), straggle_rounds=5)
    server, _, results = _served(_cfg(), targets, rounds=4,
                                 serve=ServeConfig(timeout_s=0.03),
                                 behavior=beh)
    assert all(r.fired_by == "timeout" and r.n_updates == 11
               for r in results)
    assert server.step_traces == 1


def _ingest_together(server, updates):
    """Add ``updates`` to the open round's buffer in one critical section,
    each as the server's ingest thread adds it (``RoundBuffer.add``, its
    decision observed): the batcher sees all of them or none."""
    with server._cond:
        for u in updates:
            status = server._buffer.add(u, time.perf_counter())
            server.metrics.observe_decision(
                status, round_id=server._buffer.round_id)
        server._cond.notify_all()


def _run_holding_the_late(server, pool, rounds, round_timeout=60.0):
    """``run_service``'s announce -> submit -> apply cycle with the clock
    taken out of who is in a round: each round's on-time updates enter the
    buffer together (:func:`_ingest_together`), so the wall-clock timeout
    cannot fire the round between two of them however slow the host, and
    the late ones are held until the round they are due in has fired,
    then enter the next round's buffer, where they are stale whatever the
    clock."""
    server.start()
    held, results = [], []
    try:
        for _ in range(rounds):
            ann = server.announce(timeout=round_timeout)
            t = ann.round_id
            now = []
            for sched in pool.round_payloads(ann):
                if not sched.drop:
                    (now if sched.deliver_round <= t else held).append(sched)
            _ingest_together(server, [sc.update for sc in now])
            results.append(server.wait_round(t, timeout=round_timeout))
            _ingest_together(server, [sc.update for sc in held
                                      if sc.deliver_round <= t])
            held = [sc for sc in held if sc.deliver_round > t]
    finally:
        server.stop()
    return results


def test_byzantine_all_late_drop_policy(targets):
    """All f byzantine clients always late (2 rounds) + stale_policy='drop'
    and the 0.05 s timeout: every round aggregates exactly the 10 honest
    clients, and the late rows are dropped as stale. The rounds' rows are
    the pool's fates alone (:func:`_run_holding_the_late`): under
    ``run_service`` a host slower than the timeout between two honest
    submissions fires a round short of them."""
    serve = ServeConfig(quorum=10, timeout_s=0.05, stale_policy="drop")
    beh = ClientBehavior(stragglers=(0, 1, 2), straggle_rounds=2)
    server, _, results = _served(_cfg(), targets, rounds=4, serve=serve,
                                 behavior=beh, run=_run_holding_the_late)
    assert all(r.n_updates == 10 and min(r.client_ids) >= 3
               for r in results)
    assert server.metrics.summary()["ingest_decisions"].get(
        "stale_dropped", 0) > 0


def test_one_step_across_participation_levels(targets):
    cfg = _cfg()
    loss_fn, params0, batch_fn, _ = _testbed(targets)
    server = ByzantineRobustServer(
        cfg, params0, ServeConfig(quorum=10, timeout_s=0.05,
                                  staleness_window=2), device="cpu")
    for beh in (None, ClientBehavior(drop_prob=0.3, seed=1),
                ClientBehavior(late_prob=0.4, seed=2)):
        pool = ClientPool(loss_fn, params0, cfg, batch_fn, behavior=beh,
                          device="cpu")
        run_service(server, pool, 4, stop=False)
    server.stop()
    assert server.step_traces == 1
    assert len({r.n_updates for r in server.metrics.rounds}) > 1
    s = server.metrics.summary()
    assert sum(s["quorum_histogram"].values()) == s["rounds"] == 12
    for status, hist in s["decision_round_histograms"].items():
        assert sum(int(k) * v for k, v in hist.items()) == \
            s["ingest_decisions"][status]


def test_checkpoint_kill_and_resume_identical(targets, tmp_path):
    """Stop after 6 rounds (checkpoint_every=3), restore into a fresh
    server of another seed, run 6 more: bitwise the uninterrupted run."""
    cfg = _cfg()
    straight, _, _ = _served(cfg, targets, rounds=12)
    serve = ServeConfig(checkpoint_every=3, checkpoint_dir=str(tmp_path))
    a, _, _ = _served(cfg, targets, rounds=6, serve=serve)
    ckpt = sorted(glob.glob(os.path.join(str(tmp_path), "*.npz")))[-1]
    loss_fn, params0, batch_fn, _ = _testbed(targets)
    b = ByzantineRobustServer(cfg, params0, serve, seed=1234, device="cpu")
    assert b.restore(ckpt.replace(".npz", "")) == 6
    run_service(b, ClientPool(loss_fn, params0, cfg, batch_fn,
                              device="cpu"), 6)
    assert torch.equal(straight.params_flat, b.params_flat)
    assert torch.equal(straight.server_state.momentum,
                       b.server_state.momentum)
    s2 = ByzantineRobustServer(cfg, params0, serve, device="cpu").start()
    with pytest.raises(RuntimeError, match="before start"):
        s2.restore(ckpt.replace(".npz", ""))
    s2.stop()


def test_wait_round_raises_a_typed_timeout():
    server = ByzantineRobustServer(_cfg(), {"w": torch.zeros(D)},
                                   device="cpu").start()
    try:
        with pytest.raises(ServeTimeout, match="quorum") as ei:
            server.wait_round(0, timeout=0.15)
        e = ei.value
        assert isinstance(e, TimeoutError) and e.reason == "deadline"
        assert (e.round_id, e.quorum, e.base_quorum, e.buffer_count) == \
            (0, 13, 13, 0)
        with pytest.raises(ServeTimeout) as ei2:
            server.announce(timeout=0.1, min_round=99)
        assert ei2.value.reason == "deadline"
    finally:
        server.stop()
    bad = ClientUpdate(client_id=0, round_id=0, mask_id=0,
                       values=np.zeros(3), payload_bytes=1)
    with pytest.raises(ValueError, match="shape"):
        server.submit(bad)


def test_payload_accounting_matches_the_simulator(targets):
    cfg = _cfg()
    server, _, _ = _served(cfg, targets, rounds=3)
    loss_fn, params0, _, _ = _testbed(targets)
    sim = Simulator(loss_fn, params0, cfg, device="cpu")
    assert server.metrics.summary()["uplink_bytes"] == \
        sim.payload_bytes_per_round() * 3
    for algo in Alg.ALGO_BANK:
        c = _cfg(algo, ratio=0.25)
        assert Alg.algo_payload_bytes(c, D) == W.per_worker_payload_bytes(
            algo, D, c.sparsifier)


def test_metrics_summary_has_the_references_keys(targets):
    server, _, _ = _served(_cfg(), targets, rounds=2)
    s = server.metrics.summary()
    assert set(s) == set(JMetrics().summary())
    assert s["rounds"] == 2 and s["updates_accepted"] == 26
    assert s["latency_p99_ms"] >= s["latency_p50_ms"] > 0
    xs = list(np.random.default_rng(0).uniform(size=37))
    for q in (0, 1, 50, 99, 100):
        assert percentile(xs, q) == j_percentile(xs, q)


def test_seed_chain_and_mask_id():
    """The chain splits deterministically into new words; the mask id
    folds two words as the reference folds a key."""
    a, b = server_mod.split_words(server_mod.seed_words(7))
    a2, b2 = server_mod.split_words(server_mod.seed_words(7))
    assert a.dtype == np.uint32 and (a == a2).all() and (b == b2).all()
    assert not (a == b).all()
    from repro.serve.protocol import mask_id as j_mask_id
    words = np.array([3, 0xFFFFFFFF], np.uint32)
    assert mask_id(words) == j_mask_id(words) == (3 << 32) | 0xFFFFFFFF
    k = np.asarray(jax.random.PRNGKey(7))
    assert mask_id(k) == j_mask_id(k)
    assert (server_mod.seed_words(7) == k).all()


# ----------------------------------------------------------------------- #
# the CLI
# ----------------------------------------------------------------------- #


def test_cli_serves_on_the_cpu_with_the_references_keys(capsys, tmp_path):
    out = tmp_path / "s.json"
    summary = cli.main(["--scenario", "fig1-alie", "--rounds", "3",
                        "--device", "cpu", "--out", str(out)])
    assert summary["rounds"] == 3 and summary["step_traces"] == 1
    assert np.isfinite(summary["final_honest_loss"])
    assert set(summary) == set(JMetrics().summary()) | {
        "scenario", "step_traces", "final_honest_loss"}
    assert json.loads(out.read_text())["scenario"] == \
        "fig1-alie/rosdhb/alie/cwtm"
    capsys.readouterr()
    cli.main(["--scenario", "table1-mini", "--list-cells"])
    assert "[not serveable]" in capsys.readouterr().out


def test_cli_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--rounds", "1", "--chaos", "fault-free"])
