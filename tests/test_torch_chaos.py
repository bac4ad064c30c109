"""The port's chaos harness (``repro_torch.serve.chaos``) and the server's
fault domain: the reference's scenario registry name for name, scenarios
serving through injected faults, quorum degradation and recovery, the
liveness watchdog, and mid-round crash recovery resuming bitwise."""

import dataclasses
import glob
import os
import time

import numpy as np
import pytest
import torch

from repro.serve.chaos import CHAOS_REGISTRY as J_CHAOS
from repro.serve.chaos import describe_chaos as j_describe_chaos
from repro_torch.core.sweep import grid_scenarios, quadratic_testbed
from repro_torch.serve import (
    CHAOS_REGISTRY, ByzantineRobustServer, ChaosScenario, ClientPool,
    FaultSpec, RetryPolicy, RoundBuffer, ServeConfig, ServeTimeout,
    get_chaos, run_chaos, run_service,
)
from repro_torch.serve import __main__ as cli
from repro_torch.serve.chaos import describe_chaos

D = 24
ROUNDS = 8


def _cfg():
    return grid_scenarios(("rosdhb",), ("alie",), ("cwtm",), n_honest=10,
                          f=3)[0].cfg


def _testbed():
    return quadratic_testbed(13, d=D, device="cpu")


def _chaos(sc, rounds=ROUNDS, **kw):
    loss_fn, params0, batch_fn, _ = _testbed()
    return run_chaos(_cfg(), params0, batch_fn, loss_fn, sc, rounds, seed=0,
                     device="cpu", **kw)


def test_registry_is_the_references_name_for_name():
    assert list(CHAOS_REGISTRY) == list(J_CHAOS)
    for name, sc in CHAOS_REGISTRY.items():
        assert dataclasses.asdict(sc) == dataclasses.asdict(J_CHAOS[name])
    assert describe_chaos() == j_describe_chaos()
    with pytest.raises(ValueError, match="unknown chaos scenario"):
        get_chaos("volcano")


@pytest.mark.parametrize("name", ["drop-storm", "dup-flood",
                                  "corrupt-burst", "reset-storm"])
def test_scenarios_serve_through_faults(name):
    res = _chaos(get_chaos(name))
    assert res.all_rounds_terminated()
    assert res.step_traces == [1]
    assert sum(res.injected.values()) > 0
    assert np.isfinite(res.final_params).all()


@pytest.fixture(scope="module")
def fault_free():
    return _chaos(get_chaos("fault-free"), rounds=12)


def test_kill_restart_resumes_bitwise(fault_free):
    kr = _chaos(get_chaos("kill-restart"), rounds=12)
    assert kr.restarts == 1 and kr.step_traces == [1, 1]
    np.testing.assert_array_equal(kr.final_params, fault_free.final_params)


def test_combined_over_tcp_terminates_and_converges(fault_free):
    sc = dataclasses.replace(get_chaos("combined"), transport="tcp")
    cb = _chaos(sc, rounds=12)
    assert cb.all_rounds_terminated() and cb.restarts == 1
    assert cb.step_traces == [1, 1]
    assert sum(cb.injected.values()) > 0 and cb.client_stats["retries"] > 0
    _, _, _, tg = _testbed()
    t = tg[3:].numpy()
    loss = [0.5 * np.mean(np.sum((w[:D][None] - t) ** 2, axis=1))
            for w in (fault_free.final_params, cb.final_params)]
    assert abs(loss[1] - loss[0]) / loss[0] < 0.25  # the reference's bar


def test_quorum_degrades_and_recovers():
    sc = ChaosScenario(
        "test-degrade", "partition window drives degradation",
        faults=FaultSpec(partitions=((1, 4, (9, 10, 11, 12)),)),
        timeout_s=0.1, staleness_window=2, degrade_after=1,
        recover_after=1, retry=RetryPolicy(max_attempts=2,
                                           backoff_base_s=0.0))
    res = _chaos(sc)
    trans = res.summaries[-1]["quorum_transitions"]
    reasons = [t["reason"] for t in trans]
    assert "degrade" in reasons and "recover" in reasons
    assert all(7 <= t["new"] <= 13 for t in trans)
    assert len(res.summaries[-1]["quorum_histogram"]) > 1
    assert res.all_rounds_terminated()


def test_degradation_floor_and_off_by_default():
    buf = RoundBuffer(n_clients=13, f=3, quorum=8, timeout_s=0.1)
    buf.set_quorum(7)
    with pytest.raises(ValueError, match="floor"):
        buf.set_quorum(6)
    assert buf.base_quorum == 8 and buf.quorum == 7
    sc = ChaosScenario(
        "test-no-degrade", "timeout rounds, degradation off",
        faults=FaultSpec(partitions=((0, 8, (12,)),)), timeout_s=0.05,
        staleness_window=2, retry=RetryPolicy(max_attempts=2,
                                              backoff_base_s=0.0))
    res = _chaos(sc, rounds=3)
    assert res.summaries[-1]["quorum_transitions"] == []
    assert res.summaries[-1]["fired_by"]["timeout"] == 3


def _server(**serve):
    _, params0, _, _ = _testbed()
    return ByzantineRobustServer(_cfg(), params0, ServeConfig(**serve),
                                 seed=0, device="cpu")


def test_watchdog_fails_a_stalled_round_fast():
    server = _server(watchdog_s=0.1).start()
    try:
        t0 = time.perf_counter()
        with pytest.raises(ServeTimeout) as ei:
            server.wait_round(0, timeout=30.0)
        assert time.perf_counter() - t0 < 5.0
        assert ei.value.reason == "watchdog"
        assert server.metrics.watchdog_summary() == {
            "fired": 1, "resolved": 0, "unresolved": 1}
    finally:
        server.stop()


def test_watchdog_event_resolves_when_the_round_fires():
    loss_fn, params0, batch_fn, _ = _testbed()
    server = _server(watchdog_s=0.15).start()
    pool = ClientPool(loss_fn, params0, _cfg(), batch_fn, device="cpu")
    try:
        ann = server.announce(timeout=10.0)
        time.sleep(0.3)
        for s in pool.round_payloads(ann):
            server.submit(s.update)
        assert server.wait_round(0, timeout=10.0).n_updates == 13
        assert server.metrics.watchdog_summary() == {
            "fired": 1, "resolved": 1, "unresolved": 0}
    finally:
        server.stop()


def test_mid_round_checkpoint_resumes_the_interrupted_round(tmp_path):
    """A checkpoint taken mid-round carries the announcement's words and
    the buffered rows: the restored server re-broadcasts the same
    announcement, re-feeds the rows, and finishes the round bitwise an
    uninterrupted one."""
    loss_fn, params0, batch_fn, _ = _testbed()
    straight = _server()
    run_service(straight, ClientPool(loss_fn, params0, _cfg(), batch_fn,
                                     device="cpu"), 1)
    server = _server().start()
    pool = ClientPool(loss_fn, params0, _cfg(), batch_fn, device="cpu")
    try:
        ann = server.announce(timeout=10.0)
        sched = pool.round_payloads(ann)
        for s in sched[:5]:
            server.submit(s.update)
        deadline = time.perf_counter() + 5.0
        while time.perf_counter() < deadline:
            with server._cond:
                if server._buffer.count == 5:
                    break
            time.sleep(0.01)
        path = server.save_checkpoint(str(tmp_path / "midround"))
    finally:
        server.stop()
    restored = _server()
    restored._key = np.zeros(2, np.uint32)  # overwritten by the restore
    assert restored.restore(path) == 0
    ann2 = restored.announce(timeout=0)
    assert ann2.round_id == 0 and ann2.mask_id == ann.mask_id
    np.testing.assert_array_equal(ann2.atk_key, ann.atk_key)
    np.testing.assert_array_equal(ann2.params, ann.params)
    with restored._cond:
        assert restored._buffer.count == 5
    restored.start()
    try:
        for s in sched[5:]:
            restored.submit(s.update)
        assert restored.wait_round(0, timeout=10.0).n_updates == 13
    finally:
        restored.stop()
    assert torch.equal(restored.params_flat, straight.params_flat)


def test_boundary_checkpoint_restores_the_next_round(tmp_path):
    loss_fn, params0, batch_fn, _ = _testbed()
    s = _server(checkpoint_every=2, checkpoint_dir=str(tmp_path))
    run_service(s, ClientPool(loss_fn, params0, _cfg(), batch_fn,
                              device="cpu"), 4)
    ckpt = sorted(glob.glob(os.path.join(str(tmp_path), "*.npz")))[-1]
    s2 = _server(checkpoint_every=2, checkpoint_dir=str(tmp_path))
    assert s2.restore(ckpt.replace(".npz", "")) == 4
    with s2._cond:
        assert s2._buffer.count == 0 and s2._ann.round_id == 4
        assert (s2._key == s._key).all()
    assert torch.equal(s2.params_flat, s.params_flat)


def test_cli_runs_a_chaos_scenario_on_the_cpu(capsys):
    summary = cli.main(["--scenario", "chaos-serve", "--chaos",
                        "kill-restart", "--transport", "loopback",
                        "--rounds", "6", "--d", "16", "--device", "cpu"])
    assert summary["all_rounds_terminated"] is True
    assert summary["step_traces"] == [1, 1] and summary["restarts"] == 1
    assert set(summary) == {"scenario", "chaos", "transport",
                            "rounds_driven", "restarts",
                            "all_rounds_terminated", "step_traces",
                            "injected_faults", "client_stats", "servers"}
    cli.main(["--list-chaos"])
    assert "combined" in capsys.readouterr().out


def test_kill_restart_when_the_server_outruns_the_loop():
    """Rounds far slower than ``timeout_s``: the server's clock fires rounds
    ahead of ``run_chaos``'s loop (with stale rows), so the announced ids skip. The
    kill still happens once, in the first driven round past
    ``kill_at_round``, and a driven round the killed server already fired
    is taken from it instead of waited for on the restarted one."""
    sc = ChaosScenario("test-outrun", "rounds outrun by the clock",
                       timeout_s=0.001, staleness_window=2, kill_at_round=2,
                       retry=RetryPolicy(max_attempts=2, backoff_base_s=0.0))
    res = _chaos(sc, rounds=8, round_timeout=20.0)
    assert res.restarts == 1 and res.step_traces == [1, 1]
    assert res.all_rounds_terminated()
    assert sum(x["rounds"] for x in res.summaries) >= 8
