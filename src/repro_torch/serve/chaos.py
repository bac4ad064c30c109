"""Named chaos scenarios: fault plans composed with the serving stack
(counterpart of ``repro.serve.chaos``; the reference's scenarios, name for
name).

A :class:`ChaosScenario` bundles everything one fault-injection experiment
needs — a :class:`~repro_torch.serve.faults.FaultSpec` (+ seed), the transport
kind, the client retry policy, straggler behaviour, the server's
degradation/watchdog knobs, and an optional mid-round kill-and-restart —
under a registry name, mirroring ``repro_torch.adversary.registry`` for the
*transport* axis of adversity. The Byzantine axis still comes from the
adversary registry: a chaos run takes any serveable scenario cell, so
``chaos x attack x aggregator`` composes freely.

:func:`run_chaos` drives it: a lock-step announce -> submit -> apply
loop (mirroring ``run_service``, which keeps the fault-free scenario
bit-for-bit comparable to the in-process server) where every frame
crosses a real transport boundary through a :class:`FaultyEndpoint` and a
:class:`RetryingClient`. With ``kill_at_round`` set, the server is killed
*mid-round* — after only half the clients submitted — checkpointed,
rebuilt, restored, and rebound to the same transport; the surviving
clients' in-flight updates then land on the restarted server, which
resumes the interrupted round.

``tests/test_torch_chaos.py`` and the serve phase of ``chip_smoke.py`` hold
the composition: fault-free chaos over loopback and TCP bitwise the
in-process server, every scenario terminating, the kill-restart resuming
bitwise, and one step built per server instance (``step_traces``).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import algorithms as alg
from repro_torch.device import DeviceLike
from repro_torch.serve.client import (
    ClientBehavior, ClientGaveUp, ClientPool, RetryingClient, RetryPolicy,
)
from repro_torch.serve.faults import FaultPlan, FaultSpec, FaultyEndpoint
from repro_torch.serve.server import (
    ByzantineRobustServer, RoundResult, ServeConfig,
)
from repro_torch.serve.transport import TransportError, make_transport


@dataclasses.dataclass(frozen=True)
class ChaosScenario:
    """One named fault-injection experiment over the serving stack.

    Attributes:
      name/description: registry identity.
      faults: the per-attempt fault rates + partition schedule.
      fault_seed: seed of the :class:`FaultPlan` (replayability).
      transport: ``loopback`` | ``tcp``.
      retry: client-side backoff policy.
      quorum: server firing quorum (``None`` = all n).
      timeout_s / staleness_window / stale_policy: round-buffer knobs —
        chaos scenarios usually need a wall-clock deadline so a round with
        dropped clients still fires.
      degrade_after / recover_after / watchdog_s / fault_tolerance: the
        server's fault-domain knobs (see :class:`ServeConfig`).
      stragglers / straggle_rounds: always-late clients (pool-side).
      kill_at_round: kill + checkpoint + restore + rebind the server in
        the middle of this round, or of the first driven round past it
        when the server's clock skipped it (``None`` = never).
    """

    name: str
    description: str
    faults: FaultSpec = FaultSpec()
    fault_seed: int = 0
    transport: str = "loopback"
    retry: RetryPolicy = RetryPolicy()
    quorum: Optional[int] = None
    timeout_s: float = 0.0
    staleness_window: int = 0
    stale_policy: str = "discount"
    degrade_after: int = 0
    recover_after: int = 2
    watchdog_s: float = 0.0
    fault_tolerance: int = 3
    stragglers: Tuple[int, ...] = ()
    straggle_rounds: int = 1
    kill_at_round: Optional[int] = None

    def serve_config(self) -> ServeConfig:
        return ServeConfig(
            quorum=self.quorum, timeout_s=self.timeout_s,
            staleness_window=self.staleness_window,
            stale_policy=self.stale_policy,
            degrade_after=self.degrade_after,
            recover_after=self.recover_after,
            watchdog_s=self.watchdog_s,
            fault_tolerance=self.fault_tolerance)

    def behavior(self, seed: int) -> ClientBehavior:
        return ClientBehavior(stragglers=self.stragglers,
                              straggle_rounds=self.straggle_rounds,
                              seed=seed)


CHAOS_REGISTRY: Dict[str, ChaosScenario] = {}


def register_chaos(sc: ChaosScenario) -> ChaosScenario:
    CHAOS_REGISTRY[sc.name] = sc
    return sc


def get_chaos(name: str) -> ChaosScenario:
    try:
        return CHAOS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown chaos scenario: {name!r} (known: "
            f"{', '.join(sorted(CHAOS_REGISTRY))})") from None


def describe_chaos() -> str:
    width = max((len(n) for n in CHAOS_REGISTRY), default=0)
    return "\n".join(f"{s.name:<{width}}  {s.description}"
                     for s in CHAOS_REGISTRY.values())


for _sc in (
    ChaosScenario(
        "fault-free",
        "clean transport, full quorum — the parity + loss baseline"),
    ChaosScenario(
        "drop-storm",
        "15% of frames vanish; retries + wall-clock rounds keep serving",
        faults=FaultSpec(drop=0.15), timeout_s=0.25, staleness_window=2),
    ChaosScenario(
        "dup-flood",
        "half of all deliveries are duplicated (retransmission storm); "
        "the buffer's freshest-wins dedup absorbs every copy",
        faults=FaultSpec(duplicate=0.5), timeout_s=0.25,
        staleness_window=2),
    ChaosScenario(
        "corrupt-burst",
        "25% of frames arrive with flipped payload bytes; CRC rejection + "
        "retransmission repair them without charging honest clients",
        faults=FaultSpec(corrupt=0.25), timeout_s=0.25,
        staleness_window=2, fault_tolerance=6),
    ChaosScenario(
        "partition-heal",
        "4 clients partitioned for rounds 5..9; quorum degrades toward "
        "the 2f+1 floor, then recovers after the heal",
        faults=FaultSpec(partitions=((5, 10, (3, 4, 5, 6)),)),
        timeout_s=0.2, staleness_window=2, degrade_after=2,
        recover_after=2),
    ChaosScenario(
        "reset-storm",
        "30% of exchanges reset mid-flight (half before, half after "
        "delivery — the after-delivery retries must dedup)",
        faults=FaultSpec(reset=0.3), timeout_s=0.25, staleness_window=2),
    ChaosScenario(
        "straggler-degrade",
        "3 fixed stragglers always one round late; consecutive wall-clock "
        "rounds walk the quorum down, their stale (discounted) updates "
        "still count",
        timeout_s=0.15, staleness_window=2, degrade_after=2,
        stragglers=(10, 11, 12)),
    ChaosScenario(
        "kill-restart",
        "clean transport, server killed MID-ROUND at round 5 and restored "
        "from checkpoint — resumes the interrupted round bit-for-bit",
        kill_at_round=5),
    ChaosScenario(
        "combined",
        "everything at once: drop + duplicate + corrupt + delay + reset + "
        "a straggler + mid-round kill-and-restart, under graceful "
        "degradation and the liveness watchdog (the bench's loss gate)",
        faults=FaultSpec(drop=0.1, duplicate=0.2, corrupt=0.1, reset=0.1,
                         delay=0.2, delay_s=0.002),
        timeout_s=0.3, staleness_window=2, degrade_after=3,
        watchdog_s=10.0, fault_tolerance=6,
        stragglers=(10,), kill_at_round=5),
):
    register_chaos(_sc)


@dataclasses.dataclass
class ChaosResult:
    """What one chaos run produced (per restarted server instance where
    it applies)."""

    final_params: np.ndarray           # flat [padded_D] served parameters
    results: List[RoundResult]         # one per driven round, in order
    summaries: List[Dict[str, Any]]    # ServeMetrics.summary per instance
    step_traces: List[int]             # steps built per server instance
    injected: Dict[str, int]           # fault counters across endpoints
    client_stats: Dict[str, int]       # retry counters across clients
    restarts: int
    rounds_driven: int
    unresolved_watchdogs: int

    def all_rounds_terminated(self) -> bool:
        return (len(self.results) == self.rounds_driven
                and self.unresolved_watchdogs == 0)


def _fetch_announcement(clients: List[RetryingClient], min_round: int):
    """Ask the clients (in id order) for the round's announcement; any
    one success is enough — the pool answers for everyone. A client whose
    endpoint is partitioned/faulted just gives way to the next."""
    last: Optional[Exception] = None
    for c in clients:
        try:
            return c.fetch_announcement(min_round)
        except (ClientGaveUp, TransportError) as e:
            last = e
    raise RuntimeError(
        f"no client could fetch the round {min_round} announcement "
        f"(last: {last})")


def run_chaos(cfg: alg.AlgorithmConfig, params0: Any,
              batch_fn: Callable[[int], Any],
              loss_fn: Callable[[Any, Any], Any],
              chaos: ChaosScenario, rounds: int, *, seed: int = 0,
              checkpoint_dir: Optional[str] = None,
              round_timeout: float = 60.0, device: DeviceLike = None,
              draws_for: Optional[Callable[[Any], Any]] = None
              ) -> ChaosResult:
    """Drive ``rounds`` announce -> submit -> apply cycles across a fault-
    injected transport (the chaos mirror of ``run_service``). ``device``
    is the servers' and the pool's (default the card); ``draws_for`` is the
    pool's (:class:`~repro_torch.serve.client.ClientPool`)."""
    serve = chaos.serve_config()
    plan = FaultPlan(chaos.faults, seed=chaos.fault_seed)
    pool = ClientPool(loss_fn, params0, cfg, batch_fn,
                      behavior=chaos.behavior(seed), device=device,
                      draws_for=draws_for)
    n = cfg.n_workers

    server = ByzantineRobustServer(cfg, params0, serve, seed=seed,
                                   device=device)
    transport = make_transport(chaos.transport)
    transport.bind(server)
    server.start()
    servers = [server]

    endpoints = [FaultyEndpoint(transport.connect(cid), cid, plan)
                 for cid in range(n)]
    clients = [RetryingClient(ep, cid, chaos.retry)
               for cid, ep in enumerate(endpoints)]

    owned_tmp = None
    if chaos.kill_at_round is not None and checkpoint_dir is None:
        owned_tmp = tempfile.TemporaryDirectory(prefix="repro_chaos_")
        checkpoint_dir = owned_tmp.name

    # rounds the killed server fired: when its clock ran ahead of this
    # loop, the loop's round may be one of them
    fired_before_kill: Dict[int, RoundResult] = {}

    def restart_mid_round() -> ByzantineRobustServer:
        """Kill + checkpoint + restore + rebind: the crash-recovery path.
        (Checkpoint first models a server whose durable state survived
        the crash; the restore path is identical either way.)"""
        nonlocal server
        path = server.save_checkpoint(
            os.path.join(checkpoint_dir, "chaos_kill"))
        transport.unbind()
        server.stop()
        with server._cond:
            fired_before_kill.update(server._results)
        server = ByzantineRobustServer(cfg, params0, serve, seed=seed,
                                       device=device)
        server.restore(path)
        transport.bind(server)
        server.start()
        servers.append(server)
        return server

    pending: List[Tuple[int, Any]] = []
    results: List[RoundResult] = []
    restarts = 0
    t_start = time.perf_counter()
    try:
        expect = 0
        for _ in range(rounds):
            ann = _fetch_announcement(clients, min_round=expect)
            t = ann.round_id
            due = [u for dr, u in pending if dr <= t]
            pending = [(dr, u) for dr, u in pending if dr > t]
            sched = pool.round_payloads(ann)
            # the first driven round at or past kill_at_round: when the
            # server's clock fires rounds ahead of this loop (rounds slower
            # than timeout_s), the announced ids skip, and the reference's
            # test for equality can skip the kill
            kill_here = (chaos.kill_at_round is not None and not restarts
                         and t >= chaos.kill_at_round)
            to_send: List[Any] = [u for u in due]
            for s in sched:
                if s.drop:
                    continue
                if s.deliver_round <= t:
                    to_send.append(s.update)
                else:
                    pending.append((s.deliver_round, s.update))
            to_send.sort(key=lambda u: u.client_id)
            for k, u in enumerate(to_send):
                if kill_here and k == len(to_send) // 2:
                    # mid-round crash: half the round's updates are
                    # in-flight server-side when the process dies
                    restart_mid_round()
                    restarts += 1
                try:
                    clients[u.client_id].submit(u)
                except (ClientGaveUp, ValueError):
                    pass       # this client's update is lost this round
            for ep in endpoints:
                ep.flush()     # deliver any held (reordered) frames
            results.append(fired_before_kill.pop(t, None)
                           or server.wait_round(t, timeout=round_timeout))
            expect = t + 1
    finally:
        server.metrics.span(t_start, time.perf_counter())
        for c in clients:
            try:
                c.close()
            except TransportError:
                pass
        server.stop()
        transport.close()
        if owned_tmp is not None:
            owned_tmp.cleanup()

    injected: Dict[str, int] = {}
    for ep in endpoints:
        for k, v in ep.injected.items():
            injected[k] = injected.get(k, 0) + v
    client_stats: Dict[str, int] = {}
    for c in clients:
        for k, v in c.stats.items():
            client_stats[k] = client_stats.get(k, 0) + v
    summaries = [s.metrics.summary() for s in servers]
    unresolved = sum(s["watchdog"]["unresolved"] for s in summaries)
    return ChaosResult(
        final_params=server.params_flat.cpu().numpy(),
        results=results,
        summaries=summaries,
        step_traces=[s.step_traces for s in servers],
        injected=injected,
        client_stats=client_stats,
        restarts=restarts,
        rounds_driven=rounds,
        unresolved_watchdogs=unresolved)
