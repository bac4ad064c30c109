"""Service metrics: sustained throughput, round latency, participation,
ingest-classification histograms, quorum transitions, fault events
(counterpart of ``repro.serve.metrics``, the same ``summary()`` keys).

The server records one :class:`RoundRecord` per fired round plus a running
count of ingest decisions, keyed per round, so the ``RoundBuffer.add``
classification (duplicate / future / stale_dropped / bad_mask /
bad_checksum) is observable as per-round histograms;
:meth:`ServeMetrics.summary` folds them into sustained updates/sec and
rounds/sec over the measured span, p50/p99 round
latency (round open -> parameters applied), per-round participation +
staleness + classification histograms, the quorum degradation/recovery
transition log, and liveness-watchdog + fault-budget events.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

#: The RoundBuffer.add classifications surfaced as per-round histograms.
DECISION_CLASSES = ("accepted", "replaced", "duplicate", "future",
                    "stale_dropped", "bad_mask", "bad_client",
                    "bad_checksum")


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) without numpy, so metrics
    stay importable host-side anywhere."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    rank = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return float(s[rank])


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One fired round, as observed by the batcher."""

    round_id: int
    n_updates: int                 # rows aggregated (accepted updates)
    fired_by: str                  # "quorum" | "timeout"
    staleness: Tuple[int, ...]     # per accepted update, in client-id order
    latency_s: float               # round open -> params applied
    step_s: float                  # aggregate-and-apply wall time
    payload_bytes: int             # accounted uplink bytes this round
    quorum: int = 0                # effective quorum when the round fired


@dataclasses.dataclass(frozen=True)
class QuorumTransition:
    """One graceful-degradation (or recovery) step of the effective
    quorum, always bounded inside [2f+1 floor, configured quorum]."""

    round_id: int
    old: int
    new: int
    reason: str                    # "degrade" | "recover"


@dataclasses.dataclass
class WatchdogEvent:
    """The liveness watchdog observed a stalled round."""

    round_id: int
    open_s: float                  # how long the round had been open
    buffered: int                  # accepted updates at fire time
    quorum: int                    # effective quorum it was waiting for
    resolved: bool = False         # the round did eventually fire


class ServeMetrics:
    """Accumulates round records + ingest decisions for one service run."""

    def __init__(self):
        self.rounds: List[RoundRecord] = []
        self.decisions: Dict[str, int] = {}
        self.round_decisions: Dict[int, Dict[str, int]] = {}
        self.quorum_transitions: List[QuorumTransition] = []
        self.watchdog_events: List[WatchdogEvent] = []
        self.fault_budget_events: List[Dict[str, object]] = []
        self.started_at: float = 0.0
        self.finished_at: float = 0.0

    def observe_decision(self, status: str,
                         round_id: Optional[int] = None) -> None:
        self.decisions[status] = self.decisions.get(status, 0) + 1
        if round_id is not None:
            per = self.round_decisions.setdefault(round_id, {})
            per[status] = per.get(status, 0) + 1

    def observe_round(self, rec: RoundRecord) -> None:
        self.rounds.append(rec)

    def observe_quorum_transition(self, round_id: int, old: int, new: int,
                                  reason: str) -> None:
        self.quorum_transitions.append(
            QuorumTransition(round_id, old, new, reason))

    def observe_watchdog(self, round_id: int, open_s: float, buffered: int,
                         quorum: int) -> WatchdogEvent:
        ev = WatchdogEvent(round_id, open_s, buffered, quorum)
        self.watchdog_events.append(ev)
        return ev

    def resolve_watchdog(self, round_id: int) -> None:
        for ev in self.watchdog_events:
            if ev.round_id == round_id:
                ev.resolved = True

    def observe_fault_budget(self, round_id: int, faulty: Sequence[int],
                             declared_byzantine: int, f: int) -> None:
        self.fault_budget_events.append({
            "round_id": round_id, "protocol_faulty": sorted(faulty),
            "declared_byzantine": declared_byzantine, "f": f})

    def span(self, start: float, end: float) -> None:
        self.started_at, self.finished_at = start, end

    # -- summaries ---------------------------------------------------------

    def participation_histogram(self) -> Dict[int, int]:
        """rounds keyed by how many updates they aggregated."""
        h: Dict[int, int] = {}
        for r in self.rounds:
            h[r.n_updates] = h.get(r.n_updates, 0) + 1
        return dict(sorted(h.items()))

    def staleness_histogram(self) -> Dict[int, int]:
        """accepted updates keyed by their staleness (rounds late)."""
        h: Dict[int, int] = {}
        for r in self.rounds:
            for s in r.staleness:
                h[s] = h.get(s, 0) + 1
        return dict(sorted(h.items()))

    def decision_round_histogram(self, status: str) -> Dict[int, int]:
        """Rounds keyed by how many ``status`` classifications they saw
        (zero bucket included, over every round with any decision), e.g.
        ``{0: 37, 1: 2, 4: 1}`` = 2 rounds saw one duplicate, 1 saw four."""
        h: Dict[int, int] = {}
        for per in self.round_decisions.values():
            k = per.get(status, 0)
            h[k] = h.get(k, 0) + 1
        return dict(sorted(h.items()))

    def quorum_histogram(self) -> Dict[int, int]:
        """rounds keyed by the effective quorum they fired under — the
        degradation trace in histogram form."""
        h: Dict[int, int] = {}
        for r in self.rounds:
            h[r.quorum] = h.get(r.quorum, 0) + 1
        return dict(sorted(h.items()))

    def watchdog_summary(self) -> Dict[str, int]:
        fired = len(self.watchdog_events)
        unresolved = sum(1 for ev in self.watchdog_events
                         if not ev.resolved)
        return {"fired": fired, "resolved": fired - unresolved,
                "unresolved": unresolved}

    def summary(self) -> Dict[str, object]:
        wall = max(self.finished_at - self.started_at, 1e-12)
        lat = [r.latency_s for r in self.rounds]
        updates = sum(r.n_updates for r in self.rounds)
        return {
            "rounds": len(self.rounds),
            "updates_accepted": updates,
            "wall_s": wall,
            "rounds_per_sec": len(self.rounds) / wall,
            "updates_per_sec": updates / wall,
            "latency_p50_ms": percentile(lat, 50) * 1e3,
            "latency_p99_ms": percentile(lat, 99) * 1e3,
            "latency_max_ms": (max(lat) if lat else float("nan")) * 1e3,
            "step_p50_ms": percentile(
                [r.step_s for r in self.rounds], 50) * 1e3,
            "fired_by": {
                k: sum(1 for r in self.rounds if r.fired_by == k)
                for k in ("quorum", "timeout")},
            "participation_histogram": {
                str(k): v for k, v in self.participation_histogram().items()},
            "staleness_histogram": {
                str(k): v for k, v in self.staleness_histogram().items()},
            "ingest_decisions": dict(sorted(self.decisions.items())),
            "decision_round_histograms": {
                status: {str(k): v for k, v
                         in self.decision_round_histogram(status).items()}
                for status in DECISION_CLASSES
                if status in self.decisions},
            "quorum_histogram": {
                str(k): v for k, v in self.quorum_histogram().items()},
            "quorum_transitions": [
                dataclasses.asdict(t) for t in self.quorum_transitions],
            "watchdog": self.watchdog_summary(),
            "fault_budget_events": list(self.fault_budget_events),
            "uplink_bytes": sum(r.payload_bytes for r in self.rounds),
        }
