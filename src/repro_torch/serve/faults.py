"""Deterministic transport fault injection for the serving stack
(counterpart of ``repro.serve.faults``: the same decisions and corrupted
bytes for the same seed).

A :class:`FaultPlan` is a *seeded, replayable* schedule of transport
faults: every ``(client, round, op, attempt)`` coordinate maps — through
its own ``numpy`` ``SeedSequence`` stream, independent of call order — to
one :class:`FaultDecision` drawing from the :class:`FaultSpec` rates.
Replaying the same plan against the same request schedule reproduces the
same faults bit-for-bit (``tests/test_torch_transport.py`` checks this), which
is what makes a chaos failure debuggable: re-run the scenario with the
same seed and the same frames drop, duplicate, and corrupt.

The fault taxonomy (all byte-level, applied by :class:`FaultyEndpoint`
around any transport endpoint):

``delay``      sleep ``delay_s`` before delivery (straggling network);
``drop``       the frame never arrives — the caller sees a
               :class:`~repro_torch.serve.transport.TransportTimeout`;
``duplicate``  the frame is delivered twice (retransmission storm) — the
               server's freshest-wins dedup must absorb the second copy;
``reorder``    the frame is held and delivered *after* the client's next
               frame (out-of-order arrival);
``corrupt``    payload bytes are flipped (header left intact so the fault
               stays attributable) — the server must classify the CRC
               failure as a protocol fault, never crash;
``partition``  a scheduled ``(round_start, round_end, clients)`` window in
               which every frame from those clients is lost;
``reset``      the connection resets mid-exchange — drawn fairly between
               reset-before-delivery (frame lost) and reset-after-delivery
               (frame arrived but the ack didn't: the client's retry
               becomes a duplicate the server must dedup).

Faults apply to *requests* (client -> server). Decisions are drawn per
delivery attempt, so a retrying client eventually gets through unless the
plan partitions it outright.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serve import protocol
from repro_torch.serve.transport import TransportReset, TransportTimeout

#: Operations a fault decision is keyed on.
OPS = ("announce", "update")
_OP_IDX = {op: i for i, op in enumerate(OPS)}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-attempt fault rates + the deterministic partition schedule.

    Attributes:
      delay/drop/duplicate/reorder/corrupt/reset: per-delivery-attempt
        probabilities in [0, 1] (drawn independently; ``drop`` preempts
        the rest, then ``reset``, then the deliverable faults compose).
      delay_s: sleep applied when ``delay`` fires.
      partitions: ``((round_start, round_end, (client_ids...)), ...)`` —
        client ``c`` is partitioned for round ``t`` iff some window has
        ``round_start <= t < round_end`` and ``c`` in its ids. Scheduled,
        not random: partitions model correlated outages.
    """

    delay: float = 0.0
    drop: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0
    corrupt: float = 0.0
    reset: float = 0.0
    delay_s: float = 0.005
    partitions: Tuple[Tuple[int, int, Tuple[int, ...]], ...] = ()

    def __post_init__(self):
        for name in ("delay", "drop", "duplicate", "reorder", "corrupt",
                     "reset"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"FaultSpec.{name}={v} outside [0, 1]")
        if self.delay_s < 0:
            raise ValueError(f"FaultSpec.delay_s={self.delay_s} < 0")

    def any_faults(self) -> bool:
        return bool(self.partitions) or any(
            getattr(self, n) > 0 for n in
            ("delay", "drop", "duplicate", "reorder", "corrupt", "reset"))


@dataclasses.dataclass(frozen=True)
class FaultDecision:
    """The drawn fate of one delivery attempt."""

    partitioned: bool = False
    delay_s: float = 0.0
    drop: bool = False
    duplicate: bool = False
    reorder: bool = False
    corrupt: bool = False
    reset_before: bool = False   # reset, frame lost
    reset_after: bool = False    # reset, frame delivered but ack lost

    @property
    def clean(self) -> bool:
        return self == FaultDecision()


class FaultPlan:
    """Seeded deterministic fault schedule over (client, round, op,
    attempt) coordinates."""

    def __init__(self, spec: FaultSpec, seed: int = 0):
        self.spec = spec
        self.seed = int(seed)

    def _rng(self, client_id: int, round_id: int, op: str,
             attempt: int) -> np.random.Generator:
        # each coordinate gets its own independent stream — decisions do
        # not depend on the order they are asked for
        return np.random.default_rng(
            (self.seed, int(client_id), max(int(round_id), 0),
             _OP_IDX[op], int(attempt)))

    def partitioned(self, client_id: int, round_id: int) -> bool:
        return any(start <= round_id < end and client_id in cids
                   for start, end, cids in self.spec.partitions)

    def decide(self, client_id: int, round_id: int, op: str,
               attempt: int = 0) -> FaultDecision:
        """Draw one attempt's fate (pure: same coordinate -> same fate)."""
        s = self.spec
        if self.partitioned(client_id, round_id):
            return FaultDecision(partitioned=True)
        rng = self._rng(client_id, round_id, op, attempt)
        # fixed draw order => replayable bit-for-bit
        u = rng.random(7)
        if u[0] < s.drop:
            return FaultDecision(drop=True)
        reset_before = reset_after = False
        if u[1] < s.reset:
            reset_before = u[2] < 0.5
            reset_after = not reset_before
        if reset_before:
            return FaultDecision(reset_before=True)
        return FaultDecision(
            delay_s=s.delay_s if u[3] < s.delay else 0.0,
            duplicate=u[4] < s.duplicate,
            reorder=u[5] < s.reorder,
            corrupt=u[6] < s.corrupt,
            reset_after=reset_after)

    def corrupt_bytes(self, raw: bytes, client_id: int, round_id: int,
                      op: str, attempt: int = 0) -> bytes:
        """Flip deterministic payload bytes (header left intact, so the
        CRC fails but the fault stays attributable to the sender)."""
        body = len(raw) - protocol.HEADER_SIZE
        if body <= 0:
            return raw
        rng = self._rng(client_id, round_id, op, attempt)
        rng.random(7)                       # skip the decision draws
        n_flips = int(rng.integers(1, min(8, body) + 1))
        offsets = rng.integers(0, body, size=n_flips)
        buf = bytearray(raw)
        for off in offsets:
            buf[protocol.HEADER_SIZE + int(off)] ^= 0xFF
        return bytes(buf)


class FaultyEndpoint:
    """Wraps any transport endpoint with a :class:`FaultPlan`.

    ``request(raw, round_id=..., op=..., attempt=...)`` consults the plan
    for that coordinate and applies the drawn faults at the byte level.
    Reordered frames are held and delivered after the *next* frame from
    this endpoint (``flush()`` delivers a still-held frame at a round
    boundary); their caller gets a synthetic ``ACK("queued")`` — exactly
    what the real path returns for a queued update, since ingestion is
    asynchronous either way.
    """

    def __init__(self, inner, client_id: int, plan: FaultPlan,
                 sleep: Callable[[float], None] = time.sleep):
        self.inner = inner
        self.client_id = client_id
        self.plan = plan
        self._sleep = sleep
        self._held: Optional[bytes] = None
        #: injected-fault counters, keyed by fault kind (observability)
        self.injected: Dict[str, int] = {}

    def _count(self, kind: str) -> None:
        self.injected[kind] = self.injected.get(kind, 0) + 1

    def _deliver_held(self) -> None:
        if self._held is not None:
            held, self._held = self._held, None
            try:
                self.inner.request(held)
            except (TransportTimeout, TransportReset):
                pass                        # held frame lost: chaos is chaos

    def flush(self) -> None:
        """Deliver a still-held (reordered) frame — call at round end."""
        self._deliver_held()

    def request(self, raw: bytes, *, round_id: int = 0, op: str = "update",
                attempt: int = 0, **ctx) -> bytes:
        d = self.plan.decide(self.client_id, round_id, op, attempt)
        if d.partitioned:
            self._count("partitioned")
            raise TransportTimeout(
                f"client {self.client_id} partitioned at round {round_id}")
        if d.drop:
            self._count("drop")
            raise TransportTimeout(
                f"frame dropped (client {self.client_id}, round {round_id},"
                f" {op}, attempt {attempt})")
        if d.reset_before:
            self._count("reset")
            raise TransportReset(
                f"connection reset before delivery (client "
                f"{self.client_id}, round {round_id})")
        if d.delay_s > 0:
            self._count("delay")
            self._sleep(d.delay_s)
        if d.corrupt:
            self._count("corrupt")
            raw = self.plan.corrupt_bytes(raw, self.client_id, round_id,
                                          op, attempt)
        if d.reorder and op == "update":
            # hold this frame; it goes out after the NEXT one
            self._count("reorder")
            self._deliver_held()
            self._held = raw
            return protocol.encode_ack(round_id, "queued")
        resp = self.inner.request(raw)
        if d.duplicate:
            self._count("duplicate")
            try:
                self.inner.request(raw)
            except (TransportTimeout, TransportReset):
                pass
        self._deliver_held()
        if d.reset_after:
            self._count("reset")
            raise TransportReset(
                f"connection reset after delivery (client "
                f"{self.client_id}, round {round_id}) — the retry is a "
                "duplicate the server must dedup")
        return resp

    def close(self) -> None:
        self.flush()
        self.inner.close()


def faulty_endpoints(transport, n_clients: int, plan: FaultPlan
                     ) -> List[FaultyEndpoint]:
    """Connect ``n_clients`` endpoints through one shared plan."""
    return [FaultyEndpoint(transport.connect(cid), cid, plan)
            for cid in range(n_clients)]
