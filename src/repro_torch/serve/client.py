"""Simulated client pool for the streaming parameter server (counterpart of
``repro.serve.client``).

Honest clients compute local gradients and put the algorithm's wire
quantity on the uplink (``algorithms.make_wire_fn``: sparsified unbiased
reconstructions under the round's broadcast coordinated mask); Byzantine
clients (rows ``[0, f)``) are driven by ``repro_torch.adversary`` through
the dispatch the simulator uses, with stateful adversaries carrying their
``AttackState`` pool-side. The whole pool answers a round announcement with
one batched pass, the simulator's round up to the server's apply op for op
(``torch.func`` per-worker gradients, the clip, the wire), so full
participation serves ``Simulator.rollout``'s trajectory bitwise on the same
draws. The round's draws come from the announcement's seed words
(``repro_torch.testing.SeedWordDraws``), or from ``draws_for(ann)`` where a
parity check replays other draws.

:class:`ClientBehavior` injects the failure modes the closed-world rollout
cannot express: per-round drop probability, probabilistic late arrival,
and fixed stragglers that are always ``straggle_rounds`` late. Fates are
drawn from numpy, as in the reference, so a seed gives the reference's.

:class:`RetryingClient` is the transport-hardened half: it speaks the frame
protocol over any endpoint (loopback, TCP, fault-injected) with
exponential backoff and seeded jitter, idempotent resubmission (the
server's freshest-wins dedup makes retransmission safe), and
re-announcement on timeout.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import algorithms as alg
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve import protocol
from repro_torch.serve.transport import TransportError
from repro_torch.testing import SeedWordDraws
from repro_torch.utils import tree as T


@dataclasses.dataclass(frozen=True)
class ClientBehavior:
    """Failure-mode injection, drawn from a seeded host-side RNG.

    Attributes:
      drop_prob: per client per round probability the update never arrives.
      late_prob: probability an update is delivered ``late_rounds`` late.
      late_rounds: lateness of probabilistically-late updates.
      stragglers: client ids that are ALWAYS late (e.g. the f byzantine
        ids, for the all-byzantine-late scenario).
      straggle_rounds: how late stragglers deliver.
      seed: RNG seed for the drop/late draws.
    """

    drop_prob: float = 0.0
    late_prob: float = 0.0
    late_rounds: int = 1
    stragglers: Tuple[int, ...] = ()
    straggle_rounds: int = 1
    seed: int = 0


class ScheduledUpdate(NamedTuple):
    """A client's payload plus its injected delivery fate."""

    update: protocol.ClientUpdate
    deliver_round: int
    drop: bool


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic (seeded) jitter.

    Attempt ``k`` (0-based) sleeps ``min(base * 2**k, cap) * (1 + jitter
    * u)`` with ``u ~ U[0, 1)`` drawn from a per-client stream — seeded so
    a chaos replay backs off identically.
    """

    max_attempts: int = 5
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 0.5
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts={self.max_attempts} < 1")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff times must be >= 0")
        if not 0.0 <= self.jitter:
            raise ValueError(f"jitter={self.jitter} < 0")

    def backoff_s(self, client_id: int, attempt: int,
                  rng: np.random.Generator) -> float:
        base = min(self.backoff_base_s * (2.0 ** attempt),
                   self.backoff_cap_s)
        return base * (1.0 + self.jitter * float(rng.random()))


class ClientGaveUp(RuntimeError):
    """Every retry attempt failed (transport faults or NACKs)."""

    def __init__(self, message: str, *, client_id: int, op: str,
                 attempts: int, last_error: Optional[str] = None):
        super().__init__(message)
        self.client_id = client_id
        self.op = op
        self.attempts = attempts
        self.last_error = last_error


class RetryingClient:
    """One client's fault-tolerant protocol client over a transport
    endpoint.

    * ``fetch_announcement`` retries through transport faults and
      ``no_round`` NACKs until an announcement for ``round >= min_round``
      arrives — the *re-announcement on timeout* half of recovery (a
      client that missed a round just asks again and is told the current
      one).
    * ``submit`` retries the SAME update frame until the server acks it.
      Resubmission is idempotent: duplicate deliveries land in the
      ``RoundBuffer``'s freshest-wins dedup, and a ``bad_checksum`` NACK
      (payload corrupted in flight) is repaired by retransmission — the
      retry re-encodes from the intact local update.

    Sleep is injectable so tests run backoff schedules at time-warp.
    """

    def __init__(self, endpoint, client_id: int,
                 policy: Optional[RetryPolicy] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.endpoint = endpoint
        self.client_id = client_id
        self.policy = policy or RetryPolicy()
        self._sleep = sleep
        self._rng = np.random.default_rng(
            (self.policy.seed, int(client_id)))
        #: observability counters: attempts, retries, and give-ups per op
        self.stats = {"announce_attempts": 0, "update_attempts": 0,
                      "retries": 0, "gave_up": 0}

    def _retry(self, op: str, round_id: int, build: Callable[[], bytes],
               accept: Callable[[int, int, bytes], Optional[Any]]) -> Any:
        """Run build -> request -> accept with backoff until ``accept``
        returns non-None or the policy's attempts are exhausted."""
        p = self.policy
        last: Optional[str] = None
        for attempt in range(p.max_attempts):
            self.stats[f"{op}_attempts"] += 1
            if attempt > 0:
                self.stats["retries"] += 1
                self._sleep(p.backoff_s(self.client_id, attempt - 1,
                                        self._rng))
            try:
                raw = self.endpoint.request(
                    build(), round_id=round_id, op=op, attempt=attempt)
                msg_type, sender, payload = protocol.decode_frame(raw)
            except TransportError as e:
                last = f"{type(e).__name__}: {e}"
                continue
            except protocol.FrameError as e:
                last = f"corrupt response: {e}"
                continue
            out = accept(msg_type, sender, payload)
            if out is not None:
                return out
            last = f"nacked (msg_type={msg_type})"
        self.stats["gave_up"] += 1
        raise ClientGaveUp(
            f"client {self.client_id} gave up on {op} for round "
            f"{round_id} after {p.max_attempts} attempts "
            f"(last: {last})", client_id=self.client_id, op=op,
            attempts=p.max_attempts, last_error=last)

    def fetch_announcement(self, min_round: int = 0
                           ) -> protocol.RoundAnnouncement:
        def accept(msg_type, sender, payload):
            if msg_type != protocol.MSG_ANNOUNCE:
                return None                  # ACK("no_round") etc: retry
            ann = protocol.decode_announcement(payload)
            return ann if ann.round_id >= min_round else None

        return self._retry(
            "announce", min_round,
            lambda: protocol.encode_announce_req(min_round, self.client_id),
            accept)

    def submit(self, update: protocol.ClientUpdate) -> str:
        """Deliver one update; returns the server's ack status (e.g.
        ``"queued"``). Raises :class:`ClientGaveUp` when every attempt
        fails."""
        def accept(msg_type, sender, payload):
            if msg_type != protocol.MSG_ACK:
                return None
            _, status = protocol.decode_ack(payload)
            if status == "queued":
                return status
            if status.startswith("rejected"):
                # a validation rejection is not a transport fault: the
                # update itself is malformed — retrying cannot help
                raise ValueError(
                    f"client {self.client_id} update for round "
                    f"{update.round_id} rejected: {status}")
            return None                      # bad_checksum/bad_frame: retry

        return self._retry(
            "update", update.round_id,
            lambda: protocol.encode_update(update), accept)

    def close(self) -> None:
        self.endpoint.close()


class ClientPool:
    """All n simulated clients (honest + Byzantine) answering one server.

    ``device`` is where the gradients and the wire are computed (default
    the card). ``draws_for(ann)`` gives a round's draws provider (default
    :class:`~repro_torch.testing.SeedWordDraws` of the announcement's
    words)."""

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 params0: Any, cfg: alg.AlgorithmConfig,
                 batch_fn: Callable[[int], Any],
                 behavior: Optional[ClientBehavior] = None,
                 device: DeviceLike = None,
                 draws_for: Optional[Callable[[protocol.RoundAnnouncement],
                                              Any]] = None):
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.behavior = behavior or ClientBehavior()
        self.device = resolve_device(device)
        self.spec = T.make_flat_spec(T.tree_map(torch.as_tensor, params0))
        self.d = self.spec.size
        self._rng = np.random.default_rng(self.behavior.seed)
        self.draws_for = draws_for or (lambda ann: SeedWordDraws(
            ann.mask_key, ann.atk_key, self.device))
        from repro_torch.adversary import core as adv
        self.attack_state = (adv.init_attack_state(self.spec.padded_size,
                                                   device=self.device)
                             if adv.needs_attack_state(cfg.attack.name,
                                                       cfg.f) else None)
        self._wire_fn = alg.make_wire_fn(cfg)
        # the simulator's per-worker (gradient, loss): params shared,
        # batches mapped over the leading worker axis
        self._grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn),
                                        in_dims=(None, 0))
        self.last_losses: Optional[np.ndarray] = None

    def wire(self, ann: protocol.RoundAnnouncement
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The simulator's round up to (and excluding) the server's apply:
        per-worker gradients at the announced parameters, the clip, the
        wire half. Returns ``(wire [n, padded_D], losses [n])`` on the
        device and advances the adversary's state."""
        params_flat = torch.from_numpy(np.array(ann.params, np.float32)).to(
            self.device)
        params = T.tree_unravel(params_flat, self.spec)
        batch = T.tree_map(lambda a: torch.as_tensor(a).to(self.device),
                           self.batch_fn(ann.round_id))
        grad_tree, losses = self._grad_fn(params, batch)
        grads = T.stacked_ravel(grad_tree, self.spec)
        if self.cfg.clip_norm is not None:
            grads = alg._clip(grads, self.cfg.clip_norm)
        wire, self.attack_state = self._wire_fn(self.attack_state, grads,
                                                self.draws_for(ann))
        return wire, losses

    def round_payloads(self, ann: protocol.RoundAnnouncement
                       ) -> List[ScheduledUpdate]:
        """Answer one round announcement: every client's update, tagged
        with its injected delivery fate (drop / deliver at round t+k)."""
        b = self.behavior
        wire, losses = self.wire(ann)
        wire = wire.cpu().numpy()
        self.last_losses = losses.cpu().numpy()
        out: List[ScheduledUpdate] = []
        now = time.perf_counter()
        for cid in range(self.cfg.n_workers):
            u_drop, u_late = self._rng.random(2)
            if cid in b.stragglers:
                deliver, drop = ann.round_id + b.straggle_rounds, False
            elif u_drop < b.drop_prob:
                deliver, drop = ann.round_id, True
            elif u_late < b.late_prob:
                deliver, drop = ann.round_id + b.late_rounds, False
            else:
                deliver, drop = ann.round_id, False
            out.append(ScheduledUpdate(
                update=protocol.make_update(self.cfg, self.d, cid, ann,
                                            wire[cid], sent_at=now),
                deliver_round=deliver, drop=drop))
        return out
