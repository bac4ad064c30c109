"""The continuously batching Byzantine-robust parameter server (counterpart
of ``repro.serve.server``).

Architecture (the queue/thread/batcher idiom around one aggregate-and-apply
step):

* ``submit()`` enqueues :class:`~repro_torch.serve.protocol.ClientUpdate`s
  onto a ``queue.Queue`` from any thread;
* the **ingest thread** drains the queue into the
  :class:`~repro_torch.serve.buffer.RoundBuffer` (quorum / timeout /
  staleness classification) and wakes the batcher;
* the **batcher thread** watches the buffer and, on quorum or timeout, fires
  ONE aggregate-and-apply step on the device: the ``make_aggregator`` rule
  (the pairdist, CWTM and median kernels on the card through
  ``AggregatorConfig.use_kernels``) and the rosdhb/robust_dgd/dgd apply
  halves the simulator runs (``algorithms.make_serve_apply_fn``). Absent
  clients are padded: participation enters the step as a ``present`` row
  mask and staleness as a ``discount`` weight over a fixed ``[n, D]`` wire
  bank, so every participation level runs the same kernels on the same
  shapes. ``step_traces`` counts the steps a server built (one per server
  instance), the key the reference uses for its count of compiled programs.

The batcher thread launches the kernels on the device's current stream,
which is the default stream in every thread of the process: two servers in
one process (a chaos kill-restart, a transport-parity check) order their
launches on that one stream, which the kernels' shared launch state
(pairdist's ticket counters and scratch) relies on.

Seeds: the server keeps a chain of uint32 seed words (:func:`split_words`).
Per round the carried words split into ``(carry, round)`` and the round's
into ``(mask, attack)``, both broadcast in the announcement, as the
reference splits its threefry key. A client derives the round's draws from
them (``repro_torch.testing.SeedWordDraws``), so with full participation and
zero timeout the served trajectory is bitwise ``Simulator.rollout``'s on the
same per-round draws.

``repro_torch.checkpoint`` is wired in: with ``checkpoint_every > 0`` the
server persists ``{params, ServerState, seed words}``, and a fresh server
``restore()``s and continues bitwise under full participation. Checkpoints
also carry the open round's announcement words and the in-flight
``RoundBuffer`` rows, so a server killed mid-round restores into the
interrupted round: the same announcement, the already-ingested rows re-fed.

Fault domain: typed :class:`ServeTimeout` errors, the protocol-fault budget
(:class:`FaultBudgetExceeded` once protocol-faulty plus declared-Byzantine
clients exceed ``f``), graceful quorum degradation toward the ``2f + 1``
floor and back, and the liveness watchdog, as in the reference.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as alg
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serve import protocol
from repro_torch.serve.buffer import RoundBuffer
from repro_torch.serve.metrics import RoundRecord, ServeMetrics
from repro_torch.utils import tree as T


def seed_words(seed: int) -> np.ndarray:
    """The chain's first words for ``seed``: ``[0, seed]`` as uint32, as
    ``jax.random.PRNGKey(seed)`` lays out a 32-bit seed."""
    return np.array([(int(seed) >> 32) & 0xFFFFFFFF, int(seed) & 0xFFFFFFFF],
                    np.uint32)


def split_words(words) -> Tuple[np.ndarray, np.ndarray]:
    """Two new pairs of uint32 words from one (numpy's ``SeedSequence``
    over the words): the seed chain's split."""
    out = np.random.SeedSequence(
        [int(w) for w in np.asarray(words, np.uint32).reshape(-1)]
    ).generate_state(4, np.uint32)
    return out[:2], out[2:]


class ServeTimeout(TimeoutError):
    """A typed round timeout: WHY the wait failed, not just that it did.

    Attributes:
      round_id: the round being waited on.
      quorum: the effective quorum at raise time (degradation included).
      base_quorum: the configured quorum.
      buffer_count: accepted updates currently buffered.
      decisions: total ingest-classification counters at raise time.
      reason: ``"deadline"`` (the caller's wait expired) or
        ``"watchdog"`` (the liveness watchdog declared the round stalled).
    """

    def __init__(self, message: str, *, round_id: int, quorum: int,
                 base_quorum: int, buffer_count: int,
                 decisions: Dict[str, int], reason: str = "deadline"):
        super().__init__(message)
        self.round_id = round_id
        self.quorum = quorum
        self.base_quorum = base_quorum
        self.buffer_count = buffer_count
        self.decisions = dict(decisions)
        self.reason = reason


class FaultBudgetExceeded(RuntimeError):
    """Protocol-faulty + declared-Byzantine clients exceed ``f`` — the
    (f, kappa)-robust aggregation guarantee no longer holds, so the
    server fails loudly instead of silently serving unguaranteed rounds."""

    def __init__(self, message: str, *, faulty: Tuple[int, ...], f: int):
        super().__init__(message)
        self.faulty = faulty
        self.f = f


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service-level knobs (the algorithm itself lives in
    ``AlgorithmConfig``).

    Attributes:
      quorum: distinct clients required to fire a round; ``None`` = all
        ``n_workers``. Must be at least ``2f + 1`` (validated loudly).
      timeout_s: wall-clock round deadline; after it, a round fires with
        whatever partial participation arrived (at least one update).
        ``0`` disables the clock — rounds fire on quorum only.
      staleness_window: accept updates up to this many rounds late.
      stale_policy: ``discount`` (late updates weighted ``beta^k``) or
        ``drop``.
      checkpoint_every: persist server state every k fired rounds
        (0 = never).
      checkpoint_dir: where checkpoints go (required if checkpointing).
      degrade_after: after this many CONSECUTIVE wall-clock-fired rounds,
        step the effective quorum down one client toward the ``2f + 1``
        floor (0 = degradation off).
      recover_after: after this many consecutive quorum-fired rounds at a
        degraded level, step the effective quorum back up one client
        toward the configured quorum.
      watchdog_s: liveness watchdog — a round open this long without
        firing records a stall event and turns ``announce``/``wait_round``
        into fast loud :class:`ServeTimeout`(reason="watchdog") failures
        instead of hangs (0 = watchdog off).
      fault_tolerance: consecutive corrupt frames (with no valid update in
        between) after which a client is classified protocol-faulty and
        counted against the Byzantine budget ``f``.
    """

    quorum: Optional[int] = None
    timeout_s: float = 0.0
    staleness_window: int = 0
    stale_policy: str = "discount"
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    degrade_after: int = 0
    recover_after: int = 2
    watchdog_s: float = 0.0
    fault_tolerance: int = 3


@dataclasses.dataclass(frozen=True)
class RoundResult:
    """What the batcher reports back for one fired round."""

    round_id: int
    n_updates: int
    fired_by: str
    client_ids: Tuple[int, ...]
    staleness: Tuple[int, ...]
    latency_s: float


class ByzantineRobustServer:
    """Streaming parameter server for one serveable algorithm config."""

    def __init__(self, cfg: alg.AlgorithmConfig, params0,
                 serve: Optional[ServeConfig] = None, *, seed: int = 0,
                 device: DeviceLike = None):
        # same loud rejection make_wire_fn/make_serve_apply_fn give
        alg._check_serveable(cfg.name)
        self.cfg = cfg
        self.serve = serve or ServeConfig()
        self.device = resolve_device(device)
        params0 = T.tree_map(lambda t: torch.as_tensor(t).to(self.device),
                             params0)
        self.spec = T.make_flat_spec(params0)
        self.d = self.spec.size
        self.n = cfg.n_workers
        # host-side staleness discount rate: the momentum coefficient (a
        # geometric decay also applied to the bankless DGD rules), numpy
        # float32 as in the reference (beta ** k underflows to 0.0)
        self._beta = np.float32(cfg.resolved_beta())
        self.params_flat = T.tree_ravel(params0, self.spec)
        # the serveable algorithms run the pruned StateLayout; the
        # adversary's memory lives client-side, so the server carries none
        self.server_state = alg.init_state(
            cfg, self.spec.padded_size, device=self.device)._replace(
                attack=None)
        self._key = seed_words(seed)
        self.agg_backend = (("cuda" if self.device.type == "cuda"
                             else "kernel-plain")
                            if cfg.aggregator.use_kernels else "plain")
        self._per_update_bytes = protocol.update_payload_bytes(cfg, self.d)
        # ONE aggregate-and-apply step, built on the first fire;
        # participation (present) and staleness (discount) are data over
        # fixed [n, D] shapes, so every participation level shares it
        self._apply_fn = None
        self.step_traces = 0

        self.metrics = ServeMetrics()
        self._buffer = RoundBuffer(
            n_clients=self.n, f=cfg.f, quorum=self.serve.quorum,
            timeout_s=self.serve.timeout_s,
            staleness_window=self.serve.staleness_window,
            stale_policy=self.serve.stale_policy)
        if self.serve.checkpoint_every and not self.serve.checkpoint_dir:
            raise ValueError("checkpoint_every > 0 needs a checkpoint_dir")

        self._queue: "queue.Queue[protocol.ClientUpdate]" = queue.Queue()
        self._cond = threading.Condition()
        self._results: Dict[int, RoundResult] = {}
        self._rounds_fired = 0
        self._round_id = 0
        self._ann: Optional[protocol.RoundAnnouncement] = None
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        # -- fault domain state -------------------------------------------
        # graceful quorum degradation counters
        self._consec_timeout = 0
        self._consec_quorum = 0
        # protocol-fault classification (transport-reported corruption)
        self._fault_counts: Dict[int, int] = {}
        self._protocol_faulty: set = set()
        self._fault_budget: Optional[FaultBudgetExceeded] = None
        # liveness watchdog: the round id whose stall is CURRENTLY declared
        # (cleared when updates start flowing again), and the last round an
        # event was recorded for (at most one event per round)
        self._watchdog_round: Optional[int] = None
        self._watchdog_fired_round = -1
        self._open_round(time.perf_counter())

    # -- round lifecycle (callers hold self._cond unless noted) ------------

    def _host_params(self) -> np.ndarray:
        """A host copy of the parameters (the device-to-host copy of the
        announcement; a copy on the CPU too, so the announcement never
        aliases the server's tensor)."""
        return self.params_flat.detach().to("cpu", copy=True).numpy()

    def step(self, params_flat: torch.Tensor, state: alg.ServerState,
             wire: torch.Tensor, present: torch.Tensor,
             discount: torch.Tensor):
        """One aggregate-and-apply step on device tensors: ``(new params,
        new ServerState)``. Built on its first call (``step_traces``)."""
        if self._apply_fn is None:
            self._apply_fn = alg.make_serve_apply_fn(
                self.cfg, G.make_aggregator(self.cfg.aggregator,
                                            device=self.device))
            self.step_traces += 1
        r, new_state = self._apply_fn(state, wire, present, discount)
        return alg.apply_direction(params_flat, r, self.cfg.gamma), new_state

    def _open_round(self, now: float, reopen_buffer: bool = True) -> None:
        """Open ``self._round_id``: advance the seed chain (carry split,
        then mask/attack split) and broadcast the announcement. The batcher
        passes ``reopen_buffer=False``: it already advanced the buffer at
        drain time, and re-opening here would wipe updates ingested while
        the apply ran."""
        self._key, round_words = split_words(self._key)
        mask_words, atk_words = split_words(round_words)
        self._ann = protocol.RoundAnnouncement(
            round_id=self._round_id, params=self._host_params(),
            mask_key=mask_words, atk_key=atk_words)
        if reopen_buffer:
            self._buffer.open(self._round_id, now,
                              mask_id=self._ann.mask_id)
        else:
            self._buffer.register_mask(self._round_id, self._ann.mask_id)
        # the liveness clock starts when the round is announced, not when
        # the buffer opened (the batcher opens the buffer BEFORE the apply,
        # which can include building the step)
        self._ann_open_t = now

    # -- public API --------------------------------------------------------

    def start(self) -> "ByzantineRobustServer":
        if self._threads:
            return self
        self._stop.clear()
        self._threads = [
            threading.Thread(target=self._ingest_loop, name="serve-ingest",
                             daemon=True),
            threading.Thread(target=self._batcher_loop, name="serve-batcher",
                             daemon=True),
        ]
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []

    def submit(self, update: protocol.ClientUpdate) -> None:
        """Enqueue one client update (thread-safe, non-blocking)."""
        values = np.asarray(update.values)
        if values.shape != (self.spec.padded_size,):
            raise ValueError(
                f"update values shape {values.shape} != "
                f"[padded_D={self.spec.padded_size}]")
        self._queue.put(update)
        if self._watchdog_round is not None:
            # an enqueued update is imminent progress: lift the stall
            # declaration so waiters wait for the (now likely) fire
            # instead of failing fast on a recovering round
            with self._cond:
                self._watchdog_round = None
                self._cond.notify_all()

    def _serve_timeout(self, message: str, round_id: int,
                       reason: str) -> ServeTimeout:
        """Build a typed timeout from the current buffer/quorum state
        (caller holds ``self._cond``)."""
        return ServeTimeout(
            message, round_id=round_id, quorum=self._buffer.quorum,
            base_quorum=self._buffer.base_quorum,
            buffer_count=self._buffer.count,
            decisions=self.metrics.decisions, reason=reason)

    def announce(self, timeout: float = 60.0,
                 min_round: int = 0) -> protocol.RoundAnnouncement:
        """The current round's broadcast (blocks through an in-flight
        apply until a round ``>= min_round`` is open)."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while (self._ann is None
                   or self._ann.round_id != self._round_id
                   or self._round_id < min_round):
                if self._watchdog_round == self._round_id:
                    raise self._serve_timeout(
                        f"round {self._round_id} stalled (liveness "
                        f"watchdog): {self._buffer.count}/"
                        f"{self._buffer.quorum} updates after "
                        f"{self.serve.watchdog_s}s",
                        self._round_id, reason="watchdog")
                rem = deadline - time.perf_counter()
                if rem <= 0 or not self._cond.wait(timeout=rem):
                    raise self._serve_timeout(
                        f"no open round announcement >= {min_round} "
                        f"within {timeout}s (open round {self._round_id}, "
                        f"{self._buffer.count}/{self._buffer.quorum} "
                        "buffered)", self._round_id, reason="deadline")
            return self._ann

    def wait_round(self, round_id: int, timeout: float = 60.0) -> RoundResult:
        """Block until ``round_id`` has fired and been applied.

        Raises :class:`ServeTimeout` (typed: round id, quorum state,
        buffer counts, reason) when the wait expires or the liveness
        watchdog has declared the round stalled, and
        :class:`FaultBudgetExceeded` once protocol-faulty + declared-
        Byzantine clients exceed the budget ``f``."""
        deadline = time.perf_counter() + timeout
        with self._cond:
            while round_id not in self._results:
                if self._fault_budget is not None:
                    raise self._fault_budget
                if self._watchdog_round is not None and \
                        round_id >= self._watchdog_round:
                    raise self._serve_timeout(
                        f"round {self._watchdog_round} stalled (liveness "
                        f"watchdog): {self._buffer.count}/"
                        f"{self._buffer.quorum} updates buffered after "
                        f"{self.serve.watchdog_s}s open",
                        self._watchdog_round, reason="watchdog")
                rem = deadline - time.perf_counter()
                if rem <= 0 or not self._cond.wait(timeout=rem):
                    raise self._serve_timeout(
                        f"round {round_id} did not fire within {timeout}s "
                        f"(buffer has {self._buffer.count}/"
                        f"{self._buffer.quorum} updates; with timeout_s=0 a "
                        "round below quorum never fires)",
                        round_id, reason="deadline")
            if self._fault_budget is not None:
                raise self._fault_budget
            return self._results[round_id]

    @property
    def round_id(self) -> int:
        with self._cond:
            return self._round_id

    @property
    def effective_quorum(self) -> int:
        """The current (possibly degraded) firing quorum."""
        with self._cond:
            return self._buffer.quorum

    # -- protocol-fault budget (called by the transport binding) -----------

    def note_protocol_fault(self, client_id: int) -> None:
        """A corrupt/bad-checksum frame arrived attributable to
        ``client_id``. Counted, never crashing: past ``fault_tolerance``
        consecutive corrupt frames the client is classified
        protocol-faulty and charged against the Byzantine budget ``f``."""
        if not 0 <= client_id < self.n:
            return
        with self._cond:
            self.metrics.observe_decision("bad_checksum",
                                          round_id=self._buffer.round_id)
            c = self._fault_counts.get(client_id, 0) + 1
            self._fault_counts[client_id] = c
            if (c >= self.serve.fault_tolerance
                    and client_id not in self._protocol_faulty):
                self._protocol_faulty.add(client_id)
                self._check_fault_budget()
            self._cond.notify_all()

    def note_protocol_ok(self, client_id: int) -> None:
        """A well-formed frame from ``client_id`` — its transport path
        delivers valid payloads again, so clear its protocol-fault state
        (transient corruption repaired by retransmission is not
        Byzantine behaviour)."""
        with self._cond:
            self._fault_counts.pop(client_id, None)
            self._protocol_faulty.discard(client_id)

    @property
    def protocol_faulty(self) -> Tuple[int, ...]:
        with self._cond:
            return tuple(sorted(self._protocol_faulty))

    def _check_fault_budget(self) -> None:
        """Caller holds ``self._cond``. Declared-Byzantine rows are
        ``[0, f)`` (the pool convention); the budget breaks when the union
        with protocol-faulty clients exceeds ``f``."""
        declared = set(range(self.cfg.f))
        implicated = declared | self._protocol_faulty
        if len(implicated) > self.cfg.f and self._fault_budget is None:
            faulty = tuple(sorted(self._protocol_faulty))
            self.metrics.observe_fault_budget(
                self._buffer.round_id, faulty, self.cfg.f, self.cfg.f)
            print(f"[serve] FAULT BUDGET EXCEEDED at round "
                  f"{self._buffer.round_id}: protocol-faulty clients "
                  f"{faulty} + {self.cfg.f} declared byzantine > f="
                  f"{self.cfg.f} — robustness guarantee void")
            self._fault_budget = FaultBudgetExceeded(
                f"protocol-faulty clients {faulty} + {self.cfg.f} "
                f"declared byzantine exceed the budget f={self.cfg.f}: "
                "the (f, kappa)-robust aggregation guarantee no longer "
                "covers this service", faulty=faulty, f=self.cfg.f)

    # -- checkpointing -----------------------------------------------------

    def _checkpoint_tree(self):
        """The persisted state: params + ServerState + seed chain, plus
        the open round's announcement words and the in-flight RoundBuffer
        rows (the mid-round recovery payload), in fixed ``[n, D]``/``[n]``
        slabs so a fresh server's tree restores them. A bfloat16 bank is
        saved as float32 (exact)."""
        n, P = self.n, self.spec.padded_size
        inflight_values = np.zeros((n, P), np.float32)
        inflight_present = np.zeros((n,), bool)
        inflight_round = np.full((n,), -1, np.int64)
        inflight_mask = np.zeros((n,), np.uint64)
        for cid, row in self._buffer.rows().items():
            inflight_values[cid] = row.update.values
            inflight_present[cid] = True
            inflight_round[cid] = row.update.round_id
            inflight_mask[cid] = np.uint64(row.update.mask_id)
        ann = self._ann
        none = np.zeros_like(self._key)
        return {"params_flat": self.params_flat,
                "momentum": self.server_state.momentum.float(),
                "step": np.int64(self.server_state.step),
                "key": self._key,
                "ann_round": np.int64(-1 if ann is None else ann.round_id),
                "ann_mask_key": none if ann is None else ann.mask_key,
                "ann_atk_key": none if ann is None else ann.atk_key,
                "inflight_values": inflight_values,
                "inflight_present": inflight_present,
                "inflight_round": inflight_round,
                "inflight_mask": inflight_mask}

    def save_checkpoint(self, path: Optional[str] = None) -> str:
        """Persist ``{params, ServerState, seed words}`` + the open round's
        announcement words + in-flight buffer rows via
        ``repro_torch.checkpoint``
        (callable any time the server is paused; the batcher calls it
        between rounds when ``checkpoint_every`` is set)."""
        from repro_torch.checkpoint import save
        with self._cond:
            # drain the ingest queue into the buffer first: those updates
            # were already ACKed "queued" to their clients, so a durable
            # snapshot must include them (otherwise a mid-round restore
            # silently loses acknowledged updates)
            now = time.perf_counter()
            while True:
                try:
                    u = self._queue.get_nowait()
                except queue.Empty:
                    break
                self.metrics.observe_decision(
                    self._buffer.add(u, now),
                    round_id=self._buffer.round_id)
            if path is None:
                path = os.path.join(self.serve.checkpoint_dir or ".",
                                    f"serve_round{self._round_id:06d}")
            return save(path, self._checkpoint_tree(),
                        metadata={"algo": self.cfg.name, "d": self.d,
                                  "n_workers": self.n},
                        step=self._round_id)

    def restore(self, path: str) -> int:
        """Load a checkpoint into this (not-yet-started) server and reopen
        its round. Returns the restored round id.

        Boundary checkpoints (the ``checkpoint_every`` path) restore the
        NEXT round by advancing the seed chain exactly like the live
        server. A checkpoint taken mid-round additionally carries the open
        round's announcement keys and the already-ingested buffer rows, so
        the restored server *resumes the interrupted round*: the identical
        announcement is re-broadcast (clients' in-flight updates still
        pass mask validation) and the saved rows are re-fed through the
        buffer's classification."""
        from repro_torch.checkpoint import latest_step, restore
        if self._threads:
            raise RuntimeError("restore() before start()")
        tree = restore(path, self._checkpoint_tree())
        tree = {k: (v if k in ("params_flat", "momentum") else v.numpy())
                for k, v in tree.items()}
        self.params_flat = tree["params_flat"]
        self.server_state = self.server_state._replace(
            momentum=tree["momentum"].to(self.server_state.momentum.dtype),
            step=int(tree["step"]))
        self._key = tree["key"].astype(np.uint32)
        step = latest_step(path)
        self._round_id = int(step) if step is not None else 0
        self._results = {}
        now = time.perf_counter()
        if int(tree["ann_round"]) == self._round_id:
            # mid-round checkpoint: the interrupted round's words were
            # already split off the chain: rebroadcast the SAME
            # announcement instead of splitting again
            self._ann = protocol.RoundAnnouncement(
                round_id=self._round_id, params=self._host_params(),
                mask_key=tree["ann_mask_key"].astype(np.uint32),
                atk_key=tree["ann_atk_key"].astype(np.uint32))
            self._buffer.open(self._round_id, now,
                              mask_id=self._ann.mask_id)
            self._ann_open_t = now
        else:
            self._open_round(now)
        # re-feed the in-flight rows through classification (stale rows
        # re-register their stored mask ids; current-round rows must match
        # the regenerated mask, identical by the chain's determinism)
        present = tree["inflight_present"]
        for cid in np.nonzero(present)[0]:
            cid = int(cid)
            rid = int(tree["inflight_round"][cid])
            mid = int(tree["inflight_mask"][cid])
            if rid < self._round_id:
                self._buffer.register_mask(rid, mid)
            u = protocol.ClientUpdate(
                client_id=cid, round_id=rid, mask_id=mid,
                values=tree["inflight_values"][cid],
                payload_bytes=self._per_update_bytes)
            self.metrics.observe_decision(self._buffer.add(u, now),
                                          round_id=self._round_id)
        return self._round_id

    # -- service loops -----------------------------------------------------

    def _ingest_loop(self) -> None:
        while not self._stop.is_set():
            try:
                u = self._queue.get(timeout=0.02)
            except queue.Empty:
                continue
            with self._cond:
                status = self._buffer.add(u, time.perf_counter())
                self.metrics.observe_decision(status,
                                              round_id=self._buffer.round_id)
                if (status in ("accepted", "replaced")
                        and self._watchdog_round == self._buffer.round_id):
                    # progress: updates are flowing again, so the round is
                    # no longer stalled — stop failing waiters fast (the
                    # recorded event resolves if/when the round fires)
                    self._watchdog_round = None
                self._cond.notify_all()

    def _watchdog_check(self, now: float) -> None:
        """Caller holds ``self._cond``: declare the open round stalled
        once it has been open past ``watchdog_s`` (at most once per
        round). Blocked waiters fail loudly instead of hanging."""
        wd = self.serve.watchdog_s
        if (wd > 0 and self._watchdog_round != self._round_id
                and self._watchdog_fired_round != self._round_id
                and now - self._ann_open_t >= wd):
            self._watchdog_round = self._round_id
            self._watchdog_fired_round = self._round_id
            open_s = now - self._ann_open_t
            self.metrics.observe_watchdog(
                self._round_id, open_s, self._buffer.count,
                self._buffer.quorum)
            print(f"[serve] WATCHDOG: round {self._round_id} stalled — "
                  f"{self._buffer.count}/{self._buffer.quorum} updates "
                  f"after {open_s:.2f}s open "
                  f"(timeout_s={self.serve.timeout_s})")
            self._cond.notify_all()

    def _adjust_quorum(self, fired_by: str, round_id: int) -> None:
        """Caller holds ``self._cond``. Graceful degradation: K
        consecutive wall-clock firings step the effective quorum down one
        client toward the 2f+1 floor; consecutive quorum firings at a
        degraded level step it back up toward the configured quorum."""
        if self.serve.degrade_after <= 0:
            return
        buf = self._buffer
        floor = max(2 * self.cfg.f + 1, 1)
        if fired_by == "timeout":
            self._consec_timeout += 1
            self._consec_quorum = 0
            if (self._consec_timeout >= self.serve.degrade_after
                    and buf.quorum > floor):
                old = buf.quorum
                buf.set_quorum(old - 1)
                self._consec_timeout = 0
                self.metrics.observe_quorum_transition(
                    round_id, old, buf.quorum, "degrade")
                print(f"[serve] quorum degraded {old} -> {buf.quorum} "
                      f"after {self.serve.degrade_after} consecutive "
                      f"timeout-fired rounds (floor 2f+1 = {floor})")
        else:
            self._consec_quorum += 1
            self._consec_timeout = 0
            if (self._consec_quorum >= self.serve.recover_after
                    and buf.quorum < buf.base_quorum):
                old = buf.quorum
                buf.set_quorum(old + 1)
                self._consec_quorum = 0
                self.metrics.observe_quorum_transition(
                    round_id, old, buf.quorum, "recover")
                print(f"[serve] quorum recovered {old} -> {buf.quorum} "
                      f"(configured {buf.base_quorum})")

    def _batcher_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                now = time.perf_counter()
                if not self._buffer.ready(now):
                    self._watchdog_check(now)
                    if self._buffer.timeout_s > 0:
                        wait = max(1e-3, min(
                            0.02, self._buffer.opened_at
                            + self._buffer.timeout_s - now))
                    else:
                        wait = 0.05
                    if self.serve.watchdog_s > 0:
                        wait = min(wait, max(1e-3, self._ann_open_t
                                             + self.serve.watchdog_s - now))
                    self._cond.wait(timeout=wait)
                    continue
                fired_by = self._buffer.fired_by()
                fired_quorum = self._buffer.quorum
                if self._watchdog_fired_round == self._round_id:
                    # the stalled round is firing after all: resolve it
                    self.metrics.resolve_watchdog(self._round_id)
                if self._watchdog_round == self._round_id:
                    self._watchdog_round = None
                rows = self._buffer.drain()
                opened_at = self._buffer.opened_at
                round_id = self._round_id
                self._adjust_quorum(fired_by, round_id)
                # advance the round *now* so updates arriving during the
                # apply are classified against the next round (stale for
                # this one); the next announcement follows after the apply
                self._round_id = round_id + 1
                for _, status in self._buffer.open(self._round_id, now):
                    self.metrics.observe_decision(status,
                                                  round_id=self._round_id)

            # build the padded step inputs + run the step OUTSIDE the lock
            # (ingest keeps draining while the device runs)
            wire = np.zeros((self.n, self.spec.padded_size), np.float32)
            present = np.zeros((self.n,), bool)
            discount = np.ones((self.n,), np.float32)
            for cid, row in rows.items():
                wire[cid] = row.update.values
                present[cid] = True
                discount[cid] = self._beta ** row.staleness
            t0 = time.perf_counter()
            dev = self.device
            new_params, new_state = self.step(
                self.params_flat, self.server_state,
                torch.from_numpy(wire).to(dev),
                torch.from_numpy(present).to(dev),
                torch.from_numpy(discount).to(dev))
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            t1 = time.perf_counter()

            with self._cond:
                self.params_flat = new_params
                self.server_state = new_state
                self._rounds_fired += 1
                cids = tuple(sorted(rows))
                stale = tuple(rows[c].staleness for c in cids)
                self._results[round_id] = RoundResult(
                    round_id=round_id, n_updates=len(rows),
                    fired_by=fired_by, client_ids=cids, staleness=stale,
                    latency_s=t1 - opened_at)
                self.metrics.observe_round(RoundRecord(
                    round_id=round_id, n_updates=len(rows),
                    fired_by=fired_by, staleness=stale,
                    latency_s=t1 - opened_at, step_s=t1 - t0,
                    payload_bytes=self._per_update_bytes * len(rows),
                    quorum=fired_quorum))
                if (self.serve.checkpoint_every
                        and self._rounds_fired
                        % self.serve.checkpoint_every == 0):
                    self.save_checkpoint()
                self._open_round(time.perf_counter(), reopen_buffer=False)
                self._cond.notify_all()


def run_service(server: ByzantineRobustServer, pool, rounds: int, *,
                round_timeout: float = 60.0,
                stop: bool = True) -> List[RoundResult]:
    """Drive ``rounds`` announce -> submit -> apply cycles with a simulated
    client pool (``repro_torch.serve.client.ClientPool``).

    The pool may tag updates for late delivery (stragglers); those are held
    host-side and submitted at the start of their delivery round, where the
    buffer's staleness policy takes over. With ``stop=False`` the server
    keeps running (e.g. to continue with a different pool behaviour against
    the same step).
    """
    server.start()
    t_start = time.perf_counter()
    pending: List[Tuple[int, protocol.ClientUpdate]] = []
    results: List[RoundResult] = []
    try:
        for _ in range(rounds):
            ann = server.announce(timeout=round_timeout)
            t = ann.round_id
            due = [u for dr, u in pending if dr <= t]
            pending = [(dr, u) for dr, u in pending if dr > t]
            for u in due:
                server.submit(u)
            for sched in pool.round_payloads(ann):
                if sched.drop:
                    continue
                if sched.deliver_round <= t:
                    server.submit(sched.update)
                else:
                    pending.append((sched.deliver_round, sched.update))
            results.append(server.wait_round(t, timeout=round_timeout))
    finally:
        server.metrics.span(t_start, time.perf_counter())
        if stop:
            server.stop()
    return results


def run_lockstep(server, pool, rounds: int, *, round_timeout: float = 60.0,
                 stop: bool = True) -> list:
    """Drive ``rounds`` announce -> submit -> apply cycles whose
    participation the pool's fates alone decide, not the wall clock.

    Each round it submits at most one update per client (its
    freshest due one the buffer accepts: within ``staleness_window``, fresh
    only under ``stale_policy='drop'``) and sets the buffer's quorum to
    their count, bypassing the ``2f + 1`` floor of :meth:`RoundBuffer.
    set_quorum`, so the round fires once all of them are in. Two servers
    driven so, with pools of the same behaviour, aggregate the same rows
    every round: the parity check under drops and staleness. Takes any
    server and pool with the reference's interface."""
    serve = server.serve
    server.start()
    t_start = time.perf_counter()
    pending: List[Tuple[int, object]] = []
    results = []
    try:
        for _ in range(rounds):
            ann = server.announce(timeout=round_timeout)
            t = ann.round_id
            due = [u for dr, u in pending if dr <= t]
            pending = [(dr, u) for dr, u in pending if dr > t]
            for sched in pool.round_payloads(ann):
                if sched.drop:
                    continue
                if sched.deliver_round <= t:
                    due.append(sched.update)
                else:
                    pending.append((sched.deliver_round, sched.update))
            best: Dict[int, object] = {}
            for u in due:
                late = t - u.round_id
                if late > serve.staleness_window or (
                        late > 0 and serve.stale_policy == "drop"):
                    continue
                prev = best.get(u.client_id)
                if prev is None or u.round_id > prev.round_id:
                    best[u.client_id] = u
            if not best:
                raise ValueError(f"round {t}: no update the buffer accepts "
                                 "(every client dropped or too late)")
            with server._cond:
                server._buffer.quorum = len(best)
            for cid in sorted(best):
                server.submit(best[cid])
            results.append(server.wait_round(t, timeout=round_timeout))
    finally:
        server.metrics.span(t_start, time.perf_counter())
        if stop:
            server.stop()
    return results
