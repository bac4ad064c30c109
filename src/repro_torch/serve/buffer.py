"""Round buffer: participation quorum, wall-clock timeout, staleness window
(counterpart of ``repro.serve.buffer``).

The buffer collects :class:`~repro_torch.serve.protocol.ClientUpdate`s for
the server's *current* round and decides when the aggregate-and-apply step
may fire:

* **quorum** — fire as soon as ``quorum`` distinct clients have an accepted
  update. A quorum below ``2f + 1`` raises loudly at construction: with
  fewer than ``2f + 1`` reports the ``f`` Byzantine rows can be a majority
  of the round and no (f, kappa)-robust rule retains its guarantee.
* **timeout** — with ``timeout_s > 0``, fire once the round has been open
  that long AND at least one update was accepted (partial participation);
  ``timeout_s == 0`` disables the clock — the round fires on quorum only.
* **staleness window** — a late update from round ``t - k`` is accepted
  while ``k <= staleness_window`` under ``stale_policy='discount'``
  (momentum-discounted by ``beta^k`` at apply time) and recorded with its
  staleness; under ``'drop'`` (or beyond the window) it is discarded. Per
  client only the freshest update is kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.protocol import ClientUpdate

#: Selectable late-update policies.
STALE_POLICIES = ("discount", "drop")


@dataclasses.dataclass
class BufferedUpdate:
    update: ClientUpdate
    staleness: int           # rounds late (0 = fresh for the current round)
    accepted_at: float


class RoundBuffer:
    """Accumulates one round's updates and decides when to fire."""

    def __init__(self, n_clients: int, f: int, quorum: Optional[int] = None,
                 timeout_s: float = 0.0, staleness_window: int = 0,
                 stale_policy: str = "discount"):
        quorum = n_clients if quorum is None else quorum
        if not 1 <= quorum <= n_clients:
            raise ValueError(
                f"quorum={quorum} outside [1, n_clients={n_clients}]")
        if quorum < 2 * f + 1:
            raise ValueError(
                f"quorum={quorum} < 2f+1 = {2 * f + 1}: with fewer than "
                f"2f+1 reports the f={f} byzantine clients can be a majority "
                "of a round and no (f, kappa)-robust aggregator retains its "
                "guarantee — raise the quorum or lower f")
        if stale_policy not in STALE_POLICIES:
            raise ValueError(
                f"unknown stale_policy {stale_policy!r} "
                f"(expected one of {STALE_POLICIES})")
        if staleness_window < 0:
            raise ValueError(f"staleness_window={staleness_window} < 0")
        if timeout_s < 0:
            raise ValueError(f"timeout_s={timeout_s} < 0")
        self.n_clients = n_clients
        self.f = f
        self.quorum = quorum
        #: the configured quorum; ``quorum`` itself is the EFFECTIVE one —
        #: graceful degradation may step it down toward the 2f+1 floor
        #: (never below) and back up, via :meth:`set_quorum`.
        self.base_quorum = quorum
        self.timeout_s = timeout_s
        self.staleness_window = staleness_window
        self.stale_policy = stale_policy
        self.round_id = 0
        self.opened_at = 0.0
        self.first_update_at: Optional[float] = None
        self._rows: Dict[int, BufferedUpdate] = {}
        self._future: List[ClientUpdate] = []
        # mask ids of recent rounds (round_id -> id), for validating that a
        # (possibly stale) update was built under its round's broadcast mask
        self._mask_ids: Dict[int, int] = {}

    # -- round lifecycle ---------------------------------------------------

    def open(self, round_id: int, now: float, mask_id: Optional[int] = None
             ) -> List[Tuple[ClientUpdate, str]]:
        """Open ``round_id``: clear the row bank, remember the round's mask
        id, and re-feed any updates that arrived early for it. Returns the
        ``(update, status)`` decisions for the re-fed updates."""
        self.round_id = round_id
        self.opened_at = now
        self.first_update_at = None
        self._rows = {}
        if mask_id is not None:
            self._mask_ids[round_id] = mask_id
            horizon = round_id - self.staleness_window - 1
            self._mask_ids = {r: m for r, m in self._mask_ids.items()
                              if r > horizon}
        pending, self._future = self._future, []
        return [(u, self.add(u, now)) for u in pending]

    def register_mask(self, round_id: int, mask_id: int) -> None:
        """Record ``round_id``'s broadcast mask id (when the announcement is
        built after the round was opened)."""
        self._mask_ids[round_id] = mask_id
        horizon = self.round_id - self.staleness_window - 1
        self._mask_ids = {r: m for r, m in self._mask_ids.items()
                          if r > horizon}

    def set_quorum(self, quorum: int) -> None:
        """Step the EFFECTIVE quorum (graceful degradation / recovery).
        The validated floor is ``2f + 1`` — stepping below it would void
        the robustness guarantee, so it raises exactly like construction."""
        if not 1 <= quorum <= self.n_clients:
            raise ValueError(
                f"quorum={quorum} outside [1, n_clients={self.n_clients}]")
        if quorum < 2 * self.f + 1:
            raise ValueError(
                f"quorum={quorum} < 2f+1 = {2 * self.f + 1}: the "
                "degradation floor is the robustness floor")
        self.quorum = quorum

    def rows(self) -> Dict[int, BufferedUpdate]:
        """The current (not-yet-drained) row bank — read-only view for
        mid-round checkpointing."""
        return dict(self._rows)

    # -- ingest ------------------------------------------------------------

    def add(self, update: ClientUpdate, now: float) -> str:
        """Classify + buffer one update. Returns the decision:
        ``accepted`` | ``replaced`` (fresher duplicate) | ``stale_dropped``
        | ``future`` | ``duplicate`` | ``bad_client`` | ``bad_mask``."""
        cid = update.client_id
        if not 0 <= cid < self.n_clients:
            return "bad_client"
        expect = self._mask_ids.get(update.round_id)
        if expect is not None and update.mask_id != expect:
            return "bad_mask"
        staleness = self.round_id - update.round_id
        if staleness < 0:
            self._future.append(update)
            return "future"
        if staleness > self.staleness_window or (
                staleness > 0 and self.stale_policy == "drop"):
            return "stale_dropped"
        prev = self._rows.get(cid)
        if prev is not None:
            if staleness >= prev.staleness:
                return "duplicate"
            self._rows[cid] = BufferedUpdate(update, staleness, now)
            return "replaced"
        if self.first_update_at is None:
            self.first_update_at = now
        self._rows[cid] = BufferedUpdate(update, staleness, now)
        return "accepted"

    # -- firing decision ---------------------------------------------------

    @property
    def count(self) -> int:
        return len(self._rows)

    def ready(self, now: float) -> bool:
        """Quorum reached, or (timeout enabled) the round has been open past
        the deadline with at least one accepted update."""
        if self.count >= self.quorum:
            return True
        return (self.timeout_s > 0 and self.count >= 1
                and now - self.opened_at >= self.timeout_s)

    def fired_by(self) -> str:
        return "quorum" if self.count >= self.quorum else "timeout"

    def drain(self) -> Dict[int, BufferedUpdate]:
        rows, self._rows = self._rows, {}
        return rows
