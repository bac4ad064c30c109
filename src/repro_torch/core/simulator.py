"""Paper-scale distributed-learning simulator (counterpart of
``repro.core.simulator``).

Simulates a server and n workers on one device: every round the workers
compute gradients on their local batches, the algorithm compresses, attacks
and aggregates, and the server updates the model. PyTorch runs eagerly, so a
trajectory is a Python loop over rounds (:meth:`Simulator.rollout`); per-round
metrics stay on the device until the caller reads them.
:meth:`Simulator.rollout_streaming` runs the same round body over chunks of
rounds from a prefetched ring buffer (``repro_torch.data.stream``), reads
one early-exit metric a chunk and stops at the first chunk boundary past
``tau``; :meth:`Simulator.rollout_with_snapshots` keeps the parameters after
listed rounds; :meth:`Simulator.run_per_round` is the reference's one round
at a time loop with its eval records and early stop.

A state whose parameters are ``[B, D]`` holds ``B`` lanes (the grid engine's
cells x seeds, ``repro_torch.core.sweep``): a round computes every lane's
per-worker gradients at once (``vmap`` over lanes of ``vmap`` over workers),
runs the lanes' server round (``algorithms.server_round`` on ``[B, n, D]``
with the lanes' :class:`~repro_torch.core.algorithms.ScenarioParams`) and
each lane's update with its own step size.
"""

from __future__ import annotations

import os
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as alg
from repro_torch.data import stream as DS
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.testing import GridDraws, TorchDraws
from repro_torch.utils import tree as T


class SimState(NamedTuple):
    params_flat: torch.Tensor  # [D], or [B, D] for lanes
    server: alg.ServerState
    draws: Any  # the draws provider (repro_torch.testing; GridDraws for lanes)


#: Sanity ceiling on the host-side bytes :func:`stack_batches` materialises
#: (2 GiB), as the reference's ``STACK_BYTES_LIMIT``. Override per call with
#: ``max_bytes=`` or with the ``REPRO_STACK_BYTES_LIMIT`` environment
#: variable (``0`` disables the check); past it, stream the batches
#: (:meth:`Simulator.rollout_streaming`).
STACK_BYTES_LIMIT = 2 * 1024 ** 3


def _stack_limit(max_bytes: Optional[int]) -> int:
    if max_bytes is not None:
        return max_bytes
    env = os.environ.get("REPRO_STACK_BYTES_LIMIT")
    return int(env) if env is not None else STACK_BYTES_LIMIT


def _batch_bytes(batch: Any) -> int:
    return int(sum(np.asarray(l).nbytes if not isinstance(l, torch.Tensor)
                   else l.numel() * l.element_size()
                   for l in T.tree_leaves(batch)))


def stack_batches(batch_fn: Callable[[int], Any], steps: int,
                  start: int = 0, max_bytes: Optional[int] = None) -> Any:
    """``batch_fn(start) .. batch_fn(start + steps - 1)`` stacked on a
    leading step axis, called in step order (a stateful ``batch_fn``
    reproduces the per-round stream). Raises ``ValueError`` when the
    estimated footprint exceeds the limit (``max_bytes``, else
    ``REPRO_STACK_BYTES_LIMIT``, else :data:`STACK_BYTES_LIMIT`; 0 disables
    the check), pointing at the streaming path."""
    limit = _stack_limit(max_bytes)
    per_step: List[Any] = []
    for i, t in enumerate(range(start, start + steps)):
        b = batch_fn(t)
        if i == 0 and limit:
            per = _batch_bytes(b)
            est = per * steps
            if est > limit:
                raise ValueError(
                    f"stack_batches would materialise ~{est / 1e9:.2f} GB "
                    f"host-side ({steps} steps x {per} bytes/step), over the "
                    f"{limit / 1e9:.2f} GB sanity limit. Stream the batches "
                    "instead — Simulator.rollout_streaming / "
                    "repro_torch.data.stream.ChunkPrefetcher hold only "
                    "O(prefetch_depth) chunks — or raise the limit via "
                    "max_bytes= / REPRO_STACK_BYTES_LIMIT (0 disables).")
        per_step.append(b)
    treedef = T.tree_flatten(per_step[0])[1]
    cols = zip(*(T.tree_leaves(b) for b in per_step))
    return T.tree_unflatten(treedef, [
        torch.stack(col) if isinstance(col[0], torch.Tensor)
        else np.stack(col) for col in cols])


def ensure_stacked(batches: Any, steps: Optional[int]) -> Any:
    """A rollout's ``batches``: a ``batch_fn`` callable materialised into a
    step-stacked tree, a stacked tree passed through."""
    if callable(batches):
        if steps is None:
            raise ValueError("steps is required when batches is callable")
        return stack_batches(batches, steps)
    return batches


def _chunk_source(batches: Any, steps: Optional[int], chunk_size: int,
                 prefetch_depth: int, device: torch.device):
    """The chunk source of a streamed rollout, with the number of rounds:
    ``(source, steps)``. A ``batch_fn`` callable streams through a
    ``ChunkPrefetcher`` (``steps`` required); a stacked ``[steps, ...]``
    tree is sliced chunk by chunk (``StackedChunkSource``). Either leaves
    the ``steps % chunk_size`` tail to :func:`_stream_tail`."""
    if chunk_size <= 0 or prefetch_depth <= 0:
        raise ValueError("chunk_size and prefetch_depth must be positive")
    if callable(batches):
        if steps is None:
            raise ValueError("steps is required when batches is callable")
        return DS.ChunkPrefetcher(batches, steps, chunk_size, prefetch_depth,
                                  device=device), steps
    n_avail = T.tree_leaves(batches)[0].shape[0]
    steps = n_avail if steps is None else min(steps, n_avail)
    return DS.StackedChunkSource(batches, steps, chunk_size,
                                 device=device), steps


def _stream_tail(batches: Any, steps: int, chunk_size: int) -> Any:
    """The last ``steps % chunk_size`` rounds' batches, stacked."""
    start = steps - steps % chunk_size
    if callable(batches):
        return stack_batches(batches, steps - start, start=start)
    return T.tree_map(lambda l: l[start:steps], batches)


def _concat_metrics(parts: Sequence[Dict[str, torch.Tensor]]
                    ) -> Dict[str, torch.Tensor]:
    parts = [p for p in parts if p]
    if not parts:
        return {}
    return {k: torch.cat([p[k] for p in parts], dim=-1) for k in parts[0]}


def _record(history: Dict[str, list], rec: Dict[str, float], t: int
            ) -> None:
    history["step"].append(t)
    for k, v in rec.items():
        history.setdefault(k, []).append(v)


def _stack_rounds(per_round: Sequence[Dict[str, torch.Tensor]]
                  ) -> Dict[str, torch.Tensor]:
    if not per_round:
        return {}
    return {k: torch.stack([m[k] for m in per_round], dim=-1)
            for k in per_round[0]}


class Simulator:
    """Single-device simulator of Byzantine-robust compressed training.

    Args:
      loss_fn: ``loss_fn(params, batch) -> scalar`` — per-worker local loss.
      params0: initial parameter tree (dict of tensors).
      cfg: algorithm configuration.
      eval_fn: optional ``eval_fn(params, eval_batch) -> metrics dict``.
      device: where everything runs (default the card; raises without CUDA
        unless ``device="cpu"``).
    """

    def __init__(self, loss_fn: Callable[[Any, Any], torch.Tensor],
                 params0: Any, cfg: alg.AlgorithmConfig,
                 eval_fn: Optional[Callable[[Any, Any], Dict]] = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.cfg = cfg
        self.eval_fn = eval_fn
        self.params0 = T.tree_map(lambda t: torch.as_tensor(t).to(self.device),
                                  params0)
        self.spec = T.make_flat_spec(self.params0)
        self.d = self.spec.size
        self.agg = alg.make_round_aggregator(cfg.aggregator,
                                             device=self.device)
        # per-worker (gradient, loss): params shared, batches mapped over
        # the leading worker axis; lanes map their own params over the same
        # batches
        self._grad_fn = torch.func.vmap(torch.func.grad_and_value(loss_fn),
                                        in_dims=(None, 0))
        self._lanes_grad_fn = torch.func.vmap(self._grad_fn,
                                              in_dims=(0, None))

    def init(self, seed: int = 0, draws: Any = None) -> SimState:
        """Fresh state. ``draws`` defaults to a ``TorchDraws(seed)`` on the
        simulator's device; parity tests pass a ``ReplayDraws``."""
        if draws is None:
            draws = TorchDraws(seed, self.device)
        return SimState(
            params_flat=T.tree_ravel(self.params0, self.spec),
            server=alg.init_state(self.cfg, self.spec.padded_size,
                                  device=self.device),
            draws=draws)

    def init_lanes(self, seeds: Sequence[int],
                   draws: Optional[Sequence[Any]] = None) -> SimState:
        """Fresh state of one lane per seed: lane ``s`` draws from
        ``TorchDraws(seeds[s])`` (or ``draws[s]``), as :meth:`init` would.
        ``repro_torch.core.sweep`` tiles it over the cells."""
        if not len(seeds):
            raise ValueError("seeds must be non-empty")
        if draws is None:
            draws = [TorchDraws(int(sd), self.device) for sd in seeds]
        if len(draws) != len(seeds):
            raise ValueError(f"{len(draws)} draws providers for "
                             f"{len(seeds)} seeds")
        flat = T.tree_ravel(self.params0, self.spec)
        return SimState(
            params_flat=flat.expand((len(seeds),) + flat.shape).clone(),
            server=alg.init_state(self.cfg, self.spec.padded_size,
                                  device=self.device, lanes=len(seeds)),
            draws=GridDraws(draws, range(len(seeds))))

    def params(self, state: SimState) -> Any:
        if state.params_flat.ndim == 2:
            return T.stacked_unravel(state.params_flat, self.spec)
        return T.tree_unravel(state.params_flat, self.spec)

    def _on_device(self, batch: Any) -> Any:
        return T.tree_map(lambda a: torch.as_tensor(a).to(self.device), batch)

    def round(self, state: SimState, worker_batches: Any,
              scenario: Optional[alg.ScenarioParams] = None
              ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        """One round: per-worker gradients, :func:`server_round`,
        :func:`apply_direction`. Metrics are device scalars (``[B]`` for
        lanes). ``scenario`` carries the lanes' (or one lane's) per-cell
        values; its ``gamma`` replaces ``cfg.gamma``."""
        if state.params_flat.ndim == 2:
            return self._lanes_round(state, worker_batches, scenario)
        params = T.tree_unravel(state.params_flat, self.spec)
        grad_tree, losses = self._grad_fn(params,
                                          self._on_device(worker_batches))
        grads = T.stacked_ravel(grad_tree, self.spec)
        r, server, _ = alg.server_round(self.cfg, state.server, grads,
                                        state.draws, agg=self.agg,
                                        scenario=scenario)
        gamma = self.cfg.gamma
        if scenario is not None and scenario.gamma is not None:
            gamma = float(torch.as_tensor(scenario.gamma).reshape(()))
        new_flat = alg.apply_direction(state.params_flat, r, gamma)
        f = self.cfg.f
        metrics = {
            "loss": losses[f:].mean(),  # honest mean loss
            "grad_norm": torch.linalg.vector_norm(grads[f:].mean(dim=0)),
            "dir_norm": torch.linalg.vector_norm(r),
        }
        return SimState(new_flat, server, state.draws), metrics

    def _lanes_round(self, state: SimState, worker_batches: Any,
                     scenario: Optional[alg.ScenarioParams]
                     ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        b = state.params_flat.shape[0]
        params = T.stacked_unravel(state.params_flat, self.spec)
        grad_tree, losses = self._lanes_grad_fn(
            params, self._on_device(worker_batches))
        grads = T.lanes_ravel(grad_tree, self.spec)
        r, server, _ = alg.server_round(self.cfg, state.server, grads,
                                        state.draws, agg=self.agg,
                                        scenario=scenario)
        gammas = ((self.cfg.gamma,) * b
                  if scenario is None or scenario.gamma is None
                  else G.host_values(scenario.gamma))
        groups = G.lane_groups(gammas, self.device)
        if len(groups) == 1:
            new_flat = alg.apply_direction(state.params_flat, r, gammas[0])
        else:
            new_flat = torch.empty_like(state.params_flat)
            for g, lanes, _ in groups:
                new_flat[lanes] = alg.apply_direction(
                    G.take(state.params_flat, lanes), G.take(r, lanes), g)
        f = self.cfg.f
        metrics = {
            "loss": losses[:, f:].mean(dim=-1),
            "grad_norm": torch.linalg.vector_norm(grads[:, f:].mean(dim=1),
                                                  dim=-1),
            "dir_norm": torch.linalg.vector_norm(r, dim=-1),
        }
        return SimState(new_flat, server, state.draws), metrics

    def rollout(self, state: SimState, batches: Any,
                steps: Optional[int] = None,
                scenario: Optional[alg.ScenarioParams] = None
                ) -> Tuple[SimState, Dict[str, torch.Tensor]]:
        """Run a trajectory. ``batches`` is a ``batch_fn(t)`` callable
        (``steps`` required) or a tree whose leaves carry a leading step
        axis. Returns ``(final_state, {metric: [steps] tensor})`` (``[B,
        steps]`` for lanes)."""
        if callable(batches):
            if steps is None:
                raise ValueError("steps is required when batches is callable")
            batch_at = batches
        else:
            n_avail = T.tree_leaves(batches)[0].shape[0]
            steps = n_avail if steps is None else steps
            if steps > n_avail:
                raise ValueError(f"{steps} steps but {n_avail} batches")
            batch_at = lambda t: T.tree_map(lambda l: l[t], batches)  # noqa: E731
        per_round: List[Dict[str, torch.Tensor]] = []
        for t in range(steps):
            state, m = self.round(state, batch_at(t), scenario)
            per_round.append(m)
        return state, _stack_rounds(per_round)

    def rollout_with_snapshots(self, state: SimState, batches: Any,
                               eval_rounds: Any,
                               steps: Optional[int] = None,
                               scenario: Optional[alg.ScenarioParams] = None
                               ) -> Tuple[SimState, Dict[str, torch.Tensor],
                                          torch.Tensor]:
        """:meth:`rollout` that also returns ``snaps``: ``params_flat``
        after each round of ``eval_rounds`` (strictly increasing round
        indices), ``[len(eval_rounds), D]`` (``[B, len, D]`` for lanes)."""
        batches = ensure_stacked(batches, steps)
        n_steps = T.tree_leaves(batches)[0].shape[0]
        rounds = np.asarray(eval_rounds, np.int64)
        if (rounds.ndim != 1 or np.any(np.diff(rounds) <= 0)
                or (rounds.size
                    and (rounds[0] < 0 or rounds[-1] >= n_steps))):
            # rows are taken in round order, so an unsorted or duplicated
            # schedule (or a wrapping negative index) would misalign them
            raise ValueError(
                "eval_rounds must be strictly increasing round indices in "
                f"[0, {n_steps}), got {rounds}")
        wanted = set(int(r) for r in rounds)
        per_round: List[Dict[str, torch.Tensor]] = []
        snaps: List[torch.Tensor] = []
        for t in range(n_steps):
            state, m = self.round(state, T.tree_map(lambda l: l[t], batches),
                                  scenario)
            per_round.append(m)
            if t in wanted:
                snaps.append(state.params_flat.clone())
        flat = state.params_flat
        out = (torch.stack(snaps, dim=-2) if snaps else flat.new_zeros(
            flat.shape[:-1] + (0, flat.shape[-1])))
        return state, _stack_rounds(per_round), out

    def _stream(self, state: SimState, source: Any, chunk_size: int,
                prefetch_depth: int,
                scenario: Optional[alg.ScenarioParams] = None,
                exit_check: Optional[Callable[[SimState, Dict], Tuple[
                    bool, float]]] = None):
        """Rounds over the chunks of ``source``, up to ``prefetch_depth``
        chunks a ``take``, each round :meth:`round`'s body. After each chunk
        ``exit_check(state, last_round_metrics) -> (hit, metric)`` (if
        given) may stop the run at that chunk boundary. Returns ``(state,
        per-round metrics, takes, hit, last metric or None)``."""
        per_round: List[Dict[str, torch.Tensor]] = []
        takes, hit, last = 0, False, None
        try:
            while not hit:
                chunks = source.take(prefetch_depth)
                if not chunks:
                    break
                takes += 1
                for chunk in chunks:
                    for i in range(chunk_size):
                        state, m = self.round(
                            state, T.tree_map(lambda l: l[i], chunk),
                            scenario)
                        per_round.append(m)
                    if exit_check is not None:
                        hit, last = exit_check(state, per_round[-1])
                        if hit:
                            break
        finally:
            source.close()
        return state, per_round, takes, hit, last

    def rollout_streaming(self, state: SimState, batches: Any,
                          steps: Optional[int] = None, *,
                          chunk_size: int = 32, prefetch_depth: int = 4,
                          tau: Optional[float] = None,
                          tau_metric: Optional[str] = None,
                          tau_mode: Optional[str] = None,
                          eval_batch: Any = None,
                          scenario: Optional[alg.ScenarioParams] = None
                          ) -> Tuple[SimState, Dict[str, torch.Tensor],
                                     Dict[str, Any]]:
        """Streamed trajectory with early exit at ``tau`` (the reference's
        ``rollout_streaming``).

        Chunks of ``chunk_size`` rounds come from a ``ChunkPrefetcher``
        (``batches`` a ``batch_fn``; ``steps`` required) or are sliced from
        a stacked ``[steps, ...]`` tree, up to ``prefetch_depth`` at a time,
        on the simulator's device; each round is :meth:`round`, so with
        ``tau=None`` the trajectory is bitwise :meth:`rollout`'s. Host
        residency is O(prefetch_depth * chunk_bytes) whatever the length.

        Early exit: after each chunk the metric is read once (one
        device-to-host copy a chunk): ``eval_fn(params,
        eval_batch)[tau_metric]`` when ``eval_batch`` is given (default
        ``'acc'``, mode ``'>='``), else the chunk's last per-round
        ``tau_metric`` (default ``'loss'``, mode ``'<='``), compared in
        float32 with ``tau``. The run stops at the first chunk boundary past
        the crossing; the rounds after it are never computed. The ``steps %
        chunk_size`` tail runs through :meth:`rollout` unless the run
        stopped. A lane state (``[B, D]``) streams only with ``tau=None``.

        Returns ``(state, metrics, info)``: ``metrics`` holds ``[rounds_run]``
        tensors (``[B, rounds_run]`` for lanes); ``info`` the reference's
        keys ``rounds_run``, ``early_exit``, ``last_metric``, ``tau``,
        ``tau_metric``, ``tau_mode``, ``dispatches`` (takes of up to
        ``prefetch_depth`` chunks), ``chunk_size``, ``prefetch_depth``,
        ``chunk_bytes``, ``host_high_water_bytes``,
        ``device_buffer_bytes``.
        """
        use_eval = (tau is not None and eval_batch is not None
                    and self.eval_fn is not None)
        metric = tau_metric or ("acc" if use_eval else "loss")
        mode = tau_mode or (">=" if use_eval else "<=")
        if mode not in (">=", "<="):
            raise ValueError(f"tau_mode must be '>=' or '<=', got {mode!r}")
        if tau is not None and state.params_flat.ndim != 1:
            raise ValueError("early exit at tau needs a single run; lanes "
                             "stream with tau=None")
        source, steps = _chunk_source(batches, steps, chunk_size,
                                     prefetch_depth, self.device)
        exit_check = None
        if tau is not None:
            # the reference compares its float32 metric with float32(tau)
            tau32 = float(np.float32(tau))
            eval_dev = self._on_device(eval_batch) if use_eval else None

            def exit_check(st: SimState, m: Dict[str, torch.Tensor]):
                if use_eval:
                    with torch.no_grad():
                        ev = self.eval_fn(self.params(st), eval_dev)[metric]
                else:
                    ev = m[metric]
                v = float(ev)
                return (v >= tau32 if mode == ">=" else v <= tau32), v

        state, per_round, takes, early, last = self._stream(
            state, source, chunk_size, prefetch_depth, scenario, exit_check)
        if last is None and per_round and state.params_flat.ndim == 1:
            last = float(per_round[-1][metric])
        parts = [_stack_rounds(per_round)]
        if steps % chunk_size and not early:
            state, tail = self.rollout(state, _stream_tail(batches, steps,
                                                          chunk_size),
                                       scenario=scenario)
            parts.append(tail)
        metrics = _concat_metrics(parts)
        rounds_run = (int(next(iter(metrics.values())).shape[-1])
                      if metrics else 0)
        info = {
            "rounds_run": rounds_run,
            "early_exit": early,
            "last_metric": float("nan") if last is None else last,
            "tau": tau,
            "tau_metric": metric,
            "tau_mode": mode,
            "dispatches": takes,
            "chunk_size": chunk_size,
            "prefetch_depth": prefetch_depth,
            "chunk_bytes": source.chunk_bytes,
            "host_high_water_bytes": source.high_water_bytes,
            "device_buffer_bytes": prefetch_depth * source.chunk_bytes,
        }
        return state, metrics, info

    def run(self, state: SimState, batch_fn: Callable[[int], Any],
            steps: int, eval_every: int = 0, eval_batch: Any = None,
            stop_fn: Optional[Callable[[Dict[str, float]], bool]] = None,
            ) -> Tuple[SimState, Dict[str, list]]:
        """Run ``steps`` rounds with eval records at rounds
        ``t % eval_every == 0`` and the last round, as the reference's
        ``Simulator.run``: every round runs, and ``stop_fn(record)``
        truncates the history at the first record where it fires (the
        returned state is the final round's)."""
        history: Dict[str, list] = {"step": [], "loss": [], "comm_bytes": []}
        per_round_bytes = self.payload_bytes_per_round()
        stopped = False
        for t in range(steps):
            state, m = self.round(state, batch_fn(t))
            if stopped or not eval_every:
                continue
            if t % eval_every == 0 or t == steps - 1:
                rec = self._eval_record(state, m, t, per_round_bytes,
                                        eval_batch)
                _record(history, rec, t)
                if stop_fn is not None and stop_fn(rec):
                    stopped = True
        return state, history

    def _eval_record(self, state: SimState, m: Dict[str, torch.Tensor],
                     t: int, per_round: int, eval_batch: Any
                     ) -> Dict[str, float]:
        rec = {k: float(v) for k, v in m.items()}
        rec["comm_bytes"] = per_round * (t + 1)
        if self.eval_fn is not None and eval_batch is not None:
            with torch.no_grad():
                em = self.eval_fn(self.params(state),
                                  self._on_device(eval_batch))
            rec.update({k: float(v) for k, v in em.items()})
        return rec

    def run_per_round(self, state: SimState, batch_fn: Callable[[int], Any],
                      steps: int, eval_every: int = 0, eval_batch: Any = None,
                      stop_fn: Optional[Callable[[Dict[str, float]], bool]]
                      = None) -> Tuple[SimState, Dict[str, list]]:
        """The reference's one-round-at-a-time loop: eval records at rounds
        ``t % eval_every == 0`` and the last round, and the run stops at the
        first record where ``stop_fn(record)`` fires (the returned state is
        that round's)."""
        history: Dict[str, list] = {"step": [], "loss": [], "comm_bytes": []}
        per_round = self.payload_bytes_per_round()
        for t in range(steps):
            state, m = self.round(state, batch_fn(t))
            if eval_every and (t % eval_every == 0 or t == steps - 1):
                rec = self._eval_record(state, m, t, per_round, eval_batch)
                _record(history, rec, t)
                if stop_fn is not None and stop_fn(rec):
                    break
        return state, history

    def server_state_bytes(self) -> int:
        """Bytes of the server banks under the resolved layout."""
        return alg.server_state_bytes(self.cfg, self.spec.padded_size)

    def payload_bytes_per_round(self) -> int:
        """Total uplink bytes per round over all n workers."""
        return alg.algo_payload_bytes(self.cfg, self.d,
                                      bytes_per_value=4) * self.cfg.n_workers
