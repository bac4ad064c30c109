"""Paper-scale distributed-learning simulator (counterpart of
``repro.core.simulator``).

Simulates a server and n workers on one device: every round the workers
compute gradients on their local batches, the algorithm compresses, attacks
and aggregates, and the server updates the model. PyTorch runs eagerly, so a
trajectory is a Python loop over rounds (:meth:`Simulator.rollout`); per-round
metrics stay on the device until the caller reads them.

A state whose parameters are ``[B, D]`` holds ``B`` lanes (the grid engine's
cells x seeds, ``repro_torch.core.sweep``): a round computes every lane's
per-worker gradients at once (``vmap`` over lanes of ``vmap`` over workers),
runs the lanes' server round (``algorithms.server_round`` on ``[B, n, D]``
with the lanes' :class:`~repro_torch.core.algorithms.ScenarioParams`) and
each lane's update with its own step size.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as alg
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.testing import GridDraws, TorchDraws
from repro_torch.utils import tree as T


class SimState(NamedTuple):
    params_flat: torch.Tensor  # [D], or [B, D] for lanes
    server: alg.ServerState
    draws: Any  # the draws provider (repro_torch.testing; GridDraws for lanes)


#: Sanity ceiling on the host-side bytes :func:`stack_batches` materialises
#: (2 GiB), as the reference's ``STACK_BYTES_LIMIT``.
STACK_BYTES_LIMIT = 2 * 1024 ** 3


def _batch_bytes(batch: Any) -> int:
    return int(sum(np.asarray(l).nbytes if not isinstance(l, torch.Tensor)
                   else l.numel() * l.element_size()
                   for l in T.tree_leaves(batch)))


def stack_batches(batch_fn: Callable[[int], Any], steps: int,
                  start: int = 0, max_bytes: Optional[int] = None) -> Any:
    """``batch_fn(start) .. batch_fn(start + steps - 1)`` stacked on a
    leading step axis, called in step order (a stateful ``batch_fn``
    reproduces the per-round stream). Raises ``ValueError`` when the
    estimated footprint exceeds ``max_bytes`` (default
    :data:`STACK_BYTES_LIMIT`; 0 disables the check)."""
    limit = STACK_BYTES_LIMIT if max_bytes is None else max_bytes
    per_step: List[Any] = []
    for i, t in enumerate(range(start, start + steps)):
        b = batch_fn(t)
        if i == 0 and limit:
            est = _batch_bytes(b) * steps
            if est > limit:
                raise ValueError(
                    f"stack_batches would materialise ~{est / 1e9:.2f} GB "
                    f"({steps} steps), over the {limit / 1e9:.2f} GB sanity "
                    "limit: pass a batch_fn to the rollout instead")
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
        if not per_round:
            return state, {}
        return state, {k: torch.stack([m[k] for m in per_round], dim=-1)
                       for k in per_round[0]}

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
                rec = {k: float(v) for k, v in m.items()}
                rec["comm_bytes"] = per_round_bytes * (t + 1)
                if self.eval_fn is not None and eval_batch is not None:
                    with torch.no_grad():
                        em = self.eval_fn(self.params(state),
                                          self._on_device(eval_batch))
                    rec.update({k: float(v) for k, v in em.items()})
                history["step"].append(t)
                for k, v in rec.items():
                    history.setdefault(k, []).append(v)
                if stop_fn is not None and stop_fn(rec):
                    stopped = True
        return state, history

    def server_state_bytes(self) -> int:
        """Bytes of the server banks under the resolved layout."""
        return alg.server_state_bytes(self.cfg, self.spec.padded_size)

    def payload_bytes_per_round(self) -> int:
        """Total uplink bytes per round over all n workers."""
        return alg.algo_payload_bytes(self.cfg, self.d,
                                      bytes_per_value=4) * self.cfg.n_workers
