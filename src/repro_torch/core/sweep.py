"""Experiment grids: plan and execute over an explicit lane axis
(counterpart of ``repro.core.sweep``).

The paper's Fig. 1 and Table 1 are attack x aggregator x algorithm x seed
grids. Two stages, as in the reference:

* **plan** (:func:`plan_grid`): partition the scenarios into maximal fusible
  banks. Every cell whose attack has an attack-bank branch
  (``repro_torch.adversary.bank_entry``) joins a bank whose attack, rule
  (+/- NNM), algorithm (with beta, dasha's ``a`` and the step size) and,
  for ``compression.TRACED_RATIO_KINDS``, keep-ratio are per-lane values
  (``algorithms.ScenarioParams``). ``none`` attacks and singleton groups
  stay singles. ``cross_algo=False`` keeps one bank per algorithm.
* **execute** (:func:`execute_plan`, :func:`fused_grid_rollout`): a bank
  runs as ``B = n_cells * n_seeds`` lanes of one ``Simulator``, cell-major
  (lane ``c * n_seeds + s`` is cell ``c``, seed ``s``), a Python loop over
  rounds in which each round groups the lanes by branch and runs each
  branch once on its lanes: the pairdist, CWTM and median kernels launch
  once a round whatever ``B``. Eval is one call over the lanes
  (:func:`fused_grid_eval`). A single runs its seeds as the lanes of its
  own simulator (:func:`rollout_over_seeds`). With ``streaming=True`` the
  rounds' batches come chunk by chunk from a prefetched ring buffer
  (:func:`fused_grid_rollout_streaming`, :func:`rollout_over_seeds_streaming`:
  ``Simulator.rollout_streaming`` over the lanes), bitwise the materialised
  run, with O(prefetch_depth) chunks on the host.

With a measured :class:`~repro_torch.core.costmodel.CostModel` the plan
keeps a multi-algorithm bank fused only where the model predicts it is no
slower than the per-algorithm partition. Early stopping of a grid is
post-hoc (:func:`bytes_to_threshold`).

CLI::

    PYTHONPATH=src python -m repro_torch.core.sweep --scenario table1-mini \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.core.sweep --list-scenarios
    PYTHONPATH=src python -m repro_torch.core.sweep \
        --scenario transformer-table1 --stream --stream-chunk 4 \
        --prefetch-depth 2 --seeds 1 --steps 8 --device cpu

The reference's device sharding has no meaning on one card (``--shard`` is
accepted and does nothing).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregators as G
from repro_torch.core import algorithms as alg
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.core.costmodel import CostModel
from repro_torch.core.simulator import (SimState, Simulator, ensure_stacked,
                                        stack_batches)
from repro_torch.device import resolve_device
from repro_torch.testing import GridDraws
from repro_torch.utils import tree as T


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One labelled grid cell: a full algorithm configuration."""

    label: str
    cfg: alg.AlgorithmConfig


#: Algorithms the grid runner can build (the algorithm bank's branches).
KNOWN_ALGORITHMS: Tuple[str, ...] = alg.ALGO_BANK


def _validate_grid_names(algos: Sequence[str], attacks: Sequence[str],
                         aggregators: Sequence[str]) -> None:
    """Fail fast on unknown names, listing everything known."""
    from repro_torch.adversary import core as adv
    for a in algos:
        if a not in KNOWN_ALGORITHMS:
            raise ValueError(
                f"unknown algorithm: {a!r} (expected one of "
                f"{'|'.join(KNOWN_ALGORITHMS)})")
    for a in attacks:
        if a not in adv.KNOWN_ATTACKS:
            raise ValueError(
                f"unknown attack: {a!r} (expected one of "
                f"{'|'.join(adv.KNOWN_ATTACKS)})")
    for a in aggregators:
        if a not in G.BANK_NAMES:
            raise ValueError(
                f"unknown aggregator: {a!r} (expected one of "
                f"{'|'.join(G.BANK_NAMES)})")


def grid_scenarios(algos: Sequence[str] = ("rosdhb",),
                   attacks: Sequence[str] = ("alie",),
                   aggregators: Sequence[str] = ("cwtm",),
                   *, n_honest: int = 10, f: int = 3, ratio: float = 0.1,
                   gamma: float = 0.05, beta: float = 0.9,
                   pre_nnm: bool = True, local: bool = False,
                   alie_z: Optional[float] = 1.5,
                   use_kernels: bool = True) -> List[Scenario]:
    """The attack x aggregator x algorithm product as scenarios (the
    reference's ``grid_scenarios``). ``f`` is fixed across the grid; ``dgd``
    pairs with the plain mean whatever ``aggregators`` (emitted once); one
    sparsifier (exact RandK) is shared by every algorithm so the whole
    product fuses into one cross-algorithm bank. ``use_kernels`` selects the
    aggregation kernels for every cell (the reference's ``use_pallas``)."""
    _validate_grid_names(algos, attacks, aggregators)
    out = []
    seen_labels = set()
    sparsifier = C.SparsifierConfig(kind="randk", ratio=ratio, local=local)
    for algo, attack, agg in itertools.product(algos, attacks, aggregators):
        aggregator = (G.AggregatorConfig(name="mean", f=max(f, 1),
                                         use_kernels=use_kernels)
                      if algo == "dgd"
                      else G.AggregatorConfig(name=agg, f=max(f, 1),
                                              pre_nnm=pre_nnm,
                                              use_kernels=use_kernels))
        cfg = alg.AlgorithmConfig(
            name=algo, n_workers=n_honest + f, f=f, gamma=gamma, beta=beta,
            sparsifier=sparsifier, aggregator=aggregator,
            attack=A.AttackConfig(name=attack,
                                  z=alie_z if attack == "alie" else None))
        label = f"{algo}/{attack}/{aggregator.name}"
        if label in seen_labels:
            continue
        seen_labels.add(label)
        out.append(Scenario(label=label, cfg=cfg))
    return out


# --------------------------------------------------------------------------
# Rollouts over lanes
# --------------------------------------------------------------------------


def _tree_lanes(tree: Any, fn: Callable[[torch.Tensor], torch.Tensor]) -> Any:
    """``fn`` on every lane tensor of a state (server state, attack state);
    the shared round counter and the draws stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None or isinstance(tree, (int, float, GridDraws)):
        return tree
    return type(tree)(*(_tree_lanes(t, fn) for t in tree))


def init_states(sim: Simulator, seeds: Sequence[int],
                draws: Optional[Sequence[Any]] = None) -> SimState:
    """One lane per seed (``Simulator.init_lanes``)."""
    return sim.init_lanes(seeds, draws)


def rollout_over_seeds(sim: Simulator, seeds: Sequence[int], batches: Any,
                       steps: Optional[int] = None,
                       draws: Optional[Sequence[Any]] = None
                       ) -> Tuple[SimState, dict]:
    """Every seed of one scenario, as lanes of one rollout; the batches are
    shared across seeds (seeds differ in their draws). Returns the final
    state and metrics with a leading seed axis (``[n_seeds, steps]``)."""
    batches = ensure_stacked(batches, steps)
    return sim.rollout(init_states(sim, seeds, draws), batches)


def rollout_over_seeds_streaming(sim: Simulator, seeds: Sequence[int],
                                 batches: Any, steps: Optional[int] = None,
                                 *, chunk_size: int = 32,
                                 prefetch_depth: int = 4,
                                 draws: Optional[Sequence[Any]] = None
                                 ) -> Tuple[SimState, dict]:
    """:func:`rollout_over_seeds` fed chunk by chunk from a prefetched ring
    buffer (``Simulator.rollout_streaming``, no early exit): bitwise the
    materialised run. A callable ``batches`` must be a pure function of the
    round index (it is streamed anew for each bank and single)."""
    state, metrics, _ = sim.rollout_streaming(
        init_states(sim, seeds, draws), batches, steps,
        chunk_size=chunk_size, prefetch_depth=prefetch_depth)
    return state, metrics


def _cell_axis(params: alg.ScenarioParams) -> int:
    present = [torch.as_tensor(v) for v in params if v is not None]
    if not present:
        raise ValueError("ScenarioParams has no per-cell components")
    if any(v.ndim == 0 for v in present):
        raise ValueError("every ScenarioParams component needs a leading "
                         "[n_cells] axis (got a scalar)")
    lead = [len(v) for v in present]
    if len(set(lead)) != 1:
        raise ValueError(f"inconsistent ScenarioParams cell axes: {lead}")
    return lead[0]


def grid_lanes(sim: Simulator, params: alg.ScenarioParams,
               seeds: Sequence[int], draws: Optional[Sequence[Any]] = None
               ) -> Tuple[SimState, alg.ScenarioParams]:
    """The initial state and the per-lane :class:`ScenarioParams` of a
    cells x seeds grid: ``params`` per cell repeated over the seeds, the
    seeds' lanes (``Simulator.init_lanes``) tiled over the cells, cell-major
    (lane ``c * n_s + s`` = cell ``c``, seed ``s``)."""
    n_c, n_s = _cell_axis(params), len(seeds)
    base = sim.init_lanes(seeds, draws)
    state = SimState(
        params_flat=base.params_flat.repeat(n_c, 1),
        server=_tree_lanes(base.server,
                           lambda t: t.repeat((n_c,) + (1,) * (t.ndim - 1))),
        draws=GridDraws(base.draws.providers,
                        [s for _ in range(n_c) for s in range(n_s)]))
    lanes = alg.ScenarioParams(*(
        None if v is None else torch.repeat_interleave(
            torch.as_tensor(v), n_s, dim=0) for v in params))
    return state, lanes


def with_kernels(scenarios: Sequence[Scenario], use_kernels: bool
                 ) -> List[Scenario]:
    """The scenarios with their aggregation on the kernels or the plain
    rules (``AggregatorConfig.use_kernels``)."""
    return [dataclasses.replace(sc, cfg=dataclasses.replace(
        sc.cfg, aggregator=dataclasses.replace(sc.cfg.aggregator,
                                               use_kernels=use_kernels)))
            for sc in scenarios]


def fused_grid_rollout(sim: Simulator, params: alg.ScenarioParams,
                       seeds: Sequence[int], batches: Any,
                       steps: Optional[int] = None, *,
                       shard: bool = True,
                       devices: Optional[Sequence[Any]] = None,
                       draws: Optional[Sequence[Any]] = None
                       ) -> Tuple[SimState, dict]:
    """Run a cells x seeds grid as ``n_cells * n_seeds`` lanes of one
    rollout. ``params`` carries a leading ``[n_cells]`` axis on each present
    component; lanes are cell-major (lane ``c * n_s + s`` = cell ``c``, seed
    ``s``) and every lane of seed ``s`` reads seed ``s``'s draws
    (``draws[s]``, default ``TorchDraws(seeds[s])``). ``shard`` and
    ``devices`` are accepted for the reference's signature: one card has
    nothing to shard over.

    Returns ``(final_state, metrics)``: ``params_flat`` ``[n_cells, n_seeds,
    D]`` and metrics ``[n_cells, n_seeds, steps]``; the server state keeps
    its flat lane axis.
    """
    del shard, devices
    batches = ensure_stacked(batches, steps)
    n_c, n_s = _cell_axis(params), len(seeds)
    state, lanes = grid_lanes(sim, params, seeds, draws)
    return _by_cell(*sim.rollout(state, batches, scenario=lanes), n_c, n_s)


def _by_cell(out: SimState, metrics: dict, n_c: int, n_s: int
             ) -> Tuple[SimState, dict]:
    """A grid's lane axis split into ``[n_cells, n_seeds]`` (parameters and
    metrics; the server state keeps its flat lane axis)."""
    cells = lambda t: t.reshape((n_c, n_s) + t.shape[1:])  # noqa: E731
    return (out._replace(params_flat=cells(out.params_flat)),
            {k: cells(v) for k, v in metrics.items()})


def fused_grid_rollout_streaming(sim: Simulator,
                                 params: alg.ScenarioParams,
                                 seeds: Sequence[int], batches: Any,
                                 steps: Optional[int] = None, *,
                                 chunk_size: int = 32,
                                 prefetch_depth: int = 4,
                                 shard: bool = True,
                                 devices: Optional[Sequence[Any]] = None,
                                 draws: Optional[Sequence[Any]] = None
                                 ) -> Tuple[SimState, dict]:
    """:func:`fused_grid_rollout` fed chunk by chunk from a prefetched ring
    buffer: the same lanes, the same round, bitwise the same trajectories;
    the host never holds the ``[steps, ...]`` batch schedule. No early exit
    (grid tables need whole trajectories: :func:`bytes_to_threshold` stays
    the grid's protocol)."""
    del shard, devices
    n_c, n_s = _cell_axis(params), len(seeds)
    state, lanes = grid_lanes(sim, params, seeds, draws)
    out, metrics, _ = sim.rollout_streaming(
        state, batches, steps, chunk_size=chunk_size,
        prefetch_depth=prefetch_depth, scenario=lanes)
    return _by_cell(out, metrics, n_c, n_s)


def fused_attack_rollout(sim: Simulator,
                         attack_cfgs: Sequence[A.AttackConfig],
                         seeds: Sequence[int], batches: Any,
                         steps: Optional[int] = None,
                         draws: Optional[Sequence[Any]] = None
                         ) -> Tuple[SimState, dict]:
    """An attacks x seeds grid of the mean/std linear family
    (``attacks.linear_coeffs``) as lanes of one rollout; ``sim`` is built
    with ``attack=AttackConfig(name="linear")``. Returns leading
    ``[n_attacks, n_seeds]`` axes."""
    if sim.cfg.attack.name != "linear":
        raise ValueError("fused_attack_rollout needs a simulator built with "
                         "AttackConfig(name='linear')")
    n, f = sim.cfg.n_workers, sim.cfg.f
    coeffs = []
    for a in attack_cfgs:
        c = A.linear_coeffs(a, n, f)
        if c is None:
            raise ValueError(f"attack {a.name!r} is outside the linear "
                             "family; run it as its own scenario")
        coeffs.append(c)
    params = alg.ScenarioParams(
        attack_coeffs=torch.tensor(coeffs, dtype=torch.float32))
    return fused_grid_rollout(sim, params, seeds, batches, steps,
                              draws=draws)


# --------------------------------------------------------------------------
# Plan: partition a scenario grid into maximal fusible banks
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FusedBank:
    """One maximal fusible group: ``n_cells`` scenarios run as lanes of one
    ``Simulator``, their differences carried as :class:`ScenarioParams`.

    ``cfg`` is the executable bank configuration: ``attack='bank'`` and
    ``aggregator.name='bank'`` restricted to the branches the group uses;
    cross-algorithm banks also set ``cfg.name='bank'`` and carry per-cell
    ``algo_idx`` / ``hparams`` / ``gammas``.
    """

    cfg: alg.AlgorithmConfig
    scenarios: Tuple[Scenario, ...]
    coeffs: Tuple[Tuple[float, float], ...]
    attack_idx: Tuple[int, ...]
    agg_idx: Tuple[int, ...]
    ratios: Optional[Tuple[float, ...]]  # None -> ratio stays static config
    algo_idx: Optional[Tuple[int, ...]] = None
    #: per-cell (beta, mvr_a, 1-beta, 1-mvr_a) — see algorithms.static_hparams
    hparams: Optional[Tuple[Tuple[float, float, float, float], ...]] = None
    gammas: Optional[Tuple[float, ...]] = None

    @property
    def n_cells(self) -> int:
        return len(self.scenarios)

    def scenario_params(self) -> alg.ScenarioParams:
        """The per-cell values on a leading cell axis (host tensors)."""
        f32 = lambda v: (None if v is None  # noqa: E731
                         else torch.tensor(v, dtype=torch.float32))
        i32 = lambda v: (None if v is None  # noqa: E731
                         else torch.tensor(v, dtype=torch.int32))
        return alg.ScenarioParams(
            attack_coeffs=f32(self.coeffs), attack_idx=i32(self.attack_idx),
            agg_idx=i32(self.agg_idx), ratio=f32(self.ratios),
            algo_idx=i32(self.algo_idx), hparams=f32(self.hparams),
            gamma=f32(self.gammas))


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Execution plan for a scenario grid: fusible banks + leftovers."""

    banks: Tuple[FusedBank, ...]
    singles: Tuple[Scenario, ...]
    notes: Tuple[str, ...] = ()

    @property
    def n_cells(self) -> int:
        return sum(b.n_cells for b in self.banks) + len(self.singles)

    @property
    def n_programs(self) -> int:
        return len(self.banks) + len(self.singles)

    def describe(self) -> str:
        parts = [f"{self.n_cells} scenarios -> {self.n_programs} programs"]
        for b in self.banks:
            name = ("+".join(b.cfg.bank or alg.ALGO_BANK)
                    if b.cfg.name == "bank" else b.cfg.name)
            layout = b.cfg.resolved_state_layout()
            parts.append(
                f"  bank[{name}] x{b.n_cells}"
                + ("" if layout.is_full else " [pruned carry]") + ": "
                + ", ".join(sc.label for sc in b.scenarios))
        for sc in self.singles:
            parts.append(f"  single: {sc.label}")
        for note in self.notes:
            parts.append(f"  note: {note}")
        return "\n".join(parts)


_GroupEntry = Tuple[Scenario, Tuple[str, Tuple[float, float]]]


def _build_bank(group: Sequence[_GroupEntry], *,
                cross_algo: bool) -> FusedBank:
    """One :class:`FusedBank` from grouped (scenario, attack-entry) pairs
    that share a fusion key; dasha-free groups get the pruned
    ``StateLayout``."""
    entries: List[Tuple[str, bool]] = []
    attack_entries: List[str] = []
    algos: List[str] = []
    for sc, (branch, _) in group:
        a = sc.cfg.aggregator
        e = (a.name, bool(a.pre_nnm) and a.name != "mean")
        if e not in entries:
            entries.append(e)
        if branch not in attack_entries:
            attack_entries.append(branch)
        if sc.cfg.name not in algos:
            algos.append(sc.cfg.name)
    bank_agg = dataclasses.replace(
        group[0][0].cfg.aggregator, name="bank", pre_nnm=False,
        bank=tuple(entries))
    bank_attack = A.AttackConfig(name="bank", bank=tuple(attack_entries))
    ratios = tuple(sc.cfg.sparsifier.ratio for sc, _ in group)
    trace_ratio = (group[0][0].cfg.sparsifier.kind
                   in C.TRACED_RATIO_KINDS and len(set(ratios)) > 1)
    exec_cfg = dataclasses.replace(
        group[0][0].cfg, attack=bank_attack, aggregator=bank_agg)
    if cross_algo:
        exec_cfg = dataclasses.replace(exec_cfg, name="bank",
                                       bank=tuple(algos))
    if exec_cfg.state_layout is None:
        exec_cfg = dataclasses.replace(
            exec_cfg,
            state_layout=alg.StateLayout.for_algorithms(
                exec_cfg.algorithms()))
    return FusedBank(
        cfg=exec_cfg,
        scenarios=tuple(sc for sc, _ in group),
        coeffs=tuple(c for _, (_, c) in group),
        attack_idx=tuple(attack_entries.index(b) for _, (b, _) in group),
        agg_idx=tuple(G.bank_index(sc.cfg.aggregator, tuple(entries))
                      for sc, _ in group),
        ratios=ratios if trace_ratio else None,
        algo_idx=(tuple(algos.index(sc.cfg.name) for sc, _ in group)
                  if cross_algo else None),
        hparams=(tuple(alg.static_hparams(sc.cfg) for sc, _ in group)
                 if cross_algo else None),
        gammas=(tuple(sc.cfg.gamma for sc, _ in group)
                if cross_algo else None))


def plan_grid(scenarios: Sequence[Scenario], *,
              fuse: bool = True, cross_algo: bool = True,
              cost_model: Optional[CostModel] = None,
              rounds: Optional[int] = None,
              n_seeds: int = 1, sharded: bool = False) -> GridPlan:
    """Partition ``scenarios`` into maximal fusible banks (the reference's
    ``plan_grid``): cells fuse when they share every static field of their
    config and differ only in the attack (an attack-bank branch and its
    parameters), the rule +/- NNM, the algorithm and its hyperparameters
    (``cross_algo``) and, for ``TRACED_RATIO_KINDS``, the keep-ratio. Groups
    of one and ``none`` attacks are singles. Duplicate labels raise.

    With ``cost_model`` (and the grid's ``rounds`` and ``n_seeds``), a
    multi-algorithm group stays one bank only where
    :meth:`CostModel.fused_s` is no more than
    :meth:`CostModel.partitioned_s`; else it splits into single-algorithm
    banks. Decisions are recorded in ``GridPlan.notes``. ``sharded`` adds
    the model's multi-device first-call overhead (one card: ``False``)."""
    from repro_torch.adversary import core as adv
    if cost_model is not None and rounds is None:
        raise ValueError("plan_grid(cost_model=...) needs rounds= (the run "
                         "length) to predict per-bank runtime")
    label_counts = collections.Counter(sc.label for sc in scenarios)
    dupes = sorted(l for l, c in label_counts.items() if c > 1)
    if dupes:
        raise ValueError(
            f"duplicate scenario labels {dupes}: labels key the results "
            "table — give repeated cells distinct labels")
    if not fuse:
        return GridPlan(banks=(), singles=tuple(scenarios))
    singles: List[Scenario] = []
    groups: Dict[alg.AlgorithmConfig, List[_GroupEntry]] = {}
    for sc in scenarios:
        cfg = sc.cfg
        entry = adv.bank_entry(cfg.attack, cfg.n_workers, cfg.f)
        if entry is None:
            singles.append(sc)
            continue
        sp = cfg.sparsifier
        key = dataclasses.replace(
            cfg,
            attack=A.AttackConfig(name="bank"),
            aggregator=dataclasses.replace(cfg.aggregator, name="bank",
                                           pre_nnm=False, bank=None),
            sparsifier=(dataclasses.replace(sp, ratio=1.0)
                        if sp.kind in C.TRACED_RATIO_KINDS else sp))
        if cross_algo:
            key = dataclasses.replace(
                key, name="bank", bank=None, beta=0.0, smoothness_L=1.0,
                mvr_a=None, gamma=0.0)
        groups.setdefault(key, []).append((sc, entry))
    banks: List[FusedBank] = []
    notes: List[str] = []
    for group in groups.values():
        if len(group) == 1:
            singles.append(group[0][0])
            continue
        cells = collections.Counter(sc.cfg.name for sc, _ in group)
        if cross_algo and cost_model is not None and len(cells) > 1:
            fused_s = cost_model.fused_s(dict(cells), n_seeds, rounds,
                                         sharded=sharded)
            part_s = cost_model.partitioned_s(dict(cells), n_seeds, rounds,
                                              sharded=sharded)
            verdict = "fused" if fused_s <= part_s else "partitioned"
            notes.append(
                f"cost-model[{cost_model.source}] {verdict} "
                f"{'+'.join(sorted(cells))} x{len(group)} cells x{n_seeds} "
                f"seeds x{rounds} rounds: fused {fused_s:.1f}s vs "
                f"partitioned {part_s:.1f}s")
            if fused_s > part_s:
                for algo in cells:
                    sub = [g for g in group if g[0].cfg.name == algo]
                    if len(sub) == 1:
                        singles.append(sub[0][0])
                    else:
                        banks.append(_build_bank(sub, cross_algo=True))
                continue
        banks.append(_build_bank(group, cross_algo=cross_algo))
    return GridPlan(banks=tuple(banks), singles=tuple(singles),
                    notes=tuple(notes))


def eval_over_seeds(sim: Simulator, states: SimState,
                    eval_batch: Any) -> Dict[str, torch.Tensor]:
    """``sim.eval_fn`` over the lanes of a state (``[n_seeds, D]``), in one
    call (``vmap`` over the lanes' parameters)."""
    if sim.eval_fn is None:
        raise ValueError("Simulator has no eval_fn")
    flat = states.params_flat
    lanes = flat.reshape((-1, flat.shape[-1]))
    fn = torch.func.vmap(lambda p: sim.eval_fn(
        T.tree_unravel(p, sim.spec), sim._on_device(eval_batch)))
    with torch.no_grad():
        out = fn(lanes)
    return {k: v.reshape(flat.shape[:-1]) for k, v in out.items()}


def fused_grid_eval(sim: Simulator, states: SimState, eval_batch: Any, *,
                    shard: bool = True,
                    devices: Optional[Sequence[Any]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Evaluate a bank's final states (:func:`fused_grid_rollout`'s
    ``[n_cells, n_seeds, D]``) in one call over the lanes; returns metrics
    with leading ``[n_cells, n_seeds]`` axes."""
    del shard, devices
    if states.params_flat.ndim < 3:
        raise ValueError(
            "fused_grid_eval expects fused_grid_rollout output with leading "
            f"[n_cells, n_seeds] axes, got params_flat shape "
            f"{tuple(states.params_flat.shape)}")
    return eval_over_seeds(sim, states, eval_batch)


def bytes_to_threshold(values: np.ndarray, per_round_bytes: int,
                       threshold: float, mode: str = "<=") -> np.ndarray:
    """Post-hoc early stopping: uplink bytes until ``values`` first crosses
    ``threshold`` (``inf`` where it never does). The LAST axis of
    ``values`` is the round axis; leading axes are kept. Rounds count from
    1."""
    if mode not in ("<=", ">="):
        raise ValueError(f"mode must be '<=' or '>=', got {mode!r}")
    v = np.asarray(values)
    if v.ndim == 0:
        raise ValueError("values must have a trailing round axis")
    flat = v.reshape((-1, v.shape[-1]))
    hit = (flat <= threshold) if mode == "<=" else (flat >= threshold)
    any_hit = hit.any(axis=1)
    first = np.where(any_hit, hit.argmax(axis=1), 0)
    out = np.where(any_hit, (first + 1.0) * per_round_bytes, np.inf)
    return out[0] if v.ndim == 1 else out.reshape(v.shape[:-1])


def _result_rows(sc: Scenario, sim: Simulator, seeds: Sequence[int],
                 loss: np.ndarray, emet: Dict[str, Any],
                 n_steps: int) -> List[Dict[str, Any]]:
    # bytes from the cell's own config and wire format, not the bank's
    per_round = alg.algo_payload_bytes(sc.cfg, sim.d) * sc.cfg.n_workers
    total_bytes = per_round * n_steps
    rows = []
    for i, seed in enumerate(seeds):
        row = {
            "scenario": sc.label,
            "algo": sc.cfg.name,
            "attack": sc.cfg.attack.name,
            "aggregator": sc.cfg.aggregator.name,
            "ratio": (1.0 if sc.cfg.name == "robust_dgd"
                      else sc.cfg.sparsifier.ratio),
            "f": sc.cfg.f,
            "seed": int(seed),
            "final_loss": float(loss[i, -1]),
            "min_loss": float(loss[i].min()),
            "comm_bytes": total_bytes,
        }
        row.update({k: float(v[i]) for k, v in emet.items()})
        rows.append(row)
    return rows


def execute_plan(plan: GridPlan, *,
                 loss_fn: Callable[[Any, Any], torch.Tensor],
                 params0: Any, batches: Any, seeds: Sequence[int],
                 steps: Optional[int] = None,
                 eval_fn: Optional[Callable[[Any, Any], Dict]] = None,
                 eval_batch: Any = None,
                 shard: bool = True,
                 devices: Optional[Sequence[Any]] = None,
                 sim_cache: Optional[Dict[alg.AlgorithmConfig,
                                          Simulator]] = None,
                 device=None,
                 draws_fn: Optional[Callable[[int], Any]] = None,
                 streaming: bool = False,
                 stream_chunk_size: int = 32,
                 prefetch_depth: int = 4
                 ) -> Dict[str, List[Dict[str, Any]]]:
    """Execute a :class:`GridPlan` on ``device`` (default the card); return
    rows keyed by scenario label. Each bank is one lane rollout
    (:func:`fused_grid_rollout`) and one eval call; singles run all their
    seeds as lanes of their own simulator. ``sim_cache`` shares simulators
    across calls with the same ``loss_fn`` / ``params0`` / ``eval_fn``.
    ``draws_fn(seed)`` makes a seed's draws provider for each bank and
    single (default ``TorchDraws(seed)``; parity tests replay the
    reference's).

    With ``streaming=True`` the batches are not materialised: every bank
    and single streams ``stream_chunk_size``-round chunks from a
    ``prefetch_depth``-deep ring buffer (:func:`fused_grid_rollout_streaming`,
    :func:`rollout_over_seeds_streaming`), bitwise the same rows. A callable
    ``batches`` is then streamed anew from round 0 for each of them, so it
    must be a pure function of the round index (pre-stack a stateful one,
    such as the MNIST ``BatchFn``)."""
    del shard, devices
    if streaming:
        if callable(batches):
            if steps is None:
                raise ValueError("steps is required when batches is callable")
            n_steps = steps
        else:
            n_avail = T.tree_leaves(batches)[0].shape[0]
            n_steps = n_avail if steps is None else min(steps, n_avail)
    else:
        batches = ensure_stacked(batches, steps)
        n_steps = T.tree_leaves(batches)[0].shape[0]
    stream = dict(chunk_size=stream_chunk_size, prefetch_depth=prefetch_depth)
    rows_by_label: Dict[str, List[Dict[str, Any]]] = {}
    if sim_cache is None:
        sim_cache = {}

    def get_sim(cfg: alg.AlgorithmConfig) -> Simulator:
        if cfg not in sim_cache:
            sim_cache[cfg] = Simulator(loss_fn=loss_fn, params0=params0,
                                       cfg=cfg, eval_fn=eval_fn,
                                       device=device)
        return sim_cache[cfg]

    def insert(sc: Scenario, rows: List[Dict[str, Any]]) -> None:
        if sc.label in rows_by_label:
            raise ValueError(
                f"duplicate scenario label {sc.label!r} in plan — labels "
                "key the results table")
        rows_by_label[sc.label] = rows

    def seed_draws() -> Optional[List[Any]]:
        return None if draws_fn is None else [draws_fn(s) for s in seeds]

    evaluate = eval_fn is not None and eval_batch is not None
    for bank in plan.banks:
        sim = get_sim(bank.cfg)
        if streaming:
            states, metrics = fused_grid_rollout_streaming(
                sim, bank.scenario_params(), seeds, batches, n_steps,
                draws=seed_draws(), **stream)
        else:
            states, metrics = fused_grid_rollout(
                sim, bank.scenario_params(), seeds, batches,
                draws=seed_draws())
        loss = metrics["loss"].cpu().numpy()  # [n_cells, n_seeds, steps]
        emet = ({k: v.cpu().numpy() for k, v in
                 fused_grid_eval(sim, states, eval_batch).items()}
                if evaluate else {})
        for c, sc in enumerate(bank.scenarios):
            insert(sc, _result_rows(sc, sim, seeds, loss[c],
                                    {k: v[c] for k, v in emet.items()},
                                    n_steps))
    for sc in plan.singles:
        sim = get_sim(sc.cfg)
        if streaming:
            states, metrics = rollout_over_seeds_streaming(
                sim, seeds, batches, n_steps, draws=seed_draws(), **stream)
        else:
            states, metrics = rollout_over_seeds(sim, seeds, batches,
                                                 draws=seed_draws())
        emet = ({k: v.cpu().numpy() for k, v in
                 eval_over_seeds(sim, states, eval_batch).items()}
                if evaluate else {})
        insert(sc, _result_rows(sc, sim, seeds,
                                metrics["loss"].cpu().numpy(), emet,
                                n_steps))
    return rows_by_label


def run_scenarios(scenarios: Sequence[Scenario], *,
                  loss_fn: Callable[[Any, Any], torch.Tensor],
                  params0: Any, batches: Any, seeds: Sequence[int],
                  steps: Optional[int] = None,
                  eval_fn: Optional[Callable[[Any, Any], Dict]] = None,
                  eval_batch: Any = None,
                  fuse_attacks: bool = True,
                  cross_algo: bool = True,
                  shard: bool = True,
                  devices: Optional[Sequence[Any]] = None,
                  cost_model: Optional[CostModel] = None,
                  sim_cache: Optional[Dict[alg.AlgorithmConfig,
                                           Simulator]] = None,
                  device=None,
                  draws_fn: Optional[Callable[[int], Any]] = None,
                  streaming: bool = False,
                  stream_chunk_size: int = 32,
                  prefetch_depth: int = 4
                  ) -> List[Dict[str, Any]]:
    """Run every scenario x seed cell (plan, then execute) and return the
    flat results table in the caller's scenario order: label and config
    fields, seed, final and min honest loss, total uplink bytes under each
    algorithm's wire format and, with ``eval_fn``, the final eval
    metrics. ``cost_model`` decides fused or partitioned multi-algorithm
    banks (:func:`plan_grid`); ``streaming`` feeds every bank from the
    prefetched ring buffer (:func:`execute_plan`)."""
    if streaming and callable(batches):
        if steps is None:
            raise ValueError("steps is required when batches is callable")
        rounds = steps
    else:
        batches = ensure_stacked(batches, steps)
        rounds = T.tree_leaves(batches)[0].shape[0]
    plan = plan_grid(scenarios, fuse=fuse_attacks, cross_algo=cross_algo,
                     cost_model=cost_model, rounds=rounds,
                     n_seeds=len(seeds))
    rows_by_label = execute_plan(
        plan, loss_fn=loss_fn, params0=params0, batches=batches, seeds=seeds,
        steps=rounds, eval_fn=eval_fn, eval_batch=eval_batch, shard=shard,
        devices=devices, sim_cache=sim_cache, device=device,
        draws_fn=draws_fn, streaming=streaming,
        stream_chunk_size=stream_chunk_size, prefetch_depth=prefetch_depth)
    return [row for sc in scenarios for row in rows_by_label[sc.label]]


# --------------------------------------------------------------------------
# Built-in testbeds + CLI
# --------------------------------------------------------------------------


def quadratic_testbed(n_workers: int, d: int = 64, spread: float = 0.1,
                      seed: int = 0, targets: Optional[Any] = None,
                      device=None):
    """The controlled quadratic testbed (``core.testbeds``): worker i holds
    target ``t_i`` and the loss ``0.5 ||w - t_i||^2``. Returns
    ``(loss_fn, params0, batch_fn, targets)``."""
    from repro_torch.core import testbeds
    return testbeds.quadratic_testbed(n_workers, d=d, spread=spread,
                                      seed=seed, targets=targets,
                                      device=device)


def _mnist_testbed(n_workers: int, per_worker: int = 800, batch: int = 60,
                   seed: int = 0, alpha_het: Optional[float] = None,
                   device=None):
    from repro_torch.core import testbeds
    return testbeds.mnist_testbed(n_workers, per_worker=per_worker,
                                  batch=batch, seed=seed,
                                  alpha_het=alpha_het, device=device)


def _transformer_testbed(n_workers: int, local_batch: int = 4,
                         seq_len: int = 32, seed: int = 0,
                         n_layers: int = 2, d_model: int = 256, device=None,
                         use_kernels: bool = True):
    """Reduced ``configs/stablelm_3b`` causal LM on synthetic token streams
    (the reference's ``_transformer_testbed``): ``stablelm_3b`` cut to
    ``n_layers`` layers and ``d_model`` (2 heads of 64, vocab 512),
    parameters from a ``torch.Generator`` seeded with ``seed``.

    The batch schedule is a pure function of the round index
    (``np.random.default_rng((seed, t))``), so streamed banks can each
    re-stream it. Eval is next-token accuracy on a held-out stream of
    ``8 * local_batch`` sequences. On the card the attention takes the
    flash kernels (bfloat16, head dim 64), under ``torch.func`` too;
    ``use_kernels=False`` takes the plain ``causal_attention``.

    Returns ``(loss_fn, params0, batch_fn, eval_fn, eval_batch)``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic_token_batch
    from repro_torch.models import transformer as TR

    dev = resolve_device(device)
    cfg = get_arch("stablelm_3b").model.reduced(
        n_layers=n_layers, d_model=d_model).with_overrides(
            use_flash_attention=None if use_kernels else False)
    params0 = TR.model_init(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)

    def loss_fn(p, b):
        return TR.lm_loss(p, cfg, b)

    def batch_fn(t: int):
        rng = np.random.default_rng((seed, int(t)))
        return synthetic_token_batch(rng, n_workers, local_batch, seq_len,
                                     cfg.vocab_size)

    def eval_fn(p, b):
        hidden, _, _ = TR.forward(p, cfg, b, mode="train")
        logits = TR.logits_fn(p, cfg, hidden[:, :-1]).float()
        pred = logits.argmax(dim=-1)
        return {"acc": (pred == b["tokens"][:, 1:]).float().mean()}

    # held-out stream: one "worker" with a bigger batch, keyed past the
    # training rounds' indices (t < 2**32)
    hold = np.random.default_rng((seed, 2 ** 32))
    eval_batch = {k: torch.as_tensor(v[0], device=dev)
                  for k, v in synthetic_token_batch(
                      hold, 1, 8 * local_batch, seq_len,
                      cfg.vocab_size).items()}
    return loss_fn, params0, batch_fn, eval_fn, eval_batch


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, Any]]:
    import argparse

    p = argparse.ArgumentParser(description="attack x aggregator x algorithm "
                                "x seed grid runner (plan/execute: maximal "
                                "fusible banks, each one lane rollout)")
    p.add_argument("--algos", default="rosdhb")
    p.add_argument("--attacks", default="alie")
    p.add_argument("--aggs", default="cwtm")
    p.add_argument("--scenario", default=None,
                   help="named registry scenario (see --list-scenarios); "
                        "overrides --algos/--attacks/--aggs/--f/--n-honest/"
                        "--ratio/--testbed")
    p.add_argument("--list-scenarios", action="store_true",
                   help="print the scenario registry and exit")
    p.add_argument("--seeds", type=int, default=4, help="number of seeds")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--f", type=int, default=3)
    p.add_argument("--n-honest", type=int, default=10)
    p.add_argument("--ratio", type=float, default=0.1)
    p.add_argument("--gamma", type=float, default=0.05)
    p.add_argument("--testbed", default="quadratic",
                   choices=["quadratic", "mnist", "transformer"])
    p.add_argument("--stream", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="feed rollouts from the prefetched ring buffer "
                        "(repro_torch.data.stream) instead of materialising "
                        "the [steps, ...] batch schedule; implied by "
                        "--testbed transformer")
    p.add_argument("--stream-chunk", type=int, default=32,
                   help="rounds per streamed chunk")
    p.add_argument("--prefetch-depth", type=int, default=4,
                   help="ring-buffer depth: peak host residency is "
                        "O(prefetch_depth * chunk_bytes)")
    p.add_argument("--fuse", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fuse the attack / aggregator / algorithm / ratio "
                        "axes into banks (--no-fuse: one run per scenario)")
    p.add_argument("--cross-algo", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="fuse the algorithm axis too (--no-cross-algo: one "
                        "bank per algorithm)")
    p.add_argument("--shard", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="accepted for the reference's CLI and does nothing: "
                        "the port runs on one card")
    p.add_argument("--kernels", default="auto",
                   choices=["auto", "cuda", "plain"],
                   help="aggregation (and the transformer testbed's "
                        "attention) backend: 'auto' takes the CUDA kernels "
                        "on the card (their plain versions on the CPU); "
                        "'cuda' the kernels (needs --device cuda); 'plain' "
                        "the plain PyTorch versions")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--cost-model", default=None, metavar="PATH|auto",
                   help="decide fused or per-algorithm banks with a "
                        "measured cost model: a JSON path, or 'auto' for "
                        "results/COST_MODEL_torch.json (else the pinned "
                        "default); calibrate with "
                        "repro_torch.core.costmodel.calibrate")
    p.add_argument("--plan", action="store_true",
                   help="print the grid plan and exit")
    p.add_argument("--out", default=None, help="optional JSON output path")
    args = p.parse_args(argv)

    cost_model = None
    if args.cost_model == "auto":
        cost_model = CostModel.load_or_default()
    elif args.cost_model is not None:
        cost_model = CostModel.load(args.cost_model)
    if args.list_scenarios:
        from repro_torch.adversary import registry as R
        print(R.describe())
        return []
    if args.kernels == "cuda" and args.device != "cuda":
        raise ValueError("--kernels cuda needs --device cuda")
    use_kernels = args.kernels != "plain"
    alpha_het = None
    if args.scenario is not None:
        from repro_torch.adversary import registry as R
        spec = R.get_spec(args.scenario)  # ValueError lists known names
        scenarios = with_kernels(spec.expand(), use_kernels)
        n = spec.n_workers
        testbed, alpha_het = spec.testbed, spec.alpha_het
    else:
        scenarios = grid_scenarios(
            args.algos.split(","), args.attacks.split(","),
            args.aggs.split(","), n_honest=args.n_honest, f=args.f,
            ratio=args.ratio, gamma=args.gamma, use_kernels=use_kernels)
        n = args.n_honest + args.f
        testbed = args.testbed
    if args.plan:
        print(plan_grid(scenarios, fuse=args.fuse,
                        cross_algo=args.cross_algo, cost_model=cost_model,
                        rounds=args.steps, n_seeds=args.seeds).describe())
        return []
    seeds = list(range(args.seeds))
    streaming = args.stream or testbed == "transformer"
    if testbed == "quadratic":
        loss_fn, params0, batch_fn, _ = quadratic_testbed(n,
                                                          device=args.device)
        eval_fn = eval_batch = None
    elif testbed == "transformer":
        loss_fn, params0, batch_fn, eval_fn, eval_batch = \
            _transformer_testbed(n, device=args.device,
                                 use_kernels=use_kernels)
    else:
        loss_fn, params0, batch_fn, eval_fn, eval_batch = _mnist_testbed(
            n, alpha_het=alpha_het, device=args.device)
        if streaming:
            # the MNIST BatchFn is stateful (its own generator): stack it
            # once so every bank streams the same schedule
            batch_fn = stack_batches(batch_fn, args.steps)
    rows = run_scenarios(scenarios, loss_fn=loss_fn, params0=params0,
                         batches=batch_fn, seeds=seeds, steps=args.steps,
                         eval_fn=eval_fn, eval_batch=eval_batch,
                         fuse_attacks=args.fuse, cross_algo=args.cross_algo,
                         cost_model=cost_model, device=args.device,
                         streaming=streaming,
                         stream_chunk_size=args.stream_chunk,
                         prefetch_depth=args.prefetch_depth)
    cols = list(rows[0].keys())
    print(",".join(cols))
    for r in rows:
        print(",".join(f"{r[c]:.6g}" if isinstance(r[c], float) else str(r[c])
                       for c in cols))
    if args.out:
        import json
        import os
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=2)
    return rows


if __name__ == "__main__":
    main()
