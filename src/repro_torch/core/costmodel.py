"""Measured cost model for ``plan_grid``'s fuse-or-partition decision
(counterpart of ``repro.core.costmodel``).

A cross-algorithm bank runs every algorithm of the grid as lanes of one
simulator; the per-algorithm partition runs one bank per algorithm. Which
is faster depends on the grid (rows = cells x seeds), the trajectory length
and two rates of the machine: the fixed cost of a bank's first call (the
reference's compile; here the first round's allocations and library
set-up) and the warm cost of one row for one round, each affine in the
number of algorithm branches. :class:`CostModel` holds those rates and
decides by pure arithmetic, the reference's decisions to the letter where
its one term of its own, ``bank_round_us``, is 0.

That term is the eager port's: each round of a bank launches its
operations from the host one by one, which costs a fixed time a round
whatever the bank's rows (the reference runs the rounds as one compiled
scan and has no such cost). On an H100 at the quadratic's width it is
most of a round, so a per-row rate fitted from one bank alone prices
every other bank's rounds as almost free, and the partition of a
four-algorithm grid looks cheaper than the fused bank at three times its
measured time. :meth:`CostModel.fit` separates the two from a second
1-branch probe at fewer rows.

:func:`calibrate` measures them on the device: the rosdhb bank of the
Table-1 grid at all and at one of its seeds (1 branch) and the fused bank
(W branches) on the quadratic testbed, timed cold (first call) and warm
(the counterpart of ``benchmarks/bench_sweep.py``'s calibration pass).
The port's fit lives in its own file, :data:`DEFAULT_PATH`, never the
reference's ``results/COST_MODEL.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

#: Where the port's calibrated model is kept (relative to the repository
#: root, as the reference's path is).
DEFAULT_PATH = "results/COST_MODEL_torch.json"

#: The calibration grid: the Table-1 algorithms, attacks and rules.
CALIBRATION_ALGOS = ("rosdhb", "dasha", "robust_dgd", "dgd")
CALIBRATION_ATTACKS = ("alie", "foe", "signflip")
CALIBRATION_AGGS = ("cwtm", "median")


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Calibrated first-call and warm rates of fused-bank runs; ``source``
    says where they were measured."""

    compile_s: float               # first-call cost of one bank
    compile_s_per_branch: float    # extra first-call cost per algorithm
    cell_round_us: float           # warm us per (cell x seed) row per round
    cell_round_us_per_branch: float  # extra warm us per row-round per branch
    #: extra first-call seconds of a bank laid out over several devices
    #: (the reference's sharded compile; 0 on one card)
    sharded_compile_overhead_s: float = 0.0
    source: str = "pinned-default"
    #: warm us per bank per round whatever its rows (the host's launches
    #: of one eager round; the port's own term, 0 for a reference model)
    bank_round_us: float = 0.0

    def program_s(self, *, branches: int, rows: int, rounds: int,
                  sharded: bool = False) -> float:
        """Predicted seconds (first call + warm rounds) of ONE bank with
        ``branches`` algorithm branches over ``rows`` lanes for
        ``rounds`` rounds."""
        if branches < 1:
            raise ValueError(f"branches must be >= 1, got {branches}")
        if rows < 0 or rounds < 0:
            raise ValueError(f"rows/rounds must be >= 0, got {rows}/{rounds}")
        compile_cost = self.compile_s + self.compile_s_per_branch * branches
        if sharded:
            compile_cost += self.sharded_compile_overhead_s
        row_round_us = (self.cell_round_us
                        + self.cell_round_us_per_branch * (branches - 1))
        return (compile_cost
                + (self.bank_round_us + row_round_us * rows) * 1e-6 * rounds)

    def fused_s(self, cells_per_algo: Dict[str, int], n_seeds: int,
                rounds: int, *, sharded: bool = False) -> float:
        """The group as ONE cross-algorithm bank."""
        rows = sum(cells_per_algo.values()) * n_seeds
        return self.program_s(branches=len(cells_per_algo), rows=rows,
                              rounds=rounds, sharded=sharded)

    def partitioned_s(self, cells_per_algo: Dict[str, int], n_seeds: int,
                      rounds: int, *, sharded: bool = False) -> float:
        """The per-algorithm partition: one single-branch bank each."""
        return sum(
            self.program_s(branches=1, rows=c * n_seeds, rounds=rounds,
                           sharded=sharded)
            for c in cells_per_algo.values())

    def prefer_fused(self, cells_per_algo: Dict[str, int], n_seeds: int,
                     rounds: int, *, sharded: bool = False) -> bool:
        """Fuse iff the fused bank is predicted no slower (ties fuse)."""
        return (self.fused_s(cells_per_algo, n_seeds, rounds, sharded=sharded)
                <= self.partitioned_s(cells_per_algo, n_seeds, rounds,
                                      sharded=sharded))

    @classmethod
    def fit(cls, *, single_cold_s: float, single_warm_s: float,
            single_rows: int, fused_cold_s: float, fused_warm_s: float,
            fused_rows: int, branches: int, rounds: int,
            small_warm_s: Optional[float] = None,
            small_rows: Optional[int] = None,
            source: str = "calibration") -> "CostModel":
        """The four rates from a 1-branch and a ``branches``-branch probe,
        each timed cold and warm; rates clamped at zero (a noisy warm run
        can beat its own cold run). With a second warm 1-branch probe of
        ``small_rows`` < ``single_rows`` rows, the 1-branch warm time is
        split into ``bank_round_us`` and a per-row rate (the line through
        the two probes), and the fused probe's rows pay what is left after
        its ``bank_round_us``; without it, the reference's fit."""
        if branches < 2:
            raise ValueError("fit needs a multi-branch probe (branches >= 2)")
        if min(single_rows, fused_rows, rounds) <= 0:
            raise ValueError("probe rows/rounds must be positive")
        bank_us = 0.0
        if small_warm_s is None:
            rate_1 = max(0.0, single_warm_s * 1e6 / (single_rows * rounds))
        else:
            if not 0 < small_rows < single_rows:
                raise ValueError(f"small_rows must be in (0, {single_rows}),"
                                 f" got {small_rows}")
            rate_1 = max(0.0, (single_warm_s - small_warm_s) * 1e6
                         / ((single_rows - small_rows) * rounds))
            bank_us = max(0.0, single_warm_s * 1e6 / rounds
                          - rate_1 * single_rows)
        rate_w = max(0.0, (fused_warm_s * 1e6 / rounds - bank_us)
                     / fused_rows)
        per_branch_us = max(0.0, (rate_w - rate_1) / (branches - 1))
        compile_1 = max(0.0, single_cold_s - single_warm_s)
        compile_w = max(0.0, fused_cold_s - fused_warm_s)
        per_branch_s = max(0.0, (compile_w - compile_1) / (branches - 1))
        return cls(compile_s=max(0.0, compile_1 - per_branch_s),
                   compile_s_per_branch=per_branch_s,
                   cell_round_us=rate_1,
                   cell_round_us_per_branch=per_branch_us,
                   source=source, bank_round_us=bank_us)

    def save(self, path: str = DEFAULT_PATH) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh, indent=2)
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str = DEFAULT_PATH) -> "CostModel":
        """A saved model; unknown keys raise, so a stale or hand-edited
        file cannot change plan decisions unseen."""
        with open(path) as fh:
            raw = json.load(fh)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ValueError(
                f"unknown cost-model keys {unknown} in {path} "
                f"(expected a subset of {sorted(known)})")
        return cls(**raw)

    @classmethod
    def load_or_default(cls, path: Optional[str] = None) -> "CostModel":
        """The calibrated file if present, else :data:`DEFAULT_COST_MODEL`."""
        p = path or DEFAULT_PATH
        if os.path.exists(p):
            return cls.load(p)
        return DEFAULT_COST_MODEL


#: Pinned fallback for a checkout without :data:`DEFAULT_PATH`: the rates
#: of the committed calibration on an H100 (``chip_smoke.py``'s stream
#: phase, ``PERF.md``). The port compiles nothing, so a bank's first call
#: costs little more than a warm one, and a round of the quadratic bank is
#: host-bound: ~3.5 ms a bank whatever its rows, the rows themselves
#: almost free. Every multi-algorithm bank of a few hundred rows stays
#: fused.
DEFAULT_COST_MODEL = CostModel(
    compile_s=0.0468940989999993,
    compile_s_per_branch=0.0,
    cell_round_us=0.0,
    cell_round_us_per_branch=5.88615579365088,
    bank_round_us=3511.172110000018,
    source="pinned-default",
)


def _timed(run, repeats: int) -> Tuple[float, float]:
    """``(cold_s, warm_s)``: the first call, then the best of ``repeats``."""
    t0 = time.perf_counter()
    run()
    cold = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        warm = min(warm, time.perf_counter() - t0)
    return cold, warm


def calibrate(*, d: int = 64, steps: int = 300,
              seeds: Sequence[int] = (0, 1, 2, 3), repeats: int = 2,
              device: Any = None, source: Optional[str] = None
              ) -> Tuple[CostModel, Dict[str, Any]]:
    """Fit a :class:`CostModel` on ``device`` (default the card).

    The Table-1 grid (:data:`CALIBRATION_ALGOS` x :data:`CALIBRATION_ATTACKS`
    x :data:`CALIBRATION_AGGS`, 21 cells) on the quadratic testbed at width
    ``d``: the fused cross-algorithm bank (4 branches) and the rosdhb bank
    of the per-algorithm partition (1 branch), each on a fresh simulator,
    timed cold (first call) and warm (best of ``repeats``) over ``steps``
    rounds and ``seeds`` (at least two), and the rosdhb bank warm at the
    first seed alone (the small probe that separates ``bank_round_us``).
    Returns ``(model, probes)``, ``probes`` the measured seconds and
    rows."""
    import torch

    from repro_torch.core import sweep as S
    from repro_torch.core.simulator import Simulator, stack_batches
    from repro_torch.device import resolve_device

    if len(seeds) < 2:
        raise ValueError(f"calibrate needs two seeds or more, got {seeds}")
    dev = resolve_device(device)
    cells = S.grid_scenarios(CALIBRATION_ALGOS, CALIBRATION_ATTACKS,
                             CALIBRATION_AGGS, n_honest=10, f=3, ratio=0.1,
                             gamma=0.05)
    n = cells[0].cfg.n_workers
    loss_fn, params0, batch_fn, _ = S.quadratic_testbed(n, d=d, device=dev)
    batches = stack_batches(batch_fn, steps)
    (fused,) = S.plan_grid(cells).banks
    single = next(b for b in S.plan_grid(cells, cross_algo=False).banks
                  if b.cfg.name == "rosdhb")

    def probe(bank, probe_seeds):
        sim = Simulator(loss_fn, params0, bank.cfg, device=dev)

        def run():
            _, m = S.fused_grid_rollout(sim, bank.scenario_params(),
                                        probe_seeds, batches)
            m["loss"].cpu()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return _timed(run, repeats)

    single_cold, single_warm = probe(single, seeds)
    _, small_warm = probe(single, seeds[:1])
    fused_cold, fused_warm = probe(fused, seeds)
    probes = {"single_cold_s": single_cold, "single_warm_s": single_warm,
              "single_rows": single.n_cells * len(seeds),
              "small_warm_s": small_warm, "small_rows": single.n_cells,
              "fused_cold_s": fused_cold, "fused_warm_s": fused_warm,
              "fused_rows": fused.n_cells * len(seeds),
              "branches": len(fused.cfg.bank), "rounds": steps}
    model = CostModel.fit(**probes, source=source or (
        f"costmodel.calibrate table1 quadratic d={d} steps={steps} "
        f"seeds={len(seeds)} on {dev}"))
    return model, probes
