#!/usr/bin/env python3
"""The grid engine of the PyTorch port against sequential ``Simulator``
runs (counterpart of ``benchmarks/bench_sweep.py``).

Five claims, written to ``results/BENCH_torch_sweep.json`` after each one:

1. **Attack fusion**: a 4-seed x 3-attack grid through
   ``repro_torch.core.sweep`` (``fused_attack_rollout``, the lanes of one
   rollout) must find the same bytes-to-tau crossings as sequential
   ``Simulator.run`` and ``run_per_round`` calls, and on the card be at
   least 1.2x faster than the sequential ``run`` calls (a wall-clock gate:
   on the card only).
2. **One program for the whole grid**: rosdhb x 5 attacks x 3 aggregators x
   4 seeds plans to ONE fusible bank (``plan.n_programs == 1``). The
   reference counts compiled programs (``Simulator.round_traces``); the
   eager port holds the same intent by launches: the bank launches each
   kernel of its rules once a round whatever its lane count (on the card),
   where the per-scenario path runs one program a scenario. Every cell
   matches its per-scenario rollout (rtol 1e-4).
3. **Stateful attack bank**: six attacks (alie/signflip/foe and the
   stateful tracked mimic, gauss and the adaptive spectral attack) x 3
   aggregators still plan to one bank, the same launch rule, every cell
   matching its per-scenario rollout.
4. **Cross-algorithm bank**: rosdhb, Byz-DASHA-PAGE, robust DGD and DGD x
   3 attacks x 2 aggregators x 4 seeds plan to ONE bank where the
   per-algorithm partition (``plan_grid(cross_algo=False)``) runs one an
   algorithm; both timed cold and warm, the cost model fitted from the
   fused bank and rosdhb's bank (the reference's probes), with rosdhb's
   bank also timed warm at one seed for the port's per-bank round term
   (``core.costmodel``; written to ``cost_model_out``, the port's
   ``results/COST_MODEL_torch.json`` by default), and on the card its
   chosen plan must be the measured-best static plan and execute within
   1.25x of it: the chosen plan and the best static plan run in turns
   inside one loop (:data:`GATE_TURNS` runs each), and the median of the
   turns' ratios (:func:`chosen_over_best`) is held to it.
5. **Device sharding**: one card has nothing to shard over; the section
   records ``n_devices`` 1 and ``skipped``, and times no fake shard.

Everything runs on the card unless ``--device cpu``. The named arguments
of :func:`run` cut the sections' sizes; the defaults are the reference's::

    python3 benchmarks/bench_torch_sweep.py [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

if __package__ in (None, ""):
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmarks.bench_torch_common import (emit,  # noqa: E402
                                           launches_since, run_sections)
from repro_torch import kernels as K  # noqa: E402
from repro_torch.core import (AttackConfig, CostModel,  # noqa: E402
                              Simulator, quadratic_testbed, stack_batches)
from repro_torch.core import algorithms as alg  # noqa: E402
from repro_torch.core.costmodel import DEFAULT_PATH  # noqa: E402
from repro_torch.core.sweep import (fused_attack_rollout,  # noqa: E402
                                    fused_grid_rollout, grid_scenarios,
                                    plan_grid, rollout_over_seeds)
from repro_torch.device import (DeviceLike, resolve_device,  # noqa: E402
                                synchronize)

OUT = "results/BENCH_torch_sweep.json"

D = 64
STEPS = 300
EVAL_EVERY = 20
TAU_LOSS = 0.5  # honest-mean-loss threshold standing in for the paper's tau
SEEDS = (0, 1, 2, 3)
ATTACKS = ("alie", "foe", "signflip")
GRID_ATTACKS = ("alie", "signflip", "ipm", "foe", "zero")
GRID_AGGS = ("cwtm", "median", "geomed")
STATEFUL_ATTACKS = ("alie", "signflip", "foe", "mimic", "gauss", "spectral")
CROSS_ALGOS = ("rosdhb", "dasha", "robust_dgd", "dgd")
CROSS_ATTACKS = ("alie", "foe", "signflip")
CROSS_AGGS = ("cwtm", "median")

#: The wall-clock gates (on the card only).
FUSION_FLOOR = 1.2
CHOSEN_SLACK = 1.25
#: Runs each of the chosen plan and the best static plan in the chosen-plan
#: gate's loop, taken in turns.
GATE_TURNS = 5
SORT_KERNELS = ("pairdist", "cwtm", "median")


def round_kernels(cfg, agg_idx: Optional[Sequence[int]] = None,
                  algo_idx: Optional[Sequence[int]] = None) -> tuple:
    """The kernels one round of ``cfg`` launches on the card, each once
    whatever its lane count: NNM's pairdist where a rule composes it, CWTM
    and the median where a lane takes them; dgd's lanes take the plain
    mean. A bank's lanes are its cells' ``agg_idx`` (and ``algo_idx``)."""
    agg = cfg.aggregator
    if agg.name == "bank":
        entries = [agg.bank[e] for e in agg_idx]
    else:
        entries = [(agg.name, agg.pre_nnm)]
    algos = ([alg.ALGO_BANK[a] for a in algo_idx] if algo_idx is not None
             else [cfg.name] * len(entries))
    used = set()
    for (name, pre), algo in zip(entries, algos):
        if algo == "dgd":
            continue
        if pre and name != "mean":
            used.add("pairdist")
        if name in ("cwtm", "median"):
            used.add(name)
    return tuple(k for k in SORT_KERNELS if k in used)


def bank_kernels(bank) -> tuple:
    return round_kernels(bank.cfg, bank.agg_idx, bank.algo_idx)


def expected_launches(kernels: Sequence[str], rounds: int,
                      dev: torch.device) -> dict:
    return {k: rounds if dev.type == "cuda" and k in kernels else 0
            for k in SORT_KERNELS}


def _launched(mark: dict) -> dict:
    """The sorting kernels' launches since ``mark``."""
    return {k: v for k, v in launches_since(mark).items()
            if k in SORT_KERNELS}


def _attack_fusion_gate(dev, loss_fn, params0, batch_fn, batches, scenarios,
                        steps):
    """Claim 1: fused attack grid vs sequential Simulator.run (1.2x floor
    on the card)."""
    cells = len(scenarios) * len(SEEDS)
    eval_rounds = np.asarray([t for t in range(steps)
                              if t % EVAL_EVERY == 0 or t == steps - 1])

    # the engine: the whole grid as lanes of one rollout, post-hoc stop
    synchronize(dev)
    t0 = time.perf_counter()
    lin = dataclasses.replace(scenarios[0].cfg,
                              attack=AttackConfig(name="linear"))
    sim = Simulator(loss_fn, params0, lin, device=dev)
    per_round_bytes = sim.payload_bytes_per_round()
    _, metrics = fused_attack_rollout(
        sim, [sc.cfg.attack for sc in scenarios], SEEDS, batches)
    loss_at_evals = metrics["loss"].cpu().numpy()[:, :, eval_rounds]
    hit = loss_at_evals <= TAU_LOSS
    first = np.where(hit.any(-1), hit.argmax(-1), 0)
    sweep_bytes = np.where(hit.any(-1),
                           (eval_rounds[first] + 1.0) * per_round_bytes,
                           np.inf)
    t_sweep = time.perf_counter() - t0

    # sequential baselines: same protocol, one cell at a time
    def sequential(method):
        out = np.full((len(scenarios), len(SEEDS)), np.inf)
        synchronize(dev)
        t0 = time.perf_counter()
        for a, sc in enumerate(scenarios):
            for i, s in enumerate(SEEDS):
                cell_sim = Simulator(loss_fn, params0, sc.cfg, device=dev)
                reached = {}

                def stop(m):
                    if m["loss"] <= TAU_LOSS and not reached:
                        reached["bytes"] = m["comm_bytes"]
                    return bool(reached)

                getattr(cell_sim, method)(cell_sim.init(s), batch_fn, steps,
                                          eval_every=EVAL_EVERY, stop_fn=stop)
                out[a, i] = reached.get("bytes", np.inf)
        synchronize(dev)
        return time.perf_counter() - t0, out

    t_run, run_bytes = sequential("run")
    t_legacy, legacy_bytes = sequential("run_per_round")

    # Output parity: the engines must find the same crossings; a cell whose
    # eval loss grazes TAU_LOSS within float rounding may cross one eval
    # round apart (float32 sums in other orders): tolerated only there
    def assert_same_crossings(other):
        diff = sweep_bytes != other
        grazes = np.min(np.abs(loss_at_evals - TAU_LOSS), axis=-1) < 1e-4
        assert np.all(~diff | grazes), (sweep_bytes, other)

    assert_same_crossings(run_bytes)
    assert_same_crossings(legacy_bytes)

    emit("sweep/sequential_run_cells", t_run * 1e6 / cells,
         f"total={t_run:.2f}s (acceptance baseline)")
    emit("sweep/sequential_per_round_cells", t_legacy * 1e6 / cells,
         f"total={t_legacy:.2f}s")
    emit("sweep/fused_engine", t_sweep * 1e6 / cells,
         f"total={t_sweep:.2f}s speedup_vs_run={t_run / t_sweep:.1f}x "
         f"speedup_vs_per_round={t_legacy / t_sweep:.1f}x")
    speedup = t_run / t_sweep
    if dev.type == "cuda":
        assert speedup >= FUSION_FLOOR, (
            f"fused sweep only {speedup:.1f}x faster than sequential "
            f"Simulator.run calls (acceptance floor is {FUSION_FLOOR}x)")
    return {"run_s": t_run, "per_round_s": t_legacy, "sweep_s": t_sweep,
            "speedup": speedup,
            "crossings": np.where(np.isinf(sweep_bytes), -1.0,
                                  sweep_bytes).tolist()}


def _bank_vs_scenarios(dev, loss_fn, params0, batches, scenarios, steps,
                       label: str, what: str) -> dict:
    """Claims 2 and 3: one bank against its per-scenario rollouts, its
    launches held to one a kernel a round."""
    plan = plan_grid(scenarios)
    assert plan.n_programs == 1 and plan.banks[0].n_cells == len(scenarios), \
        plan.describe()
    bank = plan.banks[0]

    synchronize(dev)
    t0 = time.perf_counter()
    sim = Simulator(loss_fn, params0, bank.cfg, device=dev)
    mark = K.launches()
    _, metrics = fused_grid_rollout(sim, bank.scenario_params(), SEEDS,
                                    batches)
    fused_loss = metrics["loss"].cpu().numpy()  # [n_cells, n_seeds, steps]
    t_bank = time.perf_counter() - t0
    launches = _launched(mark)
    want = expected_launches(bank_kernels(bank), steps, dev)
    assert launches == want, (
        f"{label}: the bank launched {launches} in {steps} rounds, "
        f"expected one a kernel a round: {want}")

    # per-scenario path: one lane rollout (its seeds) per scenario
    synchronize(dev)
    t0 = time.perf_counter()
    per = {k: 0 for k in SORT_KERNELS}
    for c, sc in enumerate(bank.scenarios):
        ref = Simulator(loss_fn, params0, sc.cfg, device=dev)
        mark = K.launches()
        _, ref_metrics = rollout_over_seeds(ref, SEEDS, batches)
        got = _launched(mark)
        assert got == expected_launches(round_kernels(sc.cfg), steps, dev), \
            (sc.label, got)
        per = {k: per[k] + got[k] for k in per}
        np.testing.assert_allclose(
            fused_loss[c], ref_metrics["loss"].cpu().numpy(),
            rtol=1e-4, atol=1e-6, err_msg=sc.label)
    t_seq = time.perf_counter() - t0

    n_cells = len(scenarios)
    emit(f"sweep/{label}_one_program",
         t_bank * 1e6 / (n_cells * len(SEEDS)),
         f"total={t_bank:.2f}s programs=1 cells={n_cells}{what} "
         f"launches={launches}")
    emit(f"sweep/{label}_per_scenario",
         t_seq * 1e6 / (n_cells * len(SEEDS)),
         f"total={t_seq:.2f}s programs={n_cells} "
         f"speedup_fused={t_seq / t_bank:.1f}x")
    return {"bank_s": t_bank, "per_scenario_s": t_seq,
            "bank_compiles": plan.n_programs,
            "per_scenario_compiles": n_cells, "n_cells": n_cells,
            "speedup": t_seq / t_bank, "bank_launches": launches,
            "per_scenario_launches": per}


def _one_program_grid(dev, loss_fn, params0, batches, steps):
    """Claim 2: attack x aggregator grid = ONE program."""
    scenarios = grid_scenarios(["rosdhb"], GRID_ATTACKS, GRID_AGGS,
                               n_honest=10, f=3, ratio=0.1, gamma=0.05)
    return _bank_vs_scenarios(dev, loss_fn, params0, batches, scenarios,
                              steps, "grid", "")


def _stateful_grid(dev, loss_fn, params0, batches, steps):
    """Claim 3: 6 mixed stateless+stateful attacks x 3 aggregators = ONE
    program, cells match per-scenario rollouts."""
    scenarios = grid_scenarios(["rosdhb"], STATEFUL_ATTACKS, GRID_AGGS,
                               n_honest=10, f=3, ratio=0.1, gamma=0.05)
    bank = plan_grid(scenarios).banks[0]
    assert {"mimic", "gauss", "spectral"} <= set(bank.cfg.attack.bank)
    return _bank_vs_scenarios(
        dev, loss_fn, params0, batches, scenarios, steps, "stateful_grid",
        f" attacks={len(STATEFUL_ATTACKS)} (3 stateful)")


def _timed_fused(dev, sim, bank, batches, repeats=2, seeds=SEEDS):
    """(cold_s, warm_s, loss): cold is the first run (the port builds no
    program; its first run pays the lazy setup), warm the best of
    ``repeats`` further runs."""
    synchronize(dev)
    t0 = time.perf_counter()
    _, metrics = fused_grid_rollout(sim, bank.scenario_params(), seeds,
                                    batches)
    loss = metrics["loss"].cpu().numpy()
    cold = time.perf_counter() - t0
    warm = np.inf
    for _ in range(repeats):
        synchronize(dev)
        t0 = time.perf_counter()
        _, m = fused_grid_rollout(sim, bank.scenario_params(), seeds,
                                  batches)
        synchronize(dev)
        warm = min(warm, time.perf_counter() - t0)
    return cold, warm, loss


def chosen_over_best(chosen_s: Sequence[float],
                     best_s: Sequence[float]) -> float:
    """The chosen-plan gate's reading: the median, over the turns of its
    loop, of the chosen plan's warm seconds over the best static plan's in
    the same turn. The two are host-bound wall times read in turns, so the
    host's drift falls on both sides of each ratio alike."""
    if len(chosen_s) != len(best_s) or not chosen_s:
        raise ValueError(f"the gate needs as many readings of each plan, "
                         f"one or more: {len(chosen_s)} and {len(best_s)}")
    ratios = sorted(c / b for c, b in zip(chosen_s, best_s))
    mid = len(ratios) // 2
    return ratios[mid] if len(ratios) % 2 else (ratios[mid - 1]
                                                + ratios[mid]) / 2


def _warm_run_s(dev, runs, batches) -> float:
    """Wall seconds of one run of a plan: each ``(simulator, bank)`` of
    ``runs`` rolled out once, in order, ending in a device synchronise."""
    synchronize(dev)
    t0 = time.perf_counter()
    for sim, bank in runs:
        fused_grid_rollout(sim, bank.scenario_params(), SEEDS, batches)
    synchronize(dev)
    return time.perf_counter() - t0


def _cross_algo_grid(dev, loss_fn, params0, batches, steps, cost_model_out):
    """Claim 4: both static plans of the Table-1 grid timed, the cost model
    fitted from those probes, and its chosen plan the measured-best."""
    scenarios = grid_scenarios(CROSS_ALGOS, CROSS_ATTACKS, CROSS_AGGS,
                               n_honest=10, f=3, ratio=0.1, gamma=0.05)
    rows = len(scenarios) * len(SEEDS)

    # static choice A: ONE fused cross-algorithm bank
    plan = plan_grid(scenarios)
    assert plan.n_programs == 1 and plan.banks[0].n_cells == len(scenarios), \
        plan.describe()
    bank = plan.banks[0]
    assert set(bank.cfg.bank) == set(CROSS_ALGOS)
    assert bank.cfg.resolved_state_layout().is_full  # dasha branch present
    sim = Simulator(loss_fn, params0, bank.cfg, device=dev)
    mark = K.launches()
    fused_cold, fused_warm, floss = _timed_fused(dev, sim, bank, batches)
    launches = _launched(mark)
    # three runs of the bank: one launch a kernel a round in each
    want = expected_launches(bank_kernels(bank), 3 * steps, dev)
    assert launches == want, (launches, want)
    fused_loss = {sc.label: floss[c] for c, sc in enumerate(bank.scenarios)}

    # static choice B: the per-algorithm banks, each dasha-free bank on the
    # pruned carry
    per_plan = plan_grid(scenarios, cross_algo=False)
    assert per_plan.n_programs == len(CROSS_ALGOS), per_plan.describe()
    part_cold = part_warm = 0.0
    part_runs = []
    single_probe = None  # the 1-branch calibration probe (rosdhb's bank)
    for b in per_plan.banks:
        assert (b.cfg.resolved_state_layout().is_full
                == (b.cfg.name == "dasha")), b.cfg.name
        ref = Simulator(loss_fn, params0, b.cfg, device=dev)
        part_runs.append((ref, b))
        cold, warm, loss = _timed_fused(dev, ref, b, batches)
        part_cold, part_warm = part_cold + cold, part_warm + warm
        if b.cfg.name == "rosdhb":
            # and at one seed: the per-bank round term of the port's model
            _, small_warm, _ = _timed_fused(dev, ref, b, batches,
                                            seeds=SEEDS[:1])
            single_probe = (cold, warm, b.n_cells * len(SEEDS), small_warm,
                            b.n_cells)
        for c, sc in enumerate(b.scenarios):
            np.testing.assert_allclose(
                fused_loss[sc.label], loss[c],
                rtol=1e-5, atol=1e-7, err_msg=sc.label)

    # calibration: fit the cost model from the probes, persist it
    model = CostModel.fit(
        single_cold_s=single_probe[0], single_warm_s=single_probe[1],
        single_rows=single_probe[2], small_warm_s=single_probe[3],
        small_rows=single_probe[4],
        fused_cold_s=fused_cold, fused_warm_s=fused_warm, fused_rows=rows,
        branches=len(CROSS_ALGOS), rounds=steps,
        source=f"bench_torch_sweep table1 D={D} steps={steps} {dev.type}")
    if cost_model_out:
        model.save(cost_model_out)

    # the model's choice, re-planned and executed (fresh simulators)
    chosen_plan = plan_grid(scenarios, cost_model=model, rounds=steps,
                            n_seeds=len(SEEDS))
    chosen_kind = ("fused" if chosen_plan.n_programs == 1 else "partitioned")
    chosen_cold = chosen_warm_exec = 0.0
    chosen_runs = []
    for b in chosen_plan.banks:
        csim = Simulator(loss_fn, params0, b.cfg, device=dev)
        chosen_runs.append((csim, b))
        cold, warm, loss = _timed_fused(dev, csim, b, batches)
        chosen_cold, chosen_warm_exec = chosen_cold + cold, \
            chosen_warm_exec + warm
        for c, sc in enumerate(b.scenarios):
            np.testing.assert_allclose(
                fused_loss[sc.label], loss[c],
                rtol=1e-5, atol=1e-7, err_msg=sc.label)
    assert not chosen_plan.singles, chosen_plan.describe()

    # the decision gate: the plan the model picked must BE the measured-best
    # static choice, and executing it must land within noise of it: the
    # chosen plan and the best static plan read in turns, like with like
    best_warm = min(fused_warm, part_warm)
    chosen_warm = fused_warm if chosen_kind == "fused" else part_warm
    speedup = best_warm / chosen_warm
    best_runs = [(sim, bank)] if fused_warm <= part_warm else part_runs
    turns = {"chosen": [], "best": []}
    for turn in range(GATE_TURNS):
        for who in (("chosen", "best") if turn % 2 == 0
                    else ("best", "chosen")):
            turns[who].append(_warm_run_s(
                dev, chosen_runs if who == "chosen" else best_runs,
                batches))
    gate = chosen_over_best(turns["chosen"], turns["best"])
    if dev.type == "cuda":
        assert speedup >= 1.0, (
            f"cost model chose {chosen_kind} ({chosen_warm:.2f}s warm) over "
            f"a faster static plan ({best_warm:.2f}s warm)")
        assert gate <= CHOSEN_SLACK, (
            f"chosen plan executed at a median {gate:.3f}x the best static "
            f"plan's warm time over {GATE_TURNS} turns (chosen "
            f"{turns['chosen']} s, best {turns['best']} s; tolerance "
            f"{CHOSEN_SLACK}x)")

    n_cells = len(scenarios)
    emit("sweep/cross_algo_one_program", fused_cold * 1e6 / rows,
         f"cold={fused_cold:.2f}s warm={fused_warm:.2f}s programs=1 "
         f"cells={n_cells} algos={len(CROSS_ALGOS)}")
    emit("sweep/cross_algo_per_algo_banks", part_cold * 1e6 / rows,
         f"cold={part_cold:.2f}s warm={part_warm:.2f}s "
         f"programs={per_plan.n_programs}")
    emit("sweep/cross_algo_chosen_plan", chosen_warm_exec * 1e6 / rows,
         f"{chosen_kind} warm={chosen_warm_exec:.2f}s "
         f"vs best static warm={best_warm:.2f}s "
         f"(fused_warm/partitioned_warm={fused_warm / part_warm:.2f}; in "
         f"turns: chosen/best median={gate:.3f})")
    return {"bank_s": fused_cold, "per_algo_s": part_cold,
            "fused_warm_s": fused_warm, "per_algo_warm_s": part_warm,
            "chosen": chosen_kind, "chosen_cold_s": chosen_cold,
            "chosen_warm_s": chosen_warm_exec,
            "gate_chosen_s": turns["chosen"], "gate_best_s": turns["best"],
            "chosen_over_best": gate,
            "bank_compiles": plan.n_programs,
            "per_algo_compiles": per_plan.n_programs,
            "n_cells": n_cells, "speedup": speedup,
            "warm_vs_fused_default": fused_warm / chosen_warm,
            "bank_launches": launches, "cost_model_out": cost_model_out,
            "cost_model": dataclasses.asdict(model)}


def _sharded_grid() -> dict:
    """Claim 5: one card has nothing to shard the lanes over."""
    emit("sweep/sharded_grid", 0.0,
         "SKIPPED n_devices=1 (one card: no shard to time)")
    return {"n_devices": 1, "skipped": "one card: nothing to shard the "
            "lanes over", "single_warm_s": None, "sharded_warm_s": None}


def run(out: Optional[str] = OUT, device: DeviceLike = None, *,
        steps: int = STEPS,
        cost_model_out: Optional[str] = DEFAULT_PATH) -> dict:
    """The five sections on ``device`` (default the card), the JSON
    rewritten to ``out`` after each; the fitted cost model goes to
    ``cost_model_out`` (``None``: nowhere). ``steps`` cuts every section's
    rounds; the default is the reference's."""
    dev = resolve_device(device)
    f = 3
    n = 10 + f
    loss_fn, params0, batch_fn, _ = quadratic_testbed(n, D, seed=0,
                                                      device=dev)
    scenarios = grid_scenarios(["rosdhb"], ATTACKS, ["cwtm"], n_honest=10,
                               f=f, ratio=0.1, gamma=0.05)
    batches = stack_batches(batch_fn, steps)
    torch.zeros(1, device=dev)  # backend init outside all timings
    return run_sections((
        ("attack_fusion", lambda: _attack_fusion_gate(
            dev, loss_fn, params0, batch_fn, batches, scenarios, steps)),
        ("grid_one_program", lambda: _one_program_grid(
            dev, loss_fn, params0, batches, steps)),
        ("stateful_grid", lambda: _stateful_grid(
            dev, loss_fn, params0, batches, steps)),
        ("cross_algo_grid", lambda: _cross_algo_grid(
            dev, loss_fn, params0, batches, steps, cost_model_out)),
        ("sharded", _sharded_grid),
    ), out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--out", default=OUT)
    p.add_argument("--cost-model-out", default=DEFAULT_PATH)
    args = p.parse_args(argv)
    run(out=args.out, device=args.device,
        cost_model_out=args.cost_model_out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
