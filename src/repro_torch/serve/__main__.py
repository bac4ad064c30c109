"""CLI: stand up the streaming Byzantine-robust parameter server against a
simulated client pool, wired through the scenario registry (the reference's
``python -m repro.serve``, flag for flag, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.serve --scenario fig1-alie \
        --rounds 200 --d 1048576
    PYTHONPATH=src python -m repro_torch.serve --scenario stateless-linear \
        --cell rosdhb/foe/median --drop-prob 0.2 --timeout-ms 50 \
        --staleness-window 2 --stale-policy discount --device cpu
    PYTHONPATH=src python -m repro_torch.serve --scenario chaos-serve \
        --chaos combined --transport tcp --rounds 12 --device cpu

The run is on the card unless ``--device cpu``. ``--chaos NAME`` routes the
run through the fault-injected transport harness
(``repro_torch.serve.chaos``): every frame crosses the selected
``--transport`` through a seeded fault plan and retry/backoff clients;
``--list-chaos`` enumerates the scenarios.

Scenario cells with a non-serveable algorithm (dasha: its per-client
control variates go stale under partial participation) are rejected loudly;
pick a serveable cell with ``--cell`` or ``--list-cells``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional, Sequence

from repro_torch.adversary import registry
from repro_torch.core import algorithms as alg
from repro_torch.core.testbeds import quadratic_testbed
from repro_torch.serve import chaos as chaos_mod
from repro_torch.serve.client import ClientBehavior, ClientPool
from repro_torch.serve.server import (ByzantineRobustServer, ServeConfig,
                                      run_service)
from repro_torch.serve.transport import TRANSPORTS


def _pick_cell(name: str, cell: Optional[str]):
    cells = registry.expand_scenario(name)
    if cell is not None:
        match = [s for s in cells if s.label == cell
                 or s.label.endswith("/" + cell) or cell in s.label]
        if not match:
            raise SystemExit(
                f"no cell matching {cell!r} in scenario {name!r}; cells:\n  "
                + "\n  ".join(s.label for s in cells))
        return match[0]
    serveable = [s for s in cells
                 if s.cfg.name in alg.SERVE_ALGORITHMS]
    if not serveable:
        raise SystemExit(
            f"scenario {name!r} has no serveable cell "
            f"(serveable algorithms: {'|'.join(alg.SERVE_ALGORITHMS)})")
    return serveable[0]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="streaming byzantine-robust parameter server")
    p.add_argument("--scenario", default="fig1-alie",
                   help="registry scenario name (--list-scenarios)")
    p.add_argument("--cell", default=None,
                   help="cell label (or substring) within the scenario")
    p.add_argument("--list-scenarios", action="store_true")
    p.add_argument("--list-cells", action="store_true")
    p.add_argument("--rounds", type=int, default=100)
    p.add_argument("--d", type=int, default=64,
                   help="quadratic-testbed model dimension")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quorum", type=int, default=None,
                   help="clients required to fire (default: all n)")
    p.add_argument("--timeout-ms", type=float, default=0.0,
                   help="round wall-clock deadline (0 = quorum only)")
    p.add_argument("--staleness-window", type=int, default=0)
    p.add_argument("--stale-policy", default="discount",
                   choices=("discount", "drop"))
    p.add_argument("--drop-prob", type=float, default=0.0)
    p.add_argument("--late-prob", type=float, default=0.0)
    p.add_argument("--late-rounds", type=int, default=1)
    p.add_argument("--stragglers", default="",
                   help="comma-separated always-late client ids")
    p.add_argument("--straggle-rounds", type=int, default=1)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--chaos", default=None,
                   help="run through the fault-injected transport harness "
                        "with this chaos scenario (--list-chaos)")
    p.add_argument("--transport", default=None, choices=TRANSPORTS,
                   help="transport for --chaos runs (default: the "
                        "scenario's own, usually loopback)")
    p.add_argument("--list-chaos", action="store_true")
    p.add_argument("--out", default=None, help="optional JSON output path")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the server and the pool run (the card by "
                        "default; cpu runs the kernels' plain versions)")
    args = p.parse_args(argv)

    if args.list_scenarios:
        print(registry.describe())
        return {}
    if args.list_chaos:
        print(chaos_mod.describe_chaos())
        return {}
    if args.list_cells:
        for s in registry.expand_scenario(args.scenario):
            tag = ("" if s.cfg.name in alg.SERVE_ALGORITHMS
                   else "  [not serveable]")
            print(f"{s.label}{tag}")
        return {}

    scenario = _pick_cell(args.scenario, args.cell)
    cfg = scenario.cfg
    loss_fn, params0, batch_fn, _ = quadratic_testbed(
        cfg.n_workers, d=args.d, device=args.device)

    if args.chaos is not None:
        sc = chaos_mod.get_chaos(args.chaos)
        if args.transport is not None:
            sc = dataclasses.replace(sc, transport=args.transport)
        print(f"[serve] chaos {sc.name!r} over {sc.transport} transport: "
              f"{scenario.label} n={cfg.n_workers} f={cfg.f}")
        res = chaos_mod.run_chaos(
            cfg, params0, batch_fn, loss_fn, sc, args.rounds,
            seed=args.seed, checkpoint_dir=args.checkpoint_dir,
            device=args.device)
        summary = {
            "scenario": scenario.label, "chaos": sc.name,
            "transport": sc.transport,
            "rounds_driven": res.rounds_driven,
            "restarts": res.restarts,
            "all_rounds_terminated": res.all_rounds_terminated(),
            "step_traces": res.step_traces,
            "injected_faults": res.injected,
            "client_stats": res.client_stats,
            "servers": res.summaries,
        }
        print(json.dumps(summary, indent=2))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=2)
            print(f"[serve] wrote {args.out}", file=sys.stderr)
        return summary

    serve = ServeConfig(
        quorum=args.quorum, timeout_s=args.timeout_ms / 1e3,
        staleness_window=args.staleness_window,
        stale_policy=args.stale_policy,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir)
    behavior = ClientBehavior(
        drop_prob=args.drop_prob, late_prob=args.late_prob,
        late_rounds=args.late_rounds,
        stragglers=tuple(int(x) for x in args.stragglers.split(",") if x),
        straggle_rounds=args.straggle_rounds, seed=args.seed)
    server = ByzantineRobustServer(cfg, params0, serve, seed=args.seed,
                                   device=args.device)
    pool = ClientPool(loss_fn, params0, cfg, batch_fn, behavior=behavior,
                      device=args.device)
    print(f"[serve] {scenario.label}: n={cfg.n_workers} f={cfg.f} "
          f"agg={cfg.aggregator.name} backend={server.agg_backend} "
          f"quorum={server._buffer.quorum} "
          f"timeout={serve.timeout_s * 1e3:.0f}ms")
    run_service(server, pool, args.rounds)
    summary = server.metrics.summary()
    summary["scenario"] = scenario.label
    summary["step_traces"] = server.step_traces
    summary["final_honest_loss"] = float(
        pool.last_losses[cfg.f:].mean())
    print(json.dumps(summary, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"[serve] wrote {args.out}", file=sys.stderr)
    return summary


if __name__ == "__main__":
    main()
