#!/usr/bin/env python3
"""Benchmark harness of the PyTorch port (counterpart of
``benchmarks/run.py``) — one module per paper table/figure.

  fig1            paper Figure 1: comm cost to tau vs compression ratio (ALIE)
  table1          paper Table 1: RoSDHB vs Byz-DASHA-PAGE vs corner baselines
  global_vs_local paper §3.3: coordinated vs uncoordinated sparsification
  momentum        the beta ablation (the paper's mechanism)
  breakdown       breakdown point and heterogeneity floor
  aggregators     (f,kappa)-robust rule microbench
  kernels         batched aggregation kernels against the plain rules
                  (``bench_torch_kernels``: writes
                  ``results/BENCH_torch_kernels.json``)
  roofline        the dry run's roofline table (``bench_torch_roofline``:
                  reads ``results/dryrun_torch.json``)

Not yet ported (``ROADMAP.md``, Queue 1): ``sweep``; naming it prints so
and runs nothing.

Every measurement prints one CSV line: ``name,us_per_call,derived``, with
the reference's names. Everything runs on the CUDA card unless
``--device cpu``. fig1 writes ``results/fig1_torch_quick.json`` (or
``_full`` with ``--full``), never the reference's files::

    python3 benchmarks/bench_torch_run.py [--full] [--only NAME] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

if __package__ in (None, ""):
    # run as a script: the repository root (benchmarks) and src (the port)
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from repro_torch.device import DeviceLike, resolve_device  # noqa: E402

#: The reference's suites, in its order.
SUITES = ("aggregators", "kernels", "table1", "momentum", "sweep",
          "breakdown", "global_vs_local", "fig1", "roofline")
NOT_PORTED = ("sweep",)


#: The suites of the paper's tables and figures (every ported suite but
#: the kernel and roofline reports).
PAPER_SUITES = ("aggregators", "table1", "momentum", "breakdown",
                "global_vs_local", "fig1")


def run(full: bool = False, only: Optional[str] = None,
        device: DeviceLike = None, fig1_out: Optional[str] = None,
        suites: Optional[Sequence[str]] = None) -> Dict[str, Dict]:
    """Run the suites (``only`` one of them; ``suites`` a subset, in the
    reference's order) on ``device``; returns ``{suite: {"rows": ...,
    "wall_s": seconds}}``: a paper suite's ``Rows``, ``kernels``' results
    dict, ``roofline``'s reports. fig1 writes its rows to ``fig1_out``
    (default ``results/fig1_torch_quick.json``, or ``_full``)."""
    from benchmarks import (bench_torch_aggregators, bench_torch_breakdown,
                            bench_torch_fig1, bench_torch_global_vs_local,
                            bench_torch_kernels, bench_torch_momentum,
                            bench_torch_roofline, bench_torch_table1)
    if only is not None and only not in SUITES:
        raise ValueError(f"unknown suite {only!r}; known: {SUITES}")
    dev = resolve_device(device)
    out = fig1_out or str(bench_torch_fig1.out_path(full))
    runners = {
        "aggregators": lambda: bench_torch_aggregators.run(device=dev),
        "table1": lambda: bench_torch_table1.run(device=dev),
        "momentum": lambda: bench_torch_momentum.run(device=dev),
        "breakdown": lambda: bench_torch_breakdown.run(device=dev),
        "global_vs_local": lambda: bench_torch_global_vs_local.run(
            device=dev),
        "fig1": lambda: bench_torch_fig1.run(full=full, out=out, device=dev),
        "kernels": lambda: bench_torch_kernels.run(device=dev),
        "roofline": lambda: bench_torch_roofline.run(),
    }
    results = {}
    t0 = time.time()
    for name in SUITES:
        if (only and name != only) or (suites is not None
                                       and name not in suites):
            continue
        if name in NOT_PORTED:
            print(f"# --- {name} --- not yet ported to the PyTorch port "
                  "(ROADMAP.md, Queue 1)")
            continue
        print(f"# --- {name} ---")
        t1 = time.perf_counter()
        rows = runners[name]()
        wall = time.perf_counter() - t1
        print(f"# {name} wall: {wall:.1f}s")
        results[name] = {"rows": rows, "wall_s": wall}
    print(f"# total wall: {time.time()-t0:.1f}s")
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true")
    p.add_argument("--only", default=None, choices=SUITES)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(full=args.full, only=args.only, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
