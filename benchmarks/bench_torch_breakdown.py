"""Breakdown-point and heterogeneity study on the PyTorch port (counterpart
of ``benchmarks/bench_breakdown.py``).

The paper's theory (via [3]) bounds the tolerable Byzantine fraction by
f/n < 1/(2+B^2) and predicts the non-vanishing error floor kappa*G^2.
Two sweeps on the controlled quadratic testbed:

  * breakdown: fix heterogeneity, sweep f/n under ALIE at k/d = 0.1 —
    the distance should stay flat until near n/2 and then explode;
  * heterogeneity: fix f = 3/13, sweep the spread G of worker optima —
    the error floor should grow ~linearly in G (kappa G^2 in distance^2).

Each run is the reference's hand-written loop of ``server_round`` and
``apply_direction`` with a ``TorchDraws(seed)``; the targets come from a
``torch.Generator`` seeded with 1 (a parity test passes the reference's)::

    PYTHONPATH=src:. python -m benchmarks.bench_torch_breakdown [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time
from typing import Any

import torch

from benchmarks.bench_torch_common import (Rows, kernel_launches,
                                           quadratic_targets, server_loop)
from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                              AttackConfig, SparsifierConfig)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.testing import TorchDraws

D = 48


def cell_config(n: int, f: int, gamma: float = 0.05) -> AlgorithmConfig:
    """The configuration of one (n, f) run, as the reference's ``_run``
    builds it."""
    return AlgorithmConfig(
        name="rosdhb", n_workers=n, f=f, gamma=gamma, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=0.1),
        aggregator=AggregatorConfig(name="cwtm", f=max(f, 1), pre_nnm=True),
        attack=AttackConfig(name="alie", z=1.5))


def _run(n, f, spread, seed=0, steps=700, gamma=0.05, *, targets: Any = None,
         draws: Any = None, device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    tg = quadratic_targets(n, D, spread, targets=targets, device=dev)
    cfg = cell_config(n, f, gamma)
    th = server_loop(cfg, tg, steps,
                     TorchDraws(seed, dev) if draws is None else draws)
    d = float(torch.linalg.vector_norm(th - torch.mean(tg[f:], 0)))
    return d if math.isfinite(d) else float("inf")


def run(device: DeviceLike = None) -> Rows:
    dev = resolve_device(device)
    rows = Rows()
    n = 13
    # breakdown sweep
    for f in (0, 2, 4, 5, 6):
        t0 = time.perf_counter()
        d = _run(n, f, spread=0.2, device=dev)
        rows.emit(f"breakdown/f={f}_of_{n}", (time.perf_counter() - t0) * 1e6,
                  f"dist={d:.4f} frac={f/n:.2f}", dist=d, rounds=700, runs=1,
                  kernel_calls=kernel_launches(cell_config(n, f).aggregator,
                                               700, dev))
    # heterogeneity sweep (G grows with the spread of worker optima)
    base = None
    for spread in (0.05, 0.2, 0.8, 2.0):
        t0 = time.perf_counter()
        d = _run(n, 3, spread=spread, device=dev)
        if base is None:
            base = max(d, 1e-9)
        rows.emit(f"heterogeneity/G~{spread}",
                  (time.perf_counter() - t0) * 1e6,
                  f"dist={d:.4f} vs_G0.05={d/base:.1f}x", dist=d, rounds=700,
                  runs=1, kernel_calls=kernel_launches(
                      cell_config(n, 3).aggregator, 700, dev))
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(device=p.parse_args().device)
