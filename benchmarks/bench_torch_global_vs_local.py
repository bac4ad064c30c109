"""Global vs local sparsification (paper §3.3) on the PyTorch port
(counterpart of ``benchmarks/bench_global_vs_local.py``): convergence
distance after T rounds as a function of compression ratio, averaged over
seeds. Exhibits the O(1/T)-vs-O(1/sqrt(T)) separation of Theorems 1 and 2
empirically.

Each seed is the reference's hand-written loop of ``server_round`` and
``apply_direction`` with a ``TorchDraws(seed)``; the targets come from a
``torch.Generator`` seeded with 1 (a parity test passes the reference's)::

    PYTHONPATH=src:. python -m benchmarks.bench_torch_global_vs_local \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any

import numpy as np
import torch

from benchmarks.bench_torch_common import (Rows, kernel_launches,
                                           quadratic_targets, server_loop)
from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                              AttackConfig, SparsifierConfig)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.testing import TorchDraws

D = 64
N, F = 12, 2


def cell_config(ratio: float, local: bool) -> AlgorithmConfig:
    """The configuration of one (ratio, mask) cell, as the reference's
    ``_dist`` builds it."""
    return AlgorithmConfig(
        name="rosdhb", n_workers=N, f=F, gamma=0.05, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=ratio, local=local),
        aggregator=AggregatorConfig(name="cwtm", f=F, pre_nnm=True),
        attack=AttackConfig(name="alie", z=1.5))


def _dist(ratio, local, steps, seed, *, targets: Any = None,
          draws: Any = None, device: DeviceLike = None) -> float:
    dev = resolve_device(device)
    tg = quadratic_targets(N, D, 0.2, targets=targets, device=dev)
    cfg = cell_config(ratio, local)
    th = server_loop(cfg, tg, steps,
                     TorchDraws(seed, dev) if draws is None else draws)
    return float(torch.linalg.vector_norm(th - torch.mean(tg[F:], 0)))


def run(device: DeviceLike = None) -> Rows:
    dev = resolve_device(device)
    rows = Rows()
    out = {}
    for ratio in (0.05, 0.2):
        for local in (False, True):
            t0 = time.perf_counter()
            ds = [_dist(ratio, local, steps=600, seed=s, device=dev)
                  for s in range(3)]
            wall = (time.perf_counter() - t0) * 1e6
            tag = "local" if local else "global"
            out[(ratio, tag)] = float(np.mean(ds))
            rows.emit(f"glob_vs_local/ratio={ratio}/{tag}", wall,
                      f"dist={np.mean(ds):.4f}+-{np.std(ds):.4f}",
                      dist=out[(ratio, tag)], dists=ds, rounds=600, runs=3,
                      kernel_calls=kernel_launches(
                          cell_config(ratio, local).aggregator, 3 * 600,
                          dev))
    for ratio in (0.05, 0.2):
        g, l = out[(ratio, "global")], out[(ratio, "local")]
        rows.emit(f"glob_vs_local/ratio={ratio}/advantage", 0.0,
                  f"local/global={l / max(g, 1e-9):.2f}x",
                  local_over_global=l / max(g, 1e-9))
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(device=p.parse_args().device)
