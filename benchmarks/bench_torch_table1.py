"""Table 1 on the PyTorch port (counterpart of
``benchmarks/bench_table1.py``): convergence comparison of RoSDHB vs
Byz-DASHA-PAGE vs the two corner baselines (robust-DGD without compression,
compressed DGD without robustness), on the controlled quadratic testbed
where the honest optimum is known exactly. Reports E||grad||^2-style
distance after T rounds under ALIE.

Each cell is one ``rollout_over_seeds`` of the port's ``Simulator``. The
targets come from a ``torch.Generator`` (the reference draws them with
JAX; a parity test passes those in) and the masks from ``TorchDraws(SEED)``
unless ``draws_fn`` gives a cell its provider::

    PYTHONPATH=src:. python -m benchmarks.bench_torch_table1 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from benchmarks.bench_torch_common import Rows, kernel_launches
from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                              AttackConfig, Simulator, SparsifierConfig)
from repro_torch.core.sweep import quadratic_testbed, rollout_over_seeds
from repro_torch.device import DeviceLike, resolve_device

D = 64
STEPS = 800
SEED = 3
F = 3
CELLS = [
    ("rosdhb", 0.1, 0.05),
    ("rosdhb-local", 0.1, 0.05),
    ("dasha", 0.1, 0.02),
    ("robust_dgd", 1.0, 0.1),
    ("dgd", 0.1, 0.05),
]


def cell_config(name: str, ratio: float, gamma: float, n: int, f: int
                ) -> AlgorithmConfig:
    """The cell's configuration, as the reference builds it."""
    algo = "rosdhb" if name.startswith("rosdhb") else name
    local = name.endswith("local")
    return AlgorithmConfig(
        name=algo, n_workers=n, f=f, gamma=gamma, beta=0.9,
        sparsifier=SparsifierConfig(kind="randk", ratio=ratio, local=local),
        aggregator=(AggregatorConfig(name="mean") if algo == "dgd"
                    else AggregatorConfig(name="cwtm", f=f, pre_nnm=True)),
        attack=AttackConfig(name="alie", z=1.5))


def table1_rows(steps: Optional[int] = None, *, device: DeviceLike = None,
                targets: Any = None,
                draws_fn: Optional[Callable[[str, AlgorithmConfig], Any]]
                = None) -> Tuple[Dict[str, float], Rows]:
    """Every cell's ``dist_sq`` after ``steps`` rounds (default
    :data:`STEPS`): ``({cell: dist_sq}, rows)``. ``draws_fn(cell, cfg)``
    gives a cell's draws provider (default ``TorchDraws(SEED)``)."""
    dev = resolve_device(device)
    steps = STEPS if steps is None else steps
    f = F
    n = 10 + f
    loss_fn, params0, batch_fn, tg = quadratic_testbed(
        n, D, spread=0.1, seed=0, targets=targets, device=dev)
    honest_opt = torch.mean(tg[f:], dim=0)
    rows = Rows()
    results = {}
    for name, ratio, gamma in CELLS:
        t0 = time.perf_counter()
        cfg = cell_config(name, ratio, gamma, n, f)
        sim = Simulator(loss_fn=loss_fn, params0=params0, cfg=cfg,
                        device=dev)
        draws = None if draws_fn is None else [draws_fn(name, cfg)]
        states, _ = rollout_over_seeds(sim, [SEED], batch_fn, steps=steps,
                                       draws=draws)
        th = states.params_flat[0, :D]
        grad_sq = float(torch.sum(torch.square(th - honest_opt)))
        wall = (time.perf_counter() - t0) * 1e6
        results[name] = grad_sq
        rows.emit(f"table1/{name}/alie_f{f}", wall, f"dist_sq={grad_sq:.4g}",
                  dist_sq=grad_sq, rounds=steps,
                  kernel_calls=kernel_launches(cfg.aggregator, steps, dev))
    return results, rows


def run(device: DeviceLike = None) -> Rows:
    results, rows = table1_rows(device=device)
    # headline orderings from the paper's theory:
    #   global sparsification beats local (Thm 1 vs Thm 2)
    assert results["rosdhb"] <= results["rosdhb-local"] * 2.0
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(device=p.parse_args().device)
