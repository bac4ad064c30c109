"""Momentum-mechanism ablation on the PyTorch port (counterpart of
``benchmarks/bench_momentum.py``) — the paper's central claim isolated.

The paper's contribution is that *Polyak momentum is what reconciles
sparsification noise with Byzantine robustness* (its variance scales with
the gradient norm, and the heavy-ball average damps it before the robust
aggregator sees it). This bench sweeps beta with everything else fixed
(RandK 0.1, ALIE f=3, CWTM+NNM): beta=0 is robust compressed DGD (no
momentum), which the paper's Lemma A.4/A.5 predicts to be strictly worse.

Per beta, the three seeds run as the lanes of one rollout
(``rollout_over_seeds``: one pairdist and one CWTM launch a round for all
of them)::

    PYTHONPATH=src:. python -m benchmarks.bench_torch_momentum [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from benchmarks.bench_torch_common import Rows, kernel_launches
from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                              AttackConfig, Simulator, SparsifierConfig)
from repro_torch.core.sweep import quadratic_testbed, rollout_over_seeds
from repro_torch.device import DeviceLike, resolve_device

D = 64
STEPS = 800
SEEDS = (0, 1, 2)
BETAS = (0.0, 0.5, 0.9, 0.99)


def run(device: DeviceLike = None, *, steps: Optional[int] = None,
        seeds: Optional[Sequence[int]] = None, targets: Any = None,
        draws_fn: Optional[Callable[[int], Any]] = None,
        betas: Sequence[float] = BETAS) -> Rows:
    """The beta sweep (default :data:`STEPS` rounds, :data:`SEEDS`,
    :data:`BETAS`; the mechanism line needs beta 0 among ``betas``).
    ``targets`` and ``draws_fn(seed)`` let a parity test pass the
    reference's targets and draws in."""
    dev = resolve_device(device)
    steps = STEPS if steps is None else steps
    seeds = SEEDS if seeds is None else tuple(seeds)
    n, f = 13, 3
    loss_fn, params0, batch_fn, tg = quadratic_testbed(
        n, D, spread=0.2, seed=0, targets=targets, device=dev)
    honest_opt = torch.mean(tg[f:], dim=0).cpu().numpy()
    rows = Rows()
    out = {}
    for beta in betas:
        t0 = time.perf_counter()
        cfg = AlgorithmConfig(
            name="rosdhb", n_workers=n, f=f, gamma=0.05, beta=beta,
            sparsifier=SparsifierConfig(kind="randk", ratio=0.1),
            aggregator=AggregatorConfig(name="cwtm", f=f, pre_nnm=True),
            attack=AttackConfig(name="alie", z=1.5))
        sim = Simulator(loss_fn=loss_fn, params0=params0, cfg=cfg,
                        device=dev)
        draws = None if draws_fn is None else [draws_fn(s) for s in seeds]
        states, _ = rollout_over_seeds(sim, seeds, batch_fn, steps=steps,
                                       draws=draws)
        ds = np.linalg.norm(states.params_flat.cpu().numpy()[:, :D]
                            - honest_opt, axis=1)
        out[beta] = float(np.mean(ds))
        rows.emit(f"momentum/beta={beta}", (time.perf_counter() - t0) * 1e6,
                  f"dist={np.mean(ds):.4f}+-{np.std(ds):.4f}", beta=beta,
                  dist=out[beta], dists=[float(v) for v in ds], rounds=steps,
                  lanes=len(seeds),
                  kernel_calls=kernel_launches(cfg.aggregator, steps, dev))
    if 0.0 not in out:
        return rows
    # the paper's mechanism: momentum strictly improves on no-momentum
    ratio = out[0.0] / max(min(out.values()), 1e-9)
    rows.emit("momentum/mechanism", 0.0, f"no_momentum/best={ratio:.2f}x",
              no_momentum_over_best=ratio)
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(device=p.parse_args().device)
