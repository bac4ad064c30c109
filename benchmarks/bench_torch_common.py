"""Shared benchmark utilities of the PyTorch port (counterpart of
``benchmarks/common.py``): timing, CSV output, the paper's protocol.

Every measurement prints one CSV line, ``name,us_per_call,derived``, with
the reference's names, so a port row can be put beside its reference row.
Everything runs on the CUDA card unless the caller passes
``device="cpu"``; nothing falls back to the CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.device import DeviceLike, resolve_device, synchronize

TAU = 0.85  # the paper's target accuracy threshold


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    """One CSV line per measurement: ``name,us_per_call,derived``."""
    print(f"{name},{us_per_call:.2f},{derived}")
    sys.stdout.flush()


class Rows(list):
    """The lines a suite emitted, as dicts: ``name``, ``us_per_call``,
    ``derived``, the values the suite passed, and ``launches``, the kernel
    launches (``repro_torch.kernels.launches()``, nonzero counts only) made
    since the line before it, or since the list was made. A suite passes
    ``kernel_calls``, the launches its line should have made
    (:func:`kernel_launches` times the rounds or calls it ran)."""

    def __init__(self):
        super().__init__()
        self._mark = K.launches()

    def emit(self, name: str, us_per_call: float, derived: str = "",
             **values: Any) -> Dict[str, Any]:
        emit(name, us_per_call, derived)
        now = K.launches()
        self.append({"name": name, "us_per_call": us_per_call,
                     "derived": derived,
                     "launches": {k: v - self._mark[k] for k, v in now.items()
                                  if v != self._mark[k]}, **values})
        self._mark = now
        return self[-1]


def launches_since(mark: Dict[str, int]) -> Dict[str, int]:
    """The kernel launches since ``mark`` (a ``kernels.launches()``
    reading): a bench reads its own without resetting the counters its
    caller may be reading too."""
    return {k: v - mark[k] for k, v in K.launches().items()}


def run_sections(sections, out: Optional[str]) -> Dict[str, Any]:
    """Run ``(name, fn)`` sections in order, the results dict rewritten to
    ``out`` (``None``: nowhere) after each one, so a failed gate still
    leaves the sections before it (the reference benches' ``record``)."""
    results: Dict[str, Any] = {}
    for name, fn in sections:
        try:
            results[name] = fn()
        finally:
            if out:
                os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
                with open(out, "w") as fh:
                    json.dump(results, fh, indent=2, default=float)
    return results


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            device: DeviceLike = None) -> float:
    """Median wall microseconds per call; on the card each call is
    bracketed by ``torch.cuda.synchronize()``."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn(*args)
    times = []
    for _ in range(iters):
        synchronize(dev)
        t0 = time.perf_counter()
        fn(*args)
        synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e6)
    return float(np.median(times))


# --------------------------------------------------------------------------
# the paper's Section-4 protocol: train to tau, report communication bytes
# --------------------------------------------------------------------------

# learning rates tuned per compression ratio under f=0 (the paper's own
# tuning protocol, Section 4)
GAMMA_BY_RATIO: Dict[float, float] = {
    0.01: 0.01, 0.05: 0.05, 0.1: 0.05, 0.3: 0.1, 0.5: 0.1, 1.0: 0.2,
}


def protocol_config(*, ratio: float, f: int, attack: str = "alie",
                    algo: str = "rosdhb", agg: str = "cwtm",
                    n_honest: int = 10, gamma: Optional[float] = None):
    """The ``AlgorithmConfig`` of one (ratio, f) cell of the paper's
    experiment, as the reference's ``comm_cost_to_tau`` builds it."""
    from repro_torch.core import (AggregatorConfig, AlgorithmConfig,
                                  AttackConfig, SparsifierConfig)
    n = n_honest + f
    return AlgorithmConfig(
        name=algo, n_workers=n, f=f,
        gamma=gamma if gamma is not None else GAMMA_BY_RATIO.get(ratio,
                                                                 0.05),
        beta=0.9, sparsifier=SparsifierConfig(kind="randk", ratio=ratio),
        aggregator=(AggregatorConfig(name="mean") if agg == "mean"
                    else AggregatorConfig(name=agg, f=max(f, 1))),
        attack=AttackConfig(name=attack))


def run_protocol(cfg: Any, *, steps: int = 600, per_worker: int = 800,
                 batch: int = 60, seed: int = 0, tau: float = TAU,
                 params0: Any = None, draws: Any = None,
                 device: DeviceLike = None) -> Tuple[Dict, Any]:
    """The run of :func:`comm_cost_to_tau` for ``cfg``
    (:func:`protocol_config`): ``(result, final simulator state)``."""
    from repro_torch.core import Simulator
    from repro_torch.data import SyntheticMNIST
    from repro_torch.models import cnn_accuracy, cnn_init, cnn_loss

    dev = resolve_device(device)
    ds = SyntheticMNIST(n_workers=cfg.n_workers, per_worker=per_worker,
                        seed=seed)
    sim = Simulator(loss_fn=cnn_loss,
                    params0=cnn_init(0) if params0 is None else params0,
                    cfg=cfg, eval_fn=lambda p, b: {"acc": cnn_accuracy(p, b)},
                    device=dev)
    st = sim.init(seed, draws=draws)
    reached = {}

    def stop(m):
        if m.get("acc", 0.0) >= tau and not reached:
            reached["bytes"] = m["comm_bytes"]
        return bool(reached)

    st, hist = sim.run(st, ds.worker_batches(batch), steps=steps,
                       eval_every=20, eval_batch=ds.eval_batch, stop_fn=stop)
    return {
        "ratio": cfg.sparsifier.ratio, "f": cfg.f, "gamma": cfg.gamma,
        "comm_bytes_to_tau": reached.get("bytes", float("inf")),
        "final_acc": hist["acc"][-1] if hist["acc"] else 0.0,
        "rounds": hist["step"][-1] + 1 if hist["step"] else 0,
    }, st


def comm_cost_to_tau(*, ratio: float, f: int, attack: str = "alie",
                     algo: str = "rosdhb", agg: str = "cwtm",
                     n_honest: int = 10, steps: int = 600,
                     per_worker: int = 800, batch: int = 60,
                     gamma: Optional[float] = None, seed: int = 0,
                     tau: float = TAU, params0: Any = None,
                     draws: Any = None, device: DeviceLike = None) -> Dict:
    """Run the paper's experiment for one (ratio, f) cell, as the
    reference's ``comm_cost_to_tau``: ``Simulator.run`` with an eval record
    every 20 rounds and the last, every round run, and ``stop_fn`` honoured
    post-hoc (the history ends at the first record at or past ``tau``).

    ``params0`` (default ``cnn_init(0)``) and ``draws`` (default the
    simulator's ``TorchDraws(seed)``) let a parity test carry the
    reference's parameters and RandK draws across; ``device`` defaults to
    the card.

    Returns dict with comm bytes to reach tau (or inf), final accuracy,
    rounds used.
    """
    cfg = protocol_config(ratio=ratio, f=f, attack=attack, algo=algo,
                          agg=agg, n_honest=n_honest, gamma=gamma)
    return run_protocol(cfg, steps=steps, per_worker=per_worker,
                        batch=batch, seed=seed, tau=tau, params0=params0,
                        draws=draws, device=device)[0]


def kernel_launches(agg: Any, calls: int,
                    device: DeviceLike = None) -> Dict[str, int]:
    """The kernel launches ``calls`` calls of the aggregator ``agg`` (an
    ``AggregatorConfig``) make on ``device`` (``make_aggregator``'s kernel
    path): on the card one pairdist for NNM or (Multi-)Krum, one CWTM or
    median, none for the mean and the geometric median; none on the
    CPU."""
    if not agg.use_kernels or resolve_device(device).type != "cuda":
        return {}
    per = {"pairdist": (agg.pre_nnm and agg.name != "mean")
           or agg.name in ("krum", "multikrum"),
           "cwtm": agg.name == "cwtm", "median": agg.name == "median"}
    return {k: calls for k, v in per.items() if v and calls}


# --------------------------------------------------------------------------
# the hand-driven server loop of the sparsification and breakdown studies
# --------------------------------------------------------------------------


def quadratic_targets(n: int, d: int, spread: float, targets: Any = None,
                      device: DeviceLike = None) -> torch.Tensor:
    """Worker optima ``N(0, 1) * spread + 1`` from a ``torch.Generator``
    seeded with 1 (the reference draws them with
    ``jax.random.normal(PRNGKey(1), (n, d))``); ``targets`` replaces the
    draw."""
    dev = resolve_device(device)
    if targets is None:
        gen = torch.Generator().manual_seed(1)
        return (torch.randn((n, d), generator=gen) * spread + 1.0).to(dev)
    tg = torch.as_tensor(np.array(targets, np.float32))
    if tuple(tg.shape) != (n, d):
        raise ValueError(f"targets of shape {tuple(tg.shape)}, expected "
                         f"{(n, d)}")
    return tg.to(dev)


def server_loop(cfg: Any, targets: torch.Tensor, steps: int,
                draws: Any) -> torch.Tensor:
    """``steps`` rounds of ``server_round`` on the quadratic gradients
    ``theta - t_i`` from ``theta = 0``, each followed by
    ``apply_direction``, as the reference's hand-written loop; returns the
    final ``theta``."""
    from repro_torch.core import (apply_direction, init_state,
                                  make_aggregator, server_round)
    dev = targets.device
    d = targets.shape[1]
    agg = make_aggregator(cfg.aggregator, device=dev)
    st = init_state(cfg, d, device=dev)
    th = torch.zeros(d, device=dev)
    for _ in range(steps):
        r, st, _ = server_round(cfg, st, th[None, :] - targets, draws,
                                agg=agg)
        th = apply_direction(th, r, cfg.gamma)
    return th
