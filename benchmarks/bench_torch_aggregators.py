"""Aggregator microbenchmarks on the PyTorch port (counterpart of
``benchmarks/bench_aggregators.py``): wall time of each (f,kappa)-robust
rule on a server-scale bank [n=20, d=1e6]. On a CUDA tensor
``make_aggregator`` runs the port's kernels: CWTM and the median on
``csrc/sorted_weight.cu``, Krum's and NNM's distances on
``csrc/pairdist.cu``; the mean and the geometric median are PyTorch
operations::

    PYTHONPATH=src:. python -m benchmarks.bench_torch_aggregators \\
        [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from benchmarks.bench_torch_common import Rows, kernel_launches, time_fn
from repro_torch.core import AggregatorConfig, make_aggregator
from repro_torch.device import DeviceLike, resolve_device

WARMUP = 2  # time_fn's untimed calls


def rules(f: int):
    """``(label, config, timed calls)`` of each rule, in the reference's
    order: the five rules, then the NNM-composed CWTM (the optimal-kappa
    configuration)."""
    return ([(name, AggregatorConfig(name=name, f=f), 5)
             for name in ["mean", "cwtm", "median", "geomed", "krum"]]
            + [("cwtm+nnm", AggregatorConfig(name="cwtm", f=f, pre_nnm=True),
                3)])


def server_bank(n: int, d: int, device: DeviceLike = None) -> torch.Tensor:
    """The ``[n, d]`` float32 bank the rules are timed on, N(0, 1) from a
    ``torch.Generator`` seeded with 0."""
    return torch.randn((n, d), generator=torch.Generator().manual_seed(0),
                       dtype=torch.float32).to(resolve_device(device))


def run(d: int = 1_000_000, n: int = 20, f: int = 4,
        device: DeviceLike = None) -> Rows:
    dev = resolve_device(device)
    x = server_bank(n, d, dev)
    rows = Rows()
    for label, cfg, iters in rules(f):
        agg = make_aggregator(cfg, device=dev)
        us = time_fn(agg, x, iters=iters, warmup=WARMUP, device=dev)
        derived, extra = f"kappa<={cfg.kappa_bound(n):.3f}", {}
        if not cfg.pre_nnm:  # the reference reports GB/s for the five rules
            extra["gb_per_s"] = (x.numel() * 4 / (us / 1e6)) / 1e9
            derived = f"GB/s={extra['gb_per_s']:.2f} {derived}"
        rows.emit(f"aggregators/{label}/n{n}_d{d}", us, derived,
                  kernel_calls=kernel_launches(cfg, WARMUP + iters, dev),
                  **extra)
    return rows


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(device=p.parse_args().device)
