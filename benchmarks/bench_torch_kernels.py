#!/usr/bin/env python3
"""Batched robust-aggregation pass benchmarks of the PyTorch port at the
grid engine's shapes (counterpart of ``benchmarks/bench_kernels.py``).

The hot path under test is the one the grid engine runs: a ``[B, n, d]``
stack of worker gradients (``B = n_cells * n_seeds`` lanes) reduced to
``[B, d]`` a round, per aggregation rule. For every rule of the reference's
``RULES`` (CWTM, the median, Krum, and CWTM after NNM, which runs the
pairdist kernel) it times

* the plain PyTorch rules (``use_kernels=False``), which stand for the
  reference's jnp path, and
* the dispatch path (``use_kernels=True``): the CUDA kernels on the card,
  the same plain rules on the CPU,

warm, and records the bytes moved, the achieved GB/s and the roofline
floor of ``repro_torch.launch.roofline.aggregation_roofline``. The row
fields are the reference's: ``jnp_us`` is the plain rules' time and
``dispatch_us`` the dispatch path's.

Gates (written into ``results/BENCH_torch_kernels.json``, and only there):

* everywhere: dispatch parity, the dispatch path within rel 1e-5 of the
  plain rules at every shape (on the CPU the same rules, but for NNM's
  distances and mixing product, which the kernel path takes from pairdist's
  plain version);
* on the card: the kernel path never slower than 0.95x the plain rules at
  the Table-1 shape, and faster at ``d >= 1e6``.

Shapes: the reference's, Table-1's quadratic grid (B = 84 lanes, n = 13,
d = 64), the CNN's (d = 33,450) and an LLM block's (B = 8, d = 1,048,576).
The reference's single-op micro timings become the port's plain
``block_compress`` at d = 2^20 and the plain attention at S = 1024.

Usage, from the repository root (the card unless ``--device cpu``)::

    python3 benchmarks/bench_torch_kernels.py [--device cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

if __package__ in (None, ""):
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

import torch  # noqa: E402

from benchmarks.bench_torch_common import emit, time_fn  # noqa: E402
from repro_torch.device import DeviceLike, resolve_device  # noqa: E402

OUT = "results/BENCH_torch_kernels.json"

#: (label, B, n, f, d, iters): B is the fused n_cells * n_seeds axis.
SHAPES = (
    ("table1", 84, 13, 3, 64, 20),
    ("cnn", 12, 13, 3, 33_450, 10),
    ("llm1m", 8, 13, 3, 1_048_576, 3),
)

RULES = (
    ("cwtm", False),
    ("median", False),
    ("krum", False),
    ("cwtm", True),  # NNM pre-aggregation exercises the pairdist kernel
)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them, or
    ``cpu``."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _agg(name: str, f: int, pre_nnm: bool, use_kernels: bool, dev):
    from repro_torch.core import aggregators as G
    return G.make_aggregator(G.AggregatorConfig(
        name=name, f=f, pre_nnm=pre_nnm, use_kernels=use_kernels),
        device=dev)


def bench_rule(name: str, pre_nnm: bool, *, shape, spec, dev) -> dict:
    from repro_torch.launch.roofline import aggregation_roofline
    label, b, n, f, d, iters = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, n, d), generator=gen, device=dev)
    plain_fn = _agg(name, f, pre_nnm, False, dev)
    auto_fn = _agg(name, f, pre_nnm, True, dev)

    y_plain, y_auto = plain_fn(x), auto_fn(x)
    scale = float(y_plain.abs().max()) + 1e-12
    parity = float((y_plain - y_auto).abs().max()) / scale

    us_plain = time_fn(plain_fn, x, iters=iters, device=dev)
    us_auto = time_fn(auto_fn, x, iters=iters, device=dev)

    rl = aggregation_roofline(batch=b, n=n, d=d, spec=spec)
    bytes_moved = b * (n * d + d) * 4
    gbs = bytes_moved / (us_auto / 1e6) / 1e9
    floor_us = rl.memory_s * 1e6
    rule = f"{name}{'+nnm' if pre_nnm else ''}"
    emit(f"kernels/{rule}/{label}", us_auto,
         f"jnp={us_plain:.1f}us speedup={us_plain / us_auto:.2f}x "
         f"GB/s={gbs:.1f} floor={floor_us:.1f}us parity={parity:.1e}")
    return {
        "shape": {"B": b, "n": n, "f": f, "d": d},
        "backend": "cuda" if dev.type == "cuda" else "plain",
        "jnp_us": us_plain, "dispatch_us": us_auto,
        "speedup_vs_jnp": us_plain / us_auto,
        "bytes_moved": bytes_moved, "achieved_gb_s": gbs,
        "roofline_floor_us": floor_us,
        "roofline_bottleneck": rl.bottleneck,
        "floor_ratio": us_auto / floor_us if floor_us > 0 else None,
        "dispatch_parity_rel": parity,
        "parity_ok": bool(parity <= 1e-5),
        # speed gates only where the kernels are live (the card); on the
        # CPU the dispatch path is the plain path and the ratios are noise
        "gated": dev.type == "cuda",
    }


def legacy_micro(results: dict, dev, d: int = 1 << 20,
                 seq: int = 1024) -> dict:
    """The reference's single-op micro timings on the port's plain
    versions: ``block_compress_ref`` of a ``[1, d]`` row (every 16th of
    its 512-wide blocks, alpha 16) and the plain attention at ``[1, seq,
    8, 64]`` queries over ``[1, seq, 2, 64]`` keys and values."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.randk import block_compress_ref
    gen = torch.Generator(device=dev).manual_seed(0)
    bs = 512
    g = torch.randn((1, d), generator=gen, device=dev)
    idx = torch.arange(0, d // bs, 16, dtype=torch.int32, device=dev)
    us = time_fn(lambda a: block_compress_ref(a, idx, bs, 16.0), g, iters=5,
                 device=dev)
    emit(f"kernels/randk_compress_ref/"
         f"d{f'{d >> 20}M' if d >= 1 << 20 else d}", us,
         f"k={idx.shape[0] * bs}")
    results["randk_compress_ref_us"] = us
    q = torch.randn((1, seq, 8, 64), generator=gen, device=dev)
    k = torch.randn((1, seq, 2, 64), generator=gen, device=dev)
    us = time_fn(lambda a, b2: attention_ref(a, b2, b2), q, k, iters=3,
                 device=dev)
    emit(f"kernels/attention_ref/s{seq}", us, "")
    results["attention_ref_us"] = us
    return results


def run(out: Optional[str] = OUT, hardware: Optional[str] = None,
        device: DeviceLike = None, shapes=SHAPES, micro=None) -> dict:
    """Every rule at every shape on ``device`` (default the card), the
    gates, and the micro timings (``micro``: ``legacy_micro``'s ``(d,
    seq)``); writes ``out`` (``None``: nothing). Raises ``SystemExit`` on a
    gate failure, after writing."""
    from repro_torch.launch.roofline import detect_hardware
    dev = resolve_device(device)
    spec = detect_hardware(hardware)
    torch.zeros(1, device=dev)  # the device's start-up outside the timings
    results = {"hardware": spec.name, "card": card_line(dev),
               "device": (torch.cuda.get_device_name(dev)
                          if dev.type == "cuda" else "cpu"),
               "backend": "cuda" if dev.type == "cuda" else "plain",
               "aggregation": {}}

    def flush():
        if out:
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
            with open(out, "w") as fh:
                json.dump(results, fh, indent=2)

    failures = []
    try:
        for shape in shapes:
            for name, pre in RULES:
                rule = f"{name}{'+nnm' if pre else ''}"
                row = bench_rule(name, pre, shape=shape, spec=spec, dev=dev)
                results["aggregation"][f"{rule}/{shape[0]}"] = row
                if not row["parity_ok"]:
                    failures.append(
                        f"{rule}/{shape[0]}: dispatch parity "
                        f"{row['dispatch_parity_rel']:.2e} > 1e-5")
                if row["gated"]:
                    # never slower at Table-1, faster at d >= 1e6
                    if shape[0] == "table1" and row["speedup_vs_jnp"] < 0.95:
                        failures.append(
                            f"{rule}/table1: kernel path slower than the "
                            f"plain rules ({row['speedup_vs_jnp']:.2f}x)")
                    if shape[4] >= 1_000_000 and row["speedup_vs_jnp"] <= 1.0:
                        failures.append(
                            f"{rule}/{shape[0]}: no speedup at d>=1e6 "
                            f"({row['speedup_vs_jnp']:.2f}x)")
        legacy_micro(results, dev, *(micro or ()))
        results["gates"] = {"ok": not failures, "failures": failures,
                            "perf_gated": dev.type == "cuda"}
    finally:
        flush()
    if failures:
        raise SystemExit("bench_torch_kernels gate failures:\n  "
                         + "\n  ".join(failures))
    return results


def main(argv=None):
    from repro_torch.launch.roofline import KNOWN_HARDWARE
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--hardware", default=None,
                   choices=[None] + sorted(KNOWN_HARDWARE),
                   help="roofline hardware spec (default: detect the card)")
    p.add_argument("--out", default=OUT)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    return run(out=args.out, hardware=args.hardware, device=args.device)


if __name__ == "__main__":
    main()
