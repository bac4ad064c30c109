"""Paper Figure 1 on the PyTorch port (counterpart of
``benchmarks/bench_fig1.py``): communication cost to reach tau = 0.85 as a
function of the compression ratio, under the ALIE attack with varying
Byzantine counts.

Quick mode (default, used by ``benchmarks.bench_torch_run``): ratios
{0.05, 1.0} x f in {0, 5}. Full mode (--full): ratios {0.01, 0.05, 0.1,
0.3, 0.5, 1.0} x f in {0, 1, 3, 5, 9} — the paper's grid. The rows go to
``results/fig1_torch_quick.json`` or ``results/fig1_torch_full.json``
(never the reference's ``results/fig1_*.json``), each with the device it
ran on::

    PYTHONPATH=src:. python -m benchmarks.bench_torch_fig1 [--full] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Optional

import torch

from benchmarks.bench_torch_common import (Rows, comm_cost_to_tau,
                                           kernel_launches, protocol_config)
from repro_torch.device import DeviceLike, resolve_device

RESULTS = Path(__file__).resolve().parents[1] / "results"


def out_path(full: bool) -> Path:
    """The port's own result file of the quick or the full grid."""
    return RESULTS / ("fig1_torch_full.json" if full
                      else "fig1_torch_quick.json")


def run(full: bool = False, out: Optional[str] = None,
        device: DeviceLike = None) -> Rows:
    dev = resolve_device(device)
    ratios = [0.01, 0.05, 0.1, 0.3, 0.5, 1.0] if full else [0.05, 1.0]
    fs = [0, 1, 3, 5, 9] if full else [0, 5]
    steps = 600 if full else 400
    rows = Rows()
    base = {}
    for f in fs:
        for ratio in ratios:
            t0 = time.perf_counter()
            r = comm_cost_to_tau(ratio=ratio, f=f, attack="alie",
                                 steps=steps, device=dev)
            wall = (time.perf_counter() - t0) * 1e6
            key = (f,)
            if ratio == 1.0:
                base[key] = r["comm_bytes_to_tau"]
            saving = ""
            if key in base and base[key] not in (0, float("inf")) \
                    and r["comm_bytes_to_tau"] != float("inf"):
                saving = "saving=%.1f%%" % (
                    100 * (1 - r["comm_bytes_to_tau"] / base[key]))
            rows.emit(f"fig1/ratio={ratio}/f={f}", wall,
                      f"bytes_to_tau={r['comm_bytes_to_tau']:.3g} "
                      f"acc={r['final_acc']:.3f} rounds={r['rounds']} "
                      f"{saving}", steps=steps,
                      kernel_calls=kernel_launches(protocol_config(
                          ratio=ratio, f=f).aggregator, steps, dev), **r)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        with open(out, "w") as fh:
            json.dump([{**{k: row[k] for k in ("ratio", "f", "gamma",
                                                "comm_bytes_to_tau",
                                                "final_acc", "rounds")},
                        "wall_us": row["us_per_call"], "device": name}
                       for row in rows], fh, indent=2)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--full", action="store_true")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)
    run(full=args.full, out=str(out_path(args.full)), device=args.device)


if __name__ == "__main__":
    main()
