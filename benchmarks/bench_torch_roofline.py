#!/usr/bin/env python3
"""Roofline report of the PyTorch port (counterpart of
``benchmarks/bench_roofline.py``): reads the dry run's JSON
(``python -m repro_torch.launch.dryrun --all --out
results/dryrun_torch.json``) and prints the three-term roofline of every
(arch x shape) on one card, with the state one card holds in place of the
reference's compiled peak (a floor of the step's peak: ``state fits`` says
that the state fits 80 GB, which a fit of the step needs).

    python3 benchmarks/bench_torch_roofline.py [--markdown] [PATH]
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path
from typing import List, Optional

if __package__ in (None, ""):
    _ROOT = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from benchmarks.bench_torch_common import emit  # noqa: E402

DEFAULT = "results/dryrun_torch.json"


def load(path: str = DEFAULT) -> Optional[List[dict]]:
    """The dry run's reports, or ``None`` when the file is missing."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        data = json.load(f)
    return data["reports"] if isinstance(data, dict) else data


def run(path: str = DEFAULT, markdown: bool = False) -> Optional[List[dict]]:
    """Print the table (CSV lines, or a markdown table); returns the
    reports that are ``ok``."""
    reports = load(path)
    if reports is None:
        emit("roofline/missing", 0.0, f"run dryrun --all first ({path})")
        return None
    ok = [r for r in reports if r.get("ok")]
    if markdown:
        print("| arch | shape | mesh | compute ms | memory ms | collective "
              "ms | bottleneck | state GiB | state fits | useful FLOPs |")
        print("|---|---|---|---|---|---|---|---|---|---|")
    for r in ok:
        rf = r["roofline"]
        state = r["state_bytes_total"] / 2**30
        uf = rf.get("useful_flops_fraction")
        ufs = "n/a" if uf is None else f"{uf:.3f}"
        if markdown:
            print(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                  f"| {rf['compute_s']*1e3:.3f} | {rf['memory_s']*1e3:.3f} "
                  f"| {rf['collective_s']*1e3:.3f} | {rf['bottleneck']} "
                  f"| {state:.2f} | {r['state_fits']} | {ufs} |")
        else:
            emit(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}",
                 rf["compute_s"] * 1e6,
                 f"mem_us={rf['memory_s']*1e6:.1f} "
                 f"coll_us={rf['collective_s']*1e6:.1f} "
                 f"bottleneck={rf['bottleneck']} stateGiB={state:.2f} "
                 f"state_fits={r['state_fits']} useful={ufs}")
    for r in reports:
        if not r.get("ok"):
            emit(f"roofline/{r['arch']}/{r['shape']}/{r['mesh']}", 0.0,
                 "FAILED")
    return ok


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    markdown = "--markdown" in argv
    paths = [a for a in argv if a != "--markdown"]
    run(paths[0] if paths else DEFAULT, markdown=markdown)
    return 0


if __name__ == "__main__":
    sys.exit(main())
