#!/usr/bin/env python3
"""Time the port's aggregation kernels (pairdist, CWTM, median) of several
source trees on one CUDA card, each tree in its own process.

Usage, from the repository root, on a machine with an NVIDIA card and the
CUDA toolkit::

    python3 benchmarks/bench_torch_aggregation.py SRC [SRC ...]

Each ``SRC`` is a ``src`` directory that holds a ``repro_torch`` package (this
checkout's ``src``, or an unpacked ``git archive`` of another commit); give
them in turns, e.g. ``OLD NEW NEW OLD``, to compare two commits on the same
card. For every tree and each of the main paths' shapes (``[1, 13, 11958]``,
``[1, 13, 1048576]``, ``[8, 13, 1048576]``, and CWTM at ``[1, 8, 416179200]``)
it prints one JSON line with the kernel's and the library call's
(``torch.cdist``, ``torch.median``) loop time, host µs per call and device µs
and device kernels per call, measured as ``chip_smoke.py`` measures them
(``split_times``, then ``device_us``), and the card's name and power limit.
It uses only the wrappers' public calls, so it also runs on older trees of
the port. Exits 1 without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [("pairdist", (1, 13, 11958), 3), ("pairdist", (1, 13, 1048576), 3),
          ("pairdist", (8, 13, 1048576), 3), ("cwtm", (1, 13, 11958), 3),
          ("cwtm", (1, 13, 1048576), 3), ("cwtm", (8, 13, 1048576), 3),
          ("cwtm", (1, 8, 416179200), 1), ("median", (1, 13, 11958), 3),
          ("median", (1, 13, 1048576), 3), ("median", (8, 13, 1048576), 3)]


def one(src: str) -> None:
    """Time every case with the ``repro_torch`` of ``src``; one JSON line
    per case."""
    import torch
    sys.path.insert(0, str(Path(src).resolve()))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build
    build.build(["pairdist", "sorted_weight"])
    card = cs.gpu_line()
    for i, (name, shape, f) in enumerate(SHAPES):
        x, kern, _, lib = cs.case_fns(torch, name, shape, f, torch.float32,
                                      seed=700 + i)
        reps = cs.case_reps(shape)
        fns = {"kernel": kern, "library": lib} if lib else {"kernel": kern}
        kern(), torch.cuda.synchronize()
        rec = {"src": src, "name": name, "shape": list(shape), "card": card,
               **cs.split_times(torch, fns, reps)}
        rec["bound_ms"], rec["bound_by"] = cs.bound_ms(name, shape, 4)
        print(json.dumps(rec), flush=True)
        del x, kern, lib, fns
        torch.cuda.empty_cache()
    # the profiler last: it slows the launches that follow it
    for i, (name, shape, f) in enumerate(SHAPES):
        x, kern, _, lib = cs.case_fns(torch, name, shape, f, torch.float32,
                                      seed=700 + i)
        reps = cs.case_reps(shape)
        out = {"src": src, "name": name, "shape": list(shape)}
        for who, fn in (("kernel", kern), ("library", lib)):
            if fn is not None:
                us, ops, names = cs.device_us(torch, fn, reps)
                out[who] = {"device_us": us, "device_ops": ops,
                            "names": names}
        print(json.dumps(out), flush=True)
        del x, kern, lib
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        one(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    for src in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", src], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
