"""Structured training metrics: JSONL writer + console mirror (counterpart of
``repro.utils.logging``; no external trackers)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics with wall-clock stamps.

    >>> log = MetricsLogger("runs/exp1/metrics.jsonl", console=True)
    >>> log.write(step=10, loss=2.3, acc=0.41)
    """

    def __init__(self, path: Optional[str] = None, console: bool = True):
        self.path = path
        self.console = console
        self._fh = None
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def write(self, step: int, **metrics: Any) -> Dict[str, Any]:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.console:
            body = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else
                            f"{k}={v}" for k, v in rec.items()
                            if k not in ("step", "wall_s"))
            print(f"[metrics] step {rec['step']:6d} ({rec['wall_s']:8.1f}s) "
                  f"{body}")
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
