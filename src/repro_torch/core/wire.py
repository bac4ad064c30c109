"""Uplink wire-format accounting (counterpart of ``repro.core.wire``).

* ``rosdhb`` / ``dgd`` — the sparsified gradient: ``k`` values; index bytes
  only for local masks (a global mask is a shared draw: 0 wire bytes).
* ``robust_dgd`` — the raw gradient: ``d`` values, no indices.
* ``dasha`` — the compressed per-worker momentum difference from an
  independent compressor per worker: ``k`` values plus their indices.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import compression as C

#: Algorithms with a well-defined single-worker uplink format.
WIRE_ALGORITHMS = ("rosdhb", "dasha", "robust_dgd", "dgd")


def per_worker_payload_bytes(algo: str, d: int, sp: C.SparsifierConfig,
                             bytes_per_value: int = 4) -> int:
    """Uplink bytes ONE worker sends per round under ``algo``'s wire format
    (``d`` is the true model dimension, unpadded)."""
    if algo == "robust_dgd":
        return d * bytes_per_value
    if algo in ("rosdhb", "dgd"):
        return C.payload_bytes(d, sp, bytes_per_value=bytes_per_value,
                               with_mask_indices=True)
    if algo == "dasha":
        return C.payload_bytes(d, dataclasses.replace(sp, local=True),
                               bytes_per_value=bytes_per_value,
                               with_mask_indices=True)
    raise ValueError(
        f"no single wire format for algorithm {algo!r} (expected one of "
        f"{'|'.join(WIRE_ALGORITHMS)})")


def round_payload_bytes(algo: str, d: int, sp: C.SparsifierConfig,
                        n_workers: int, bytes_per_value: int = 4) -> int:
    """Total uplink bytes per round across all ``n_workers``."""
    return per_worker_payload_bytes(algo, d, sp, bytes_per_value) * n_workers
