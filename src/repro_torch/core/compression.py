"""Coordinated and local gradient sparsification (counterpart of
``repro.core.compression``).

Ported kinds: ``randk`` (exact RandK, ``k`` distinct coordinates), ``bernoulli``
(per-coordinate Bernoulli(k/d)) and ``none``. Masks are **global** (one per
round, shared by every worker: Algorithm 1) or **local** (one per worker:
RoSDHB-Local). The random draws come from a draws provider
(``repro_torch.testing``), never from a global generator.

Compression is simulated densely, as in the reference: :func:`compress`
returns the server-side unbiased reconstruction ``(d/k) * (g * mask)`` and
:func:`payload_bytes` accounts for what the wire would carry.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: Kinds this module can sample; the reference's ``block``, ``block_hash``
#: and ``natural`` kinds are still to be ported.
PORTED_KINDS = ("randk", "bernoulli", "none")


@dataclasses.dataclass(frozen=True)
class SparsifierConfig:
    """Configuration of the RandK-family sparsifier.

    Attributes:
      kind: ``randk`` | ``bernoulli`` | ``none``.
      ratio: compression ratio ``k/d`` in (0, 1]; ``alpha = 1/ratio``.
      local: each worker samples its own mask (RoSDHB-Local) instead of one
        global mask shared by all (RoSDHB).
    """

    kind: str = "bernoulli"
    ratio: float = 1.0
    local: bool = False

    @property
    def alpha(self) -> float:
        return 1.0 / self.ratio

    def k(self, d: int) -> int:
        return max(1, int(round(self.ratio * d)))


def make_mask(draws, d: int, cfg: SparsifierConfig,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One sparsification mask ``[d]`` on the draws provider's device."""
    dev = draws.device
    if cfg.kind == "none" or cfg.ratio >= 1.0:
        return torch.ones((d,), dtype=dtype, device=dev)
    if cfg.kind == "randk":
        idx = draws.permutation_prefix(d, cfg.k(d))
        mask = torch.zeros((d,), dtype=dtype, device=dev)
        mask[idx] = 1
        return mask
    if cfg.kind == "bernoulli":
        return (draws.uniform((d,)) < cfg.ratio).to(dtype)
    raise ValueError(f"sparsifier kind {cfg.kind!r} is not ported "
                     f"(ported: {'|'.join(PORTED_KINDS)})")


def make_masks(draws, n_workers: int, d: int, cfg: SparsifierConfig,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Masks for ``n_workers``: ``[d]`` for a global mask (broadcast over the
    worker axis by :func:`compress`), ``[n_workers, d]`` for local masks (one
    draw per worker, in worker order)."""
    if not cfg.local:
        return make_mask(draws, d, cfg, dtype)
    return torch.stack([make_mask(draws, d, cfg, dtype)
                        for _ in range(n_workers)])


def compress(g: torch.Tensor, mask: torch.Tensor,
             cfg: SparsifierConfig) -> torch.Tensor:
    """Server-side unbiased reconstruction ``(alpha * g) * mask``, in the
    reference's operation order (so the result is bitwise the same)."""
    if cfg.kind == "none" or cfg.ratio >= 1.0:
        return g
    return (cfg.alpha * g) * mask


def compressed_estimate(grads: torch.Tensor, draws,
                        cfg: SparsifierConfig) -> torch.Tensor:
    """Steps 1+4: sample the round's masks and return the unbiased
    reconstruction of the ``[n, d]`` gradient bank (dense path)."""
    n, d = grads.shape
    return compress(grads, make_masks(draws, n, d, cfg, dtype=grads.dtype),
                    cfg)


def payload_floats(d: int, cfg: SparsifierConfig) -> int:
    """Number of float values one worker sends per round."""
    if cfg.kind == "none" or cfg.ratio >= 1.0:
        return d
    return cfg.k(d)


def index_bytes(d: int) -> int:
    """Bytes needed to address one of ``d`` coordinates:
    ``ceil(log2(d) / 8)``, at least 1."""
    if d < 2:
        return 1
    return max(1, math.ceil(math.log2(d) / 8.0))


def payload_bytes(d: int, cfg: SparsifierConfig, bytes_per_value: int = 4,
                  with_mask_indices: bool = False) -> int:
    """Per-worker uplink bytes per round. A global mask is a shared draw and
    costs no index bytes; a local mask charges :func:`index_bytes` per index
    when ``with_mask_indices``."""
    k = payload_floats(d, cfg)
    b = k * bytes_per_value
    if with_mask_indices and cfg.local and cfg.ratio < 1.0:
        b += k * index_bytes(d)
    return b
