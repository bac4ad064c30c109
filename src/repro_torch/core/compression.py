"""Coordinated and local gradient sparsification (counterpart of
``repro.core.compression``).

Ported kinds: ``randk`` (exact RandK, ``k`` distinct coordinates), ``bernoulli``
(per-coordinate Bernoulli(k/d)), ``block`` (Block-RandK: ``kb`` of the
``d/block_size`` aligned blocks), ``block_hash`` (each block kept with
probability ``ratio`` by an integer hash of its id and a per-round seed) and
``none``. Masks are **global** (one per round, shared by every worker:
Algorithm 1) or **local** (one per worker: RoSDHB-Local). The random draws
come from a draws provider (``repro_torch.testing``), never from a global
generator.

Compression is simulated densely, as in the reference: :func:`compress`
returns the server-side unbiased reconstruction ``(d/k) * (g * mask)`` and
:func:`payload_bytes` accounts for what the wire would carry. For ``block``
with ``use_kernels``, :func:`compressed_estimate` runs the real wire round
trip instead: the Block-RandK compress and decompress kernels
(``repro_torch.kernels.randk``); :func:`compressed_payload` stops at the
wire, for the RoSDHB round that updates its momentum from the payload.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.kernels.randk import ops as RK

#: Kinds this module can sample; the reference's ``natural`` kind and its
#: traced ratios are still to be ported.
PORTED_KINDS = ("randk", "bernoulli", "block", "block_hash", "none")


@dataclasses.dataclass(frozen=True)
class SparsifierConfig:
    """Configuration of the RandK-family sparsifier.

    Attributes:
      kind: ``randk`` | ``bernoulli`` | ``block`` | ``block_hash`` |
        ``none``.
      ratio: compression ratio ``k/d`` in (0, 1]; ``alpha = 1/ratio``.
      block_size: block width of the ``block`` and ``block_hash`` kinds.
      local: each worker samples its own mask (RoSDHB-Local) instead of one
        global mask shared by all (RoSDHB).
      use_kernels: for ``block`` with ``d % block_size == 0`` and a ratio
        below 1, run the Block-RandK compress -> decompress round trip over
        the wire payload (``repro_torch.kernels.randk``: the CUDA kernels on
        the card, their plain versions on the CPU) instead of the dense
        mask multiply -- the counterpart of the reference's ``use_pallas``.
        The two are bitwise equal on finite gradients.
    """

    kind: str = "bernoulli"
    ratio: float = 1.0
    block_size: int = 512
    local: bool = False
    use_kernels: bool = True

    @property
    def alpha(self) -> float:
        return 1.0 / self.ratio

    def k(self, d: int) -> int:
        return max(1, int(round(self.ratio * d)))


def _block_mask(draws, d: int, ratio: float, block: int,
                dtype: torch.dtype) -> torch.Tensor:
    """``kb = round(ratio * nb)`` of the ``nb = ceil(d / block)`` blocks,
    from a permutation prefix of the block ids."""
    nb = -(-d // block)
    kb = max(1, int(round(ratio * nb)))
    bmask = torch.zeros((nb,), dtype=dtype, device=draws.device)
    bmask[draws.permutation_prefix(nb, kb)] = 1
    return bmask.repeat_interleave(block)[:d]


_U32 = 0xFFFFFFFF


def _block_hash_mask(seed: int, d: int, ratio: float, block: int,
                     dtype: torch.dtype, device) -> torch.Tensor:
    """Counter-based Bernoulli(ratio) block mask: the reference's murmur-style
    uint32 hash of (block id, per-round seed), bit for bit. The hash depends
    on the block id only, so it is taken once per block (int64 arithmetic
    kept to the low 32 bits) and repeated over the block."""
    nb = -(-d // block)
    h = torch.arange(nb, dtype=torch.int64, device=device)
    h = (h * 0x9E3779B1 + int(seed)) & _U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    h ^= h >> 16
    u = h.to(torch.float32) * (1.0 / 4294967296.0)
    keep = (u < torch.tensor(ratio, dtype=torch.float32)).to(dtype)
    return keep.repeat_interleave(block)[:d]


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
    if cfg.kind == "block":
        return _block_mask(draws, d, cfg.ratio, cfg.block_size, dtype)
    if cfg.kind == "block_hash":
        return _block_hash_mask(draws.bits_u32(), d, cfg.ratio,
                                cfg.block_size, dtype, dev)
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


def _kernel_eligible(cfg: SparsifierConfig, d: int) -> bool:
    """Only exact Block-RandK with a ratio below 1 and block-aligned ``d``
    has the kernel round trip; everything else takes the dense path."""
    return (cfg.use_kernels and cfg.kind == "block" and cfg.ratio < 1.0
            and d % cfg.block_size == 0)


def block_ids(draws, n: int, d: int, cfg: SparsifierConfig
              ) -> torch.Tensor:
    """The round's Block-RandK block ids, drawn exactly as
    :func:`_block_mask` draws them: ``[kb]`` (one permutation prefix shared
    by every row) for a global mask, ``[n, kb]`` (one per worker, in worker
    order) for local masks. ``d`` is a multiple of the block."""
    nb = d // cfg.block_size
    kb = max(1, int(round(cfg.ratio * nb)))
    if cfg.local:
        return torch.stack([draws.permutation_prefix(nb, kb)
                            for _ in range(n)])
    return draws.permutation_prefix(nb, kb)


def compressed_payload(grads: torch.Tensor, draws, cfg: SparsifierConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-3 on the real wire: the round's block ids
    (:func:`block_ids`) and the ``[n, kb * block_size]`` payload of
    ``alpha * g`` on those blocks (the compress kernel). For an eligible
    ``block`` config (:func:`_kernel_eligible`)."""
    ids = block_ids(draws, grads.shape[0], grads.shape[1], cfg)
    return RK.compress(grads, ids, block_size=cfg.block_size,
                       alpha=cfg.alpha), ids


def compressed_estimate(grads: torch.Tensor, draws,
                        cfg: SparsifierConfig) -> torch.Tensor:
    """Steps 1+4: sample the round's masks and return the unbiased
    reconstruction of the ``[n, d]`` gradient bank.

    The dense path is :func:`make_masks` + :func:`compress`. For an eligible
    ``block`` config (:func:`_kernel_eligible`) the round trip runs over the
    real wire payload instead (:func:`compressed_payload`), and the
    decompress kernel scatters it back into a dense bank. Bitwise the dense
    path on finite gradients (the kernel writes +0.0 where
    ``(alpha * g) * 0`` may give -0.0)."""
    n, d = grads.shape
    if not _kernel_eligible(cfg, d):
        return compress(grads, make_masks(draws, n, d, cfg,
                                          dtype=grads.dtype), cfg)
    payload, ids = compressed_payload(grads, draws, cfg)
    return RK.decompress(payload, ids, block_size=cfg.block_size, d=d)


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
