"""Coordinated and local gradient sparsification (counterpart of
``repro.core.compression``).

Kinds: ``randk`` (exact RandK, ``k`` distinct coordinates), ``bernoulli``
(per-coordinate Bernoulli(k/d)), ``block`` (Block-RandK: ``kb`` of the
``d/block_size`` aligned blocks), ``block_hash`` (each block kept with
probability ``ratio`` by an integer hash of its id and a per-round seed),
``natural`` (the paper's Appendix-C natural compression: stochastic
power-of-two rounding, whose "mask" is a uniform ``[d]`` draw) and
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
It is two steps, which a caller may also take apart: the round's block ids
(:func:`block_ids`, drawn first) and each row compressed into its payload
row (:func:`compress_rows`; the LLM train step compresses a worker's row as
soon as its gradient exists, ``launch.steps``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.randk import ops as RK
from repro_torch.utils.dtypes import is_float8, lowp

#: Kinds this module can sample.
KINDS = ("randk", "bernoulli", "block", "block_hash", "natural", "none")


@dataclasses.dataclass(frozen=True)
class SparsifierConfig:
    """Configuration of the RandK-family sparsifier.

    Attributes:
      kind: ``randk`` | ``bernoulli`` | ``block`` | ``block_hash`` |
        ``natural`` | ``none``.
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


_U32 = 0xFFFFFFFF

#: Kinds whose keep-ratio may differ per lane of a grid bank: the mask is an
#: elementwise function of the ratio and of a draw that does not depend on
#: it, so lanes of one seed share the draw. ``randk`` and ``block`` cannot:
#: their ``k`` fixes how many indices are drawn.
TRACED_RATIO_KINDS = ("bernoulli", "block_hash")


def _block_hash_uniform(seed: int, d: int, block: int, device
                        ) -> torch.Tensor:
    """``[nb]`` U[0, 1) per block: the reference's murmur-style uint32 hash
    of (block id, per-round seed), bit for bit. The hash depends on the block
    id only, so it is taken once per block (int64 arithmetic kept to the low
    32 bits) and repeated over the block by the mask."""
    nb = -(-d // block)
    h = torch.arange(nb, dtype=torch.int64, device=device)
    h = (h * 0x9E3779B1 + int(seed)) & _U32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _U32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _U32
    h ^= h >> 16
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def _draws_nothing(cfg: SparsifierConfig, ratio) -> bool:
    return cfg.kind == "none" or (ratio is None and cfg.ratio >= 1.0
                                  and cfg.kind != "natural")


def _check_ratio(cfg: SparsifierConfig, ratio) -> None:
    if ratio is not None and cfg.kind not in TRACED_RATIO_KINDS:
        raise ValueError(
            f"sparsifier kind {cfg.kind!r} does not support a per-lane ratio "
            f"(supported: {TRACED_RATIO_KINDS})")


def mask_draw(draws, d: int, cfg: SparsifierConfig, local_workers: int = 0,
              ratio=None) -> Optional[torch.Tensor]:
    """The round's raw mask draw, from the ``mask`` stream (one global
    mask) or, with ``local_workers = n``, the ``local`` stream (one per
    worker, in worker order): the RandK indices, the Block-RandK block ids,
    the Bernoulli and ``natural`` uniforms or the ``block_hash`` per-block
    uniforms. ``None``
    when the mask draws nothing (``kind='none'``, a static ratio of 1)."""
    _check_ratio(cfg, ratio)
    if _draws_nothing(cfg, ratio):
        return None
    m = local_workers
    stream = "local" if m else "mask"
    if cfg.kind in ("randk", "block"):
        nb = d if cfg.kind == "randk" else -(-d // cfg.block_size)
        kb = cfg.k(d) if cfg.kind == "randk" else max(
            1, int(round(cfg.ratio * nb)))
        if m:
            return draws.permutation_prefixes(m, nb, kb, stream=stream)
        return draws.permutation_prefix(nb, kb, stream=stream)
    if cfg.kind in ("bernoulli", "natural"):
        if m:
            return torch.stack([draws.uniform((d,), stream=stream)
                                for _ in range(m)])
        return draws.uniform((d,), stream=stream)
    if cfg.kind == "block_hash":
        seeds = [draws.bits_u32(stream=stream) for _ in range(max(m, 1))]
        u = torch.stack([_block_hash_uniform(b, d, cfg.block_size,
                                             draws.device) for b in seeds])
        return u if m else u[0]
    raise ValueError(f"unknown sparsifier kind: {cfg.kind!r} (known: "
                     f"{'|'.join(KINDS)})")


def _lead(ratio: torch.Tensor, ndim: int) -> torch.Tensor:
    """A ``[B]`` ratio shaped to broadcast over the leading axis of an
    ``ndim``-dimensional tensor."""
    return ratio.reshape(ratio.shape + (1,) * (ndim - ratio.ndim))


def mask_from_draw(raw: Optional[torch.Tensor], d: int, cfg: SparsifierConfig,
                   dtype: torch.dtype = torch.float32, ratio=None,
                   device=None) -> torch.Tensor:
    """The masks ``[..., d]`` of raw draws ``[..., x]`` (:func:`mask_draw`;
    any leading axes: workers, lanes). ``ratio``, a ``[B]`` float32 tensor,
    is each lane's keep-ratio (:data:`TRACED_RATIO_KINDS`), compared in
    float32 as the reference compares its traced ratio."""
    _check_ratio(cfg, ratio)
    if is_float8(dtype):  # 0 and 1 are exact; float8 has no scatter
        return mask_from_draw(raw, d, cfg, torch.float32, ratio,
                              device).to(dtype)
    if raw is None:
        return torch.ones((d,), dtype=dtype, device=device)
    if cfg.kind == "natural":
        return raw.to(dtype)
    if cfg.kind in ("randk", "block"):
        n_ids = d if cfg.kind == "randk" else -(-d // cfg.block_size)
        m = torch.zeros(raw.shape[:-1] + (n_ids,), dtype=dtype,
                        device=raw.device).scatter_(-1, raw, 1)
        if cfg.kind == "randk":
            return m
        return m.repeat_interleave(cfg.block_size, dim=-1)[..., :d]
    r = (torch.tensor(cfg.ratio, dtype=torch.float32) if ratio is None
         else _lead(torch.as_tensor(ratio, dtype=torch.float32,
                                    device=raw.device), raw.ndim))
    keep = (raw < r).to(dtype)
    if cfg.kind == "bernoulli":
        return keep
    return keep.repeat_interleave(cfg.block_size, dim=-1)[..., :d]


def mask_columns(raw: Optional[torch.Tensor], d: int, cfg: SparsifierConfig,
                 lo: int, hi: int, dtype: torch.dtype = torch.float32,
                 device=None) -> torch.Tensor:
    """Columns ``[lo, hi)`` of ``mask_from_draw(raw, d, cfg, dtype)``, built
    from the raw draw without the whole mask: for the block kinds from the
    blocks the slice holds (``lo`` on a whole block), for ``randk`` from the
    indices in it, for the uniforms from their slice. Bitwise that slice of
    the whole mask."""
    if is_float8(dtype):  # 0 and 1 are exact; float8 has no scatter
        return mask_columns(raw, d, cfg, lo, hi, torch.float32,
                            device).to(dtype)
    if raw is None:
        return torch.ones((hi - lo,), dtype=dtype, device=device)
    unit = cfg.block_size if cfg.kind in ("block", "block_hash") else 1
    if lo % unit:
        raise ValueError(f"columns from {lo} do not start on a block of "
                         f"{unit}")
    if cfg.kind == "natural":
        return raw[..., lo:hi].to(dtype)
    b_lo, b_hi = lo // unit, -(-hi // unit)
    if cfg.kind in ("randk", "block"):
        nbs = b_hi - b_lo
        at = raw - b_lo
        at = torch.where((at >= 0) & (at < nbs), at, nbs)  # nbs: dropped
        m = torch.zeros(raw.shape[:-1] + (nbs + 1,), dtype=dtype,
                        device=raw.device).scatter_(-1, at, 1)[..., :nbs]
    else:
        m = (raw[..., b_lo:b_hi] < torch.tensor(cfg.ratio, dtype=torch.float32)
             ).to(dtype)
    if unit == 1:
        return m
    return m.repeat_interleave(unit, dim=-1)[..., :hi - lo]


def make_mask(draws, d: int, cfg: SparsifierConfig,
              dtype: torch.dtype = torch.float32, ratio=None) -> torch.Tensor:
    """One sparsification mask ``[d]`` on the draws provider's device
    (``[B, d]`` for a ``[B]`` tensor of per-lane ratios, from one draw)."""
    raw = _per_lane(mask_draw(draws, d, cfg, ratio=ratio), ratio)
    return mask_from_draw(raw, d, cfg, dtype, ratio, draws.device)


def _per_lane(raw: Optional[torch.Tensor], ratio) -> Optional[torch.Tensor]:
    """One draw read by every lane of a ``[B]`` ratio."""
    if raw is None or ratio is None or not torch.as_tensor(ratio).ndim:
        return raw
    return raw.expand((len(ratio),) + raw.shape)


def make_masks(draws, n_workers: int, d: int, cfg: SparsifierConfig,
               dtype: torch.dtype = torch.float32, ratio=None
               ) -> torch.Tensor:
    """Masks for ``n_workers``: ``[d]`` for a global mask (broadcast over the
    worker axis by :func:`compress`), ``[n_workers, d]`` for local masks (one
    draw per worker, in worker order). A ``[B]`` tensor of per-lane ratios
    adds a leading lane axis."""
    if not cfg.local:
        return make_mask(draws, d, cfg, dtype, ratio)
    raw = _per_lane(mask_draw(draws, d, cfg, local_workers=n_workers,
                              ratio=ratio), ratio)
    m = mask_from_draw(raw, d, cfg, dtype, ratio, draws.device)
    return m if raw is not None else m.expand((n_workers, d))


def _exp2(x: torch.Tensor) -> torch.Tensor:
    """``2^x`` as the reference's compiled ``jnp.exp2`` rounds it:
    ``exp(x * ln 2)`` in float32, not the exact power of two (``2^-15``
    comes out 3.0517593e-05)."""
    return torch.exp(x * math.log(2.0))


def compress(g: torch.Tensor, mask: torch.Tensor,
             cfg: SparsifierConfig, ratio=None) -> torch.Tensor:
    """Server-side unbiased reconstruction ``(alpha * g) * mask``, in the
    reference's operation order (so the result is bitwise the same). A
    ``[B]`` tensor of per-lane ratios gives ``(g / ratio) * mask``, the
    reference's traced-ratio rescale, over ``g``'s leading lane axis.
    ``natural`` rounds each coordinate stochastically to a power of two:
    ``|x|`` in ``[2^e, 2^(e+1))`` rounds up where the uniform ``mask`` is
    below ``|x| / 2^e - 1`` (unbiased; the reference's operations in its
    order)."""
    if ratio is not None:
        return (g / _lead(ratio, g.ndim)) * mask
    if cfg.kind == "natural":
        a = g.abs()
        safe = torch.where(a > 0, a, torch.ones_like(a))
        lo = _exp2(torch.floor(torch.log2(safe)))
        up = (mask < safe / lo - 1.0).to(g.dtype)
        out = torch.sign(g) * lo * _exp2(up)
        return torch.where(a > 0, out, torch.zeros_like(out)).to(g.dtype)
    if cfg.kind == "none" or cfg.ratio >= 1.0:
        return g
    if is_float8(g):  # each product rounded to float8, as the reference's
        return lowp(torch.mul, lowp(lambda x: cfg.alpha * x, g,
                                    dtype=g.dtype), mask, dtype=g.dtype)
    return (cfg.alpha * g) * mask


def _block_eligible(cfg: SparsifierConfig, d: int) -> bool:
    """Exact Block-RandK with a ratio below 1 and block-aligned ``d``: the
    configs whose round has a wire payload of whole blocks."""
    return (cfg.kind == "block" and cfg.ratio < 1.0
            and d % cfg.block_size == 0)


def _kernel_eligible(cfg: SparsifierConfig, d: int) -> bool:
    """Only exact Block-RandK with a ratio below 1 and block-aligned ``d``
    has the kernel round trip; everything else takes the dense path."""
    return cfg.use_kernels and _block_eligible(cfg, d)


def block_ids(draws, n: int, d: int, cfg: SparsifierConfig
              ) -> torch.Tensor:
    """The round's Block-RandK block ids, drawn exactly as
    :func:`_block_mask` draws them: ``[kb]`` (one permutation prefix shared
    by every row) for a global mask, ``[n, kb]`` (one per worker, in worker
    order) for local masks. ``d`` is a multiple of the block."""
    return mask_draw(draws, d, cfg, local_workers=n if cfg.local else 0)


def payload_width(d: int, cfg: SparsifierConfig) -> int:
    """Columns of a worker's payload row: the ``kb`` blocks :func:`block_ids`
    draws for a ``d``-wide bank, whole."""
    return max(1, int(round(cfg.ratio * (d // cfg.block_size)))) \
        * cfg.block_size


def compress_rows(g: torch.Tensor, ids: torch.Tensor, cfg: SparsifierConfig,
                  out=None) -> torch.Tensor:
    """Step 3 on ``g``'s rows: the ``[m, kb * block_size]`` payload of
    ``alpha * g`` on the blocks ``ids`` (the round's :func:`block_ids`), into
    ``out`` where given (a worker's rows of the round's payload). The
    compress kernel with ``use_kernels`` (its plain version on a CPU
    tensor), else the kernel's plain version on ``g``'s device."""
    if cfg.use_kernels:
        return RK.compress(g, ids, block_size=cfg.block_size,
                           alpha=cfg.alpha, out=out)
    return RK.block_compress_ref(g, ids, cfg.block_size, cfg.alpha, out=out)


def compressed_payload(grads: torch.Tensor, draws, cfg: SparsifierConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Steps 1-3 on the real wire: the round's block ids
    (:func:`block_ids`) and the ``[n, kb * block_size]`` payload of
    ``alpha * g`` on those blocks (:func:`compress_rows`). For a ``block``
    config of whole blocks (:func:`_block_eligible`)."""
    ids = block_ids(draws, grads.shape[0], grads.shape[1], cfg)
    return compress_rows(grads, ids, cfg), ids


def compressed_estimate(grads: torch.Tensor, draws,
                        cfg: SparsifierConfig, ratio=None) -> torch.Tensor:
    """Steps 1+4: sample the round's masks and return the unbiased
    reconstruction of the ``[n, d]`` gradient bank.

    The dense path is :func:`make_masks` + :func:`compress`. For an eligible
    ``block`` config (:func:`_kernel_eligible`) the round trip runs over the
    real wire payload instead (:func:`compressed_payload`), and the
    decompress kernel scatters it back into a dense bank. Bitwise the dense
    path on finite gradients (the kernel writes +0.0 where
    ``(alpha * g) * 0`` may give -0.0). A ``ratio`` (a float32 scalar
    tensor, :data:`TRACED_RATIO_KINDS`) overrides ``cfg.ratio``."""
    n, d = grads.shape
    if ratio is not None or not _kernel_eligible(cfg, d):
        return compress(grads, make_masks(draws, n, d, cfg, grads.dtype,
                                          ratio), cfg, ratio)
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
    when ``with_mask_indices``; ``natural`` sends a sign and an 8-bit
    exponent a coordinate (9 bits)."""
    if cfg.kind == "natural":
        return int(d * 9 / 8 / 4 * bytes_per_value)
    k = payload_floats(d, cfg)
    b = k * bytes_per_value
    if with_mask_indices and cfg.local and cfg.ratio < 1.0:
        b += k * index_bytes(d)
    return b
