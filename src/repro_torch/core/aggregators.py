"""(f, kappa)-robust aggregation rules (counterpart of
``repro.core.aggregators``).

Every rule maps per-worker vectors ``x: [..., n, d]`` (worker axis -2; the
batched ``[B, n, d]`` shape is first-class) to ``[..., d]``. Ported: the mean,
coordinate-wise trimmed mean (CWTM), coordinate-wise median, (Multi-)Krum and
the NNM pre-aggregation; the geometric median and the switch bank are still
to be ported.

:func:`make_aggregator` builds either the kernel path (the counterpart of
the reference's Pallas path: ``repro_torch.kernels`` for pairdist, CWTM and
the median, which launch CUDA kernels on CUDA tensors and run their plain
versions on CPU tensors) or the plain rules below.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.cwtm.ops import cwtm as cwtm_op
from repro_torch.kernels.median.ops import median as median_op
from repro_torch.kernels.median.ref import median_ref
from repro_torch.kernels.pairdist.ops import pairdist

Aggregator = Callable[[torch.Tensor], torch.Tensor]

BANK_NAMES: Tuple[str, ...] = ("mean", "cwtm", "median", "geomed", "krum",
                               "multikrum")
PORTED_RULES: Tuple[str, ...] = ("mean", "cwtm", "median", "krum",
                                 "multikrum")


def mean(x: torch.Tensor) -> torch.Tensor:
    """Plain averaging: NOT robust, the non-robust baseline."""
    return x.mean(dim=-2)


def coordinate_median(x: torch.Tensor) -> torch.Tensor:
    """Per-coordinate median, the midpoint of the two middle values for
    even n (``jnp.median``'s convention)."""
    return median_ref(x)


def trimmed_mean(x: torch.Tensor, f: int) -> torch.Tensor:
    """Drop the f largest and f smallest values per coordinate, average the
    middle ``n - 2f``."""
    n = x.shape[-2]
    if f == 0:
        return x.mean(dim=-2)
    if n - 2 * f <= 0:
        raise ValueError(f"trimmed_mean requires n > 2f, got n={n}, f={f}")

    def trim(cols: torch.Tensor) -> torch.Tensor:
        return torch.sort(cols, dim=-2).values[..., f:n - f, :].mean(dim=-2)

    # Column slices bound the sort's int64 indices (every column is sorted
    # on its own, so the result is the same): at an LLM's D they would
    # outgrow the card.
    d = x.shape[-1]
    if d <= _SORT_COLS:
        return trim(x)
    return torch.cat([trim(x[..., i:i + _SORT_COLS])
                      for i in range(0, d, _SORT_COLS)], dim=-1)


_SORT_COLS = 1 << 22


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """The reference rule: squared norms from row sums, so the diagonal
    keeps the cancellation noise of ``sq_i + sq_i - 2 G_ii``."""
    sq = x.square().sum(dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * (x @ x.mT)
    return d2.clamp_min(0.0)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x [..., n, d]`` rows at ``idx [..., m, q]`` -> ``[..., m, q, d]``."""
    flat = idx.reshape(idx.shape[:-2] + (-1,))
    rows = torch.take_along_dim(x, flat[..., None], dim=-2)
    return rows.reshape(idx.shape + (x.shape[-1],))


def krum(x: torch.Tensor, f: int, m: int = 1) -> torch.Tensor:
    """(Multi-)Krum: average the ``m`` vectors with the smallest sum of
    squared distances to their ``n - f - 2`` nearest neighbours."""
    n = x.shape[-2]
    q = max(1, n - f - 2)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d2 = _pairwise_sq_dists(x).masked_fill(eye, float("inf"))
    scores = torch.sort(d2, dim=-1).values[..., :q].sum(dim=-1)
    sel = torch.argsort(scores, dim=-1, stable=True)[..., :m]
    return _gather_rows(x, sel[..., None, :])[..., 0, :, :].mean(dim=-2)


def nnm(x: torch.Tensor, f: int) -> torch.Tensor:
    """Nearest-Neighbour Mixing: replace each vector by the average of its
    ``n - f`` nearest neighbours (itself included)."""
    q = x.shape[-2] - f
    idx = torch.argsort(_pairwise_sq_dists(x), dim=-1, stable=True)[..., :q]
    return _gather_rows(x, idx).mean(dim=-2)


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Named robust-aggregation rule.

    Attributes:
      name: ``mean`` | ``cwtm`` | ``median`` | ``krum`` | ``multikrum``
        (``geomed`` is known to :meth:`kappa_bound` but not ported).
      f: number of tolerated Byzantine workers.
      pre_nnm: compose with NNM pre-aggregation.
      use_kernels: the kernel path (``repro_torch.kernels``) for cwtm,
        median, (multi)krum and NNM — the counterpart of the reference's
        ``use_pallas``. ``False`` runs the plain rules of this module.
    """

    name: str = "cwtm"
    f: int = 0
    pre_nnm: bool = False
    use_kernels: bool = True

    def kappa_bound(self, n: int) -> float:
        """Conservative upper bound on the robustness coefficient kappa."""
        f = self.f
        if self.name not in BANK_NAMES:
            raise ValueError(
                f"unknown aggregator: {self.name!r} (expected one of "
                f"{'|'.join(BANK_NAMES)})")
        if f == 0:
            return 0.0
        if n <= 2 * f:
            return float("inf")
        r = f / (n - 2 * f)
        base = {
            "mean": float("inf"),
            "cwtm": 6.0 * (f / n) * (1.0 + r),
            "median": 4.0 * (1.0 + r),
            "geomed": (1.0 + r) ** 2,
            "krum": 6.0 * (1.0 + r),
            "multikrum": 6.0 * (1.0 + r),
        }[self.name]
        if self.pre_nnm and self.name != "mean":
            return 8.0 * (f / n) * (1.0 + base)
        return base


def _kernel_nnm(f: int) -> Aggregator:
    """Kernel-backed NNM: distances from the pairdist kernel, then ONE
    ``[n, n] x [n, d]`` mixing product with the 0/(1/q) neighbour weights
    (a plain matmul, as the reference leaves it to XLA)."""

    def pre(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-2]
        q = n - f
        idx = torch.argsort(pairdist(x), dim=-1, stable=True)[..., :q]
        w = torch.zeros(idx.shape[:-1] + (n,), dtype=torch.float32,
                        device=x.device).scatter_(-1, idx, 1.0) / q
        return (w @ x.float()).to(x.dtype)

    return pre


def _kernel_base_rule(name: str, f: int) -> Optional[Aggregator]:
    """Kernel-backed cwtm, median, krum or multikrum; ``None`` for the
    other rules (NNM is kernel-backed through pairdist whatever the base
    rule)."""
    if name == "cwtm":
        return functools.partial(cwtm_op, f=f)
    if name == "median":
        return median_op
    if name in ("krum", "multikrum"):
        def rule(x: torch.Tensor) -> torch.Tensor:
            n = x.shape[-2]
            m = 1 if name == "krum" else max(1, n - f)
            q = max(1, n - f - 2)
            eye = torch.eye(n, dtype=torch.bool, device=x.device)
            d2 = pairdist(x).masked_fill(eye, float("inf"))
            scores = torch.sort(d2, dim=-1).values[..., :q].sum(dim=-1)
            sel = torch.argsort(scores, dim=-1, stable=True)[..., :m]
            # the selection as weights: ONE [n] x [n, d] product
            w = torch.zeros(sel.shape[:-1] + (n,), dtype=torch.float32,
                            device=x.device).scatter_(-1, sel, 1.0 / m)
            return (w[..., None, :] @ x.float())[..., 0, :].to(x.dtype)
        return rule
    return None


def _base_rule(name: str, f: int) -> Aggregator:
    if name == "mean":
        return mean
    if name == "cwtm":
        return functools.partial(trimmed_mean, f=f)
    if name == "median":
        return coordinate_median
    if name == "krum":
        return functools.partial(krum, f=f, m=1)
    if name == "multikrum":
        return lambda x: krum(x, f=f, m=max(1, x.shape[-2] - f))
    raise ValueError(f"aggregator {name!r} is not ported "
                     f"(ported: {'|'.join(PORTED_RULES)})")


def make_aggregator(cfg: AggregatorConfig,
                    device: DeviceLike = None) -> Aggregator:
    """Build an aggregator ``[..., n, d] -> [..., d]`` from a config.

    ``device`` is where the aggregator runs (default the card; raises
    without CUDA unless ``device="cpu"``). The returned function refuses
    tensors on another device type.
    """
    dev = resolve_device(device)
    f = cfg.f
    base = (_kernel_base_rule(cfg.name, f) if cfg.use_kernels else None) \
        or _base_rule(cfg.name, f)
    pre = None
    if cfg.pre_nnm and cfg.name != "mean":
        pre = _kernel_nnm(f) if cfg.use_kernels else functools.partial(nnm,
                                                                         f=f)

    def agg(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != dev.type:
            raise ValueError(f"aggregator built for {dev.type} got a tensor "
                             f"on {x.device}")
        return base(pre(x) if pre is not None else x)

    return agg
