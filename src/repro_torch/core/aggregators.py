"""(f, kappa)-robust aggregation rules (counterpart of
``repro.core.aggregators``).

Every rule maps per-worker vectors ``x: [..., n, d]`` (worker axis -2; the
batched ``[B, n, d]`` shape is first-class) to ``[..., d]``: the mean,
coordinate-wise trimmed mean (CWTM), coordinate-wise median, the geometric
median (smoothed Weiszfeld), (Multi-)Krum and the NNM pre-aggregation, and
the aggregator bank (:func:`make_aggregator_bank`), which gives each lane of
a ``[B, n, d]`` batch its own rule and runs each rule once on its lanes.

:func:`make_aggregator` builds either the kernel path (the counterpart of
the reference's Pallas path: ``repro_torch.kernels`` for pairdist, CWTM and
the median, which launch CUDA kernels on CUDA tensors and run their plain
versions on CPU tensors) or the plain rules below.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.cwtm.ops import cwtm as cwtm_op
from repro_torch.kernels.median.ops import median as median_op
from repro_torch.kernels.median.ref import median_ref
from repro_torch.kernels.pairdist.ops import pairdist

Aggregator = Callable[[torch.Tensor], torch.Tensor]

#: ``(name, pre_nnm)`` branches of the default aggregator bank, in the
#: reference's switch order. ``(mean, True)`` is absent: NNM composition
#: skips the non-robust mean (:func:`bank_index` maps it onto plain mean).
BANK_NAMES: Tuple[str, ...] = ("mean", "cwtm", "median", "geomed", "krum",
                               "multikrum")
DEFAULT_BANK: Tuple[Tuple[str, bool], ...] = (
    tuple((n, False) for n in BANK_NAMES)
    + tuple((n, True) for n in BANK_NAMES if n != "mean"))
#: Every rule of the reference is ported.
PORTED_RULES: Tuple[str, ...] = BANK_NAMES


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


def geometric_median(x: torch.Tensor, iters: int = 8,
                     eps: float = 1e-8) -> torch.Tensor:
    """Smoothed Weiszfeld iteration for the geometric median, from the mean,
    ``iters`` times: weights ``1 / sqrt(||x_i - z||^2 + eps)``, normalised.
    Plain PyTorch (the reference has no kernel for it)."""
    z = x.mean(dim=-2)
    for _ in range(iters):
        dist = torch.sqrt(torch.sum(torch.square(x - z.unsqueeze(-2)),
                                    dim=-1) + eps)
        w = 1.0 / dist
        w = w / w.sum(dim=-1, keepdim=True)
        z = torch.sum(w.unsqueeze(-1) * x, dim=-2)
    return z


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
      name: ``mean`` | ``cwtm`` | ``median`` | ``geomed`` | ``krum`` |
        ``multikrum`` | ``bank`` (:func:`make_aggregator_bank`).
      f: number of tolerated Byzantine workers.
      pre_nnm: compose with NNM pre-aggregation.
      geomed_iters: Weiszfeld iterations for ``geomed``.
      bank: the bank's branches ``((name, pre_nnm), ...)`` when
        ``name='bank'`` (``None``: :data:`DEFAULT_BANK`).
      use_kernels: the kernel path (``repro_torch.kernels``) for cwtm,
        median, (multi)krum and NNM — the counterpart of the reference's
        ``use_pallas``. ``False`` runs the plain rules of this module.
    """

    name: str = "cwtm"
    f: int = 0
    pre_nnm: bool = False
    geomed_iters: int = 8
    bank: Optional[Tuple[Tuple[str, bool], ...]] = None
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


def _base_rule(name: str, f: int, geomed_iters: int = 8) -> Aggregator:
    if name == "mean":
        return mean
    if name == "cwtm":
        return functools.partial(trimmed_mean, f=f)
    if name == "median":
        return coordinate_median
    if name == "geomed":
        return functools.partial(geometric_median, iters=geomed_iters)
    if name == "krum":
        return functools.partial(krum, f=f, m=1)
    if name == "multikrum":
        return lambda x: krum(x, f=f, m=max(1, x.shape[-2] - f))
    raise ValueError(f"unknown aggregator: {name!r} (expected one of "
                     f"{'|'.join(BANK_NAMES)})")


def make_aggregator(cfg: AggregatorConfig,
                    device: DeviceLike = None) -> Aggregator:
    """Build an aggregator ``[..., n, d] -> [..., d]`` from a config.

    ``device`` is where the aggregator runs (default the card; raises
    without CUDA unless ``device="cpu"``). The returned function refuses
    tensors on another device type.
    """
    dev = resolve_device(device)
    f = cfg.f
    if cfg.name == "bank":
        raise ValueError("name='bank' is the aggregator bank: build it with "
                         "make_aggregator_bank")
    base = _rule(cfg.name, f, cfg.geomed_iters, cfg.use_kernels)
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


def _rule(name: str, f: int, geomed_iters: int, use_kernels: bool
          ) -> Aggregator:
    return ((_kernel_base_rule(name, f) if use_kernels else None)
            or _base_rule(name, f, geomed_iters))


# --------------------------------------------------------------------------
# The aggregator bank (the grid's per-lane rule)
# --------------------------------------------------------------------------

#: Lanes of one group: a slice when they are contiguous, else an index.
Lanes = Union[slice, torch.Tensor]


@functools.lru_cache(maxsize=256)
def _groups_cached(values: Tuple, device: torch.device
                   ) -> Tuple[Tuple[object, Lanes, int], ...]:
    by: Dict[object, List[int]] = {}
    for i, v in enumerate(values):
        by.setdefault(v, []).append(i)
    out = []
    for v, lanes in by.items():
        if lanes == list(range(lanes[0], lanes[-1] + 1)):
            sel: Lanes = slice(lanes[0], lanes[-1] + 1)
        else:
            sel = torch.tensor(lanes, dtype=torch.long, device=device)
        out.append((v, sel, len(lanes)))
    return tuple(out)


def lane_groups(values: Sequence, device) -> Tuple[Tuple[object, Lanes, int],
                                                   ...]:
    """``((value, lanes, count), ...)``: the lanes holding each distinct
    value of ``values`` (host values, one per lane), in first-seen order.
    Cached: a grid asks for the same grouping every round."""
    return _groups_cached(tuple(values), torch.device(device))


def take(t: torch.Tensor, lanes: Lanes) -> torch.Tensor:
    """The rows ``lanes`` of ``t`` (a view for a slice, a copy for an
    index)."""
    return t[lanes] if isinstance(lanes, slice) else t.index_select(0, lanes)


def host_values(v) -> Tuple:
    """Per-lane values on the host: a tensor's ``tolist``, or a sequence."""
    if isinstance(v, torch.Tensor):
        return tuple(v.reshape(-1).tolist())
    if isinstance(v, (int, float)):
        return (v,)
    return tuple(v)


def bank_index(cfg: AggregatorConfig,
               bank: Optional[Sequence[Tuple[str, bool]]] = None) -> int:
    """Branch index of ``cfg`` inside ``bank`` (default the full bank).
    ``(mean, pre_nnm=True)`` maps to the plain-mean branch, as
    :func:`make_aggregator` skips NNM for the mean."""
    bank = tuple(bank) if bank is not None else DEFAULT_BANK
    entry = (cfg.name, bool(cfg.pre_nnm) and cfg.name != "mean")
    try:
        return bank.index(entry)
    except ValueError:
        raise ValueError(
            f"aggregator {entry} is not a branch of the bank {bank}") from None


BankAggregator = Callable[[torch.Tensor, Sequence[int]], torch.Tensor]


def make_aggregator_bank(cfg: AggregatorConfig,
                         device: DeviceLike = None) -> BankAggregator:
    """Build the aggregator bank ``bank(x, idx) -> [B, d]``.

    ``x`` is ``[B, n, d]`` (or one lane ``[n, d]``) and ``idx`` the branch of
    each lane (host ints, or a tensor), one ``(rule, pre_nnm)`` entry of
    ``cfg.bank`` (default :data:`DEFAULT_BANK`). Each lane gets its own
    rule, as the reference's ``lax.switch`` gives it, but the rules run on
    their lanes only: every lane whose branch composes NNM goes through ONE
    NNM (one pairdist launch on the kernel path), then each base rule runs
    once, batched, on its lanes (one CWTM, one median launch). So the
    launches per call do not grow with ``B``. ``cfg.f``,
    ``cfg.geomed_iters`` and ``cfg.use_kernels`` hold for every branch.
    """
    dev = resolve_device(device)
    entries = tuple(cfg.bank) if cfg.bank is not None else DEFAULT_BANK
    if not entries:
        raise ValueError("aggregator bank needs at least one entry")
    f = cfg.f
    for name, _ in entries:
        if name not in BANK_NAMES:
            raise ValueError(f"unknown aggregator in bank: {name!r} "
                             f"(expected one of {'|'.join(BANK_NAMES)})")
    bases = [_rule(name, f, cfg.geomed_iters, cfg.use_kernels)
             for name, _ in entries]
    nnm_of = [bool(pre) and name != "mean" for name, pre in entries]
    pre = _kernel_nnm(f) if cfg.use_kernels else functools.partial(nnm, f=f)

    def apply(x: torch.Tensor, idx) -> torch.Tensor:
        if x.device.type != dev.type:
            raise ValueError(f"aggregator bank built for {dev.type} got a "
                             f"tensor on {x.device}")
        if x.ndim == 2:
            return apply(x[None], host_values(idx)[:1])[0]
        idx = host_values(idx)
        if len(idx) != x.shape[0]:
            raise ValueError(f"{len(idx)} branch indices for {x.shape[0]} "
                             f"lanes")
        if any(not 0 <= i < len(entries) for i in idx):
            raise ValueError(f"branch index outside the bank's "
                             f"{len(entries)} entries: {idx}")
        # NNM once over every lane whose branch composes it
        mixed_of = tuple(nnm_of[i] for i in idx)
        src = x
        if any(mixed_of):
            if all(mixed_of):
                src = pre(x)
            else:
                src = x.clone()
                for is_nnm, lanes, _ in lane_groups(mixed_of, x.device):
                    if is_nnm:
                        src[lanes] = pre(take(x, lanes))
        groups = lane_groups(idx, x.device)
        if len(groups) == 1:
            return bases[groups[0][0]](src)
        out = x.new_empty((x.shape[0], x.shape[-1]))
        for branch, lanes, _ in groups:
            out[lanes] = bases[branch](take(src, lanes))
        return out

    return apply
