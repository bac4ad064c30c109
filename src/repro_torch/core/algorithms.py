"""Server-side algorithms on flat gradient banks (counterpart of
``repro.core.algorithms``, static path).

Ported: ``rosdhb`` (the paper's Algorithm 1, global or local sparsification),
``robust_dgd`` (robust aggregation of raw gradients) and ``dgd`` (compressed,
non-robust mean). ``dasha`` and the algorithm bank are still to be ported;
their memory and wire accounting is here already.

Every function works on ``[n_workers, D]`` banks. The random draws of a round
(RandK masks) come from a draws provider (``repro_torch.testing``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import aggregators as G
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.core import wire as W
from repro_torch.device import resolve_device

#: Algorithm names of the reference, and the ones this port can run.
ALGO_BANK: Tuple[str, ...] = ("rosdhb", "dasha", "robust_dgd", "dgd")
PORTED_ALGORITHMS: Tuple[str, ...] = ("rosdhb", "robust_dgd", "dgd")


@dataclasses.dataclass(frozen=True)
class StateLayout:
    """Which optional ``ServerState`` slots a run materialises: DASHA's
    gradient mirrors and previous gradients exist only when a dasha branch
    can run (the paper charges DASHA, not RoSDHB, for them)."""

    mirror: bool = True
    prev_grad: bool = True

    @classmethod
    def for_algorithms(cls, names: Sequence[str]) -> "StateLayout":
        needs = "dasha" in tuple(names)
        return cls(mirror=needs, prev_grad=needs)


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    """Specification of a Byzantine-robust compressed training run.

    Attributes:
      name: ``rosdhb`` | ``robust_dgd`` | ``dgd`` (``dasha`` for the
        accounting functions only).
      n_workers: total workers n.
      f: number of Byzantine workers (the first ``f`` indices).
      gamma: learning rate.
      beta: momentum coefficient; ``None`` -> Theorem 1's
        ``sqrt(1 - 24 gamma L)`` with ``smoothness_L``.
      smoothness_L: Lipschitz constant estimate for the beta schedule.
      mvr_a: DASHA's MVR coefficient (accounting only here).
      sparsifier, aggregator, attack: the round's components.

    The server banks are float32 (the reference's default momentum and
    compute dtypes).
    """

    name: str = "rosdhb"
    n_workers: int = 10
    f: int = 0
    gamma: float = 0.05
    beta: Optional[float] = 0.9
    smoothness_L: float = 1.0
    mvr_a: Optional[float] = None
    sparsifier: C.SparsifierConfig = dataclasses.field(
        default_factory=C.SparsifierConfig)
    aggregator: G.AggregatorConfig = dataclasses.field(
        default_factory=G.AggregatorConfig)
    attack: A.AttackConfig = dataclasses.field(
        default_factory=lambda: A.AttackConfig(name="none"))

    @property
    def honest(self) -> int:
        return self.n_workers - self.f

    def resolved_state_layout(self) -> StateLayout:
        return StateLayout.for_algorithms((self.name,))

    def resolved_beta(self) -> float:
        if self.beta is not None:
            return self.beta
        # Theorem 1: beta = sqrt(1 - 24 gamma L), requires gamma <= 1/(24 L).
        val = 1.0 - 24.0 * self.gamma * self.smoothness_L
        if val <= 0.0:
            raise ValueError(
                f"gamma={self.gamma} too large for Theorem-1 beta schedule "
                f"(needs gamma <= 1/(24 L) = {1.0 / (24 * self.smoothness_L)})")
        return math.sqrt(val)

    def resolved_mvr_a(self) -> float:
        if self.mvr_a is not None:
            return self.mvr_a
        return 1.0 - (self.beta if self.beta is not None else 0.9)


class ServerState(NamedTuple):
    """Server-side state: the ``[n, D]`` momentum bank, DASHA's optional
    banks (``None`` under the pruned layout), the round counter, and the
    adversary's memory (``None`` for the stateless attacks)."""

    momentum: torch.Tensor
    mirror: Optional[torch.Tensor]
    prev_grad: Optional[torch.Tensor]
    step: int
    attack: Optional[Any] = None


def _check_ported(name: str) -> None:
    if name not in PORTED_ALGORITHMS:
        raise ValueError(
            f"algorithm {name!r} is not ported (ported: "
            f"{'|'.join(PORTED_ALGORITHMS)}; the reference knows "
            f"{'|'.join(ALGO_BANK)} and 'bank')")


def init_state(cfg: AlgorithmConfig, d: int, device=None) -> ServerState:
    """Initial server state under ``cfg``'s resolved layout, on ``device``
    (default the card)."""
    _check_ported(cfg.name)
    dev = resolve_device(device)
    layout = cfg.resolved_state_layout()
    zeros = torch.zeros((cfg.n_workers, d), device=dev)
    return ServerState(
        momentum=zeros,
        mirror=zeros.clone() if layout.mirror else None,
        prev_grad=torch.zeros((cfg.n_workers, d), device=dev)
        if layout.prev_grad else None,
        step=0)


def _byzantine_overwrite(cfg: AlgorithmConfig, wire: torch.Tensor,
                         attack_params=None) -> torch.Tensor:
    """Replace rows [0, f) of the wire with the attack computed from the
    honest rows [f, n) (stateless attacks)."""
    if cfg.f == 0 or cfg.attack.name == "none":
        return wire
    honest = wire[cfg.f:]
    byz = A.apply_attack(cfg.attack, honest, cfg.f, params=attack_params)
    return torch.cat([byz.to(wire.dtype), honest], dim=0)


def _compressed_wire(cfg: AlgorithmConfig, grads: torch.Tensor, draws,
                     attack_params=None) -> torch.Tensor:
    # Steps 1-4: the round's masks and the unbiased reconstruction, then the
    # Byzantine overwrite of the wire quantity.
    g_tilde = C.compressed_estimate(grads, draws, cfg.sparsifier)
    return _byzantine_overwrite(cfg, g_tilde, attack_params)


def _rosdhb_apply(cfg: AlgorithmConfig, agg, state: ServerState,
                  wire: torch.Tensor, hparams) -> Tuple[torch.Tensor,
                                                        ServerState]:
    # Step 5: per-worker momentum m = beta*m_prev + (1-beta)*wire, written
    # as one fused multiply-add onto (1-beta)*wire: torch.add with alpha is
    # an FMA on the CPU and on the card, the rounding XLA's fusion gives the
    # reference's compiled round. The add is in place on the fresh product
    # (one [n, D] buffer fewer); the wire itself may be the caller's
    # gradients (sparsifier 'none') and is left alone.
    beta, one_m_beta = hparams[0], hparams[2]
    m = (wire * one_m_beta).add_(state.momentum, alpha=beta)
    # Step 6: robust aggregation of the momenta.
    r = agg(m)
    new = state._replace(momentum=m, step=state.step + 1)
    return r, new


def _dgd_apply(cfg, agg, state, wire):
    # Compressed DGD, non-robust: the plain mean (the aggregator is unused).
    del agg
    return wire.mean(dim=0), state._replace(step=state.step + 1)


def _robust_dgd_apply(cfg, agg, state, wire):
    # Robust DGD without compression: aggregate the raw gradients.
    return agg(wire), state._replace(step=state.step + 1)


def static_hparams(cfg: AlgorithmConfig) -> Tuple[float, float, float, float]:
    """``(beta, mvr_a, 1-beta, 1-mvr_a)``, complements in double precision
    (the constants the reference folds in)."""
    beta = cfg.resolved_beta() if cfg.name == "rosdhb" else 0.0
    a = cfg.resolved_mvr_a() if cfg.name == "dasha" else 0.0
    return (beta, a, 1.0 - beta, 1.0 - a)


def server_state_bytes(cfg: AlgorithmConfig, d: int) -> int:
    """Bytes of the float32 ``[n, D]`` server banks under ``cfg``'s layout:
    RoSDHB keeps one momentum vector per worker; a dasha layout adds the
    mirrors and the previous gradients (3x)."""
    n = cfg.n_workers
    layout = cfg.resolved_state_layout()
    total = n * d * 4
    if layout.mirror:
        total += n * d * 4
    if layout.prev_grad:
        total += n * d * 4
    return total


def algo_payload_bytes(cfg: AlgorithmConfig, d: int,
                       bytes_per_value: int = 4) -> int:
    """Per-worker uplink bytes per round under ``cfg``'s wire format."""
    return W.per_worker_payload_bytes(cfg.name, d, cfg.sparsifier,
                                      bytes_per_value=bytes_per_value)


def server_round(cfg: AlgorithmConfig, state: ServerState,
                 grads: torch.Tensor, draws, agg=None,
                 attack_params=None) -> Tuple[torch.Tensor, ServerState,
                                              dict]:
    """Execute one server round.

    Args:
      cfg: algorithm configuration.
      state: current server state (its momentum is consumed).
      grads: per-worker gradients ``[n, D]``; the Byzantine rows are
        replaced by the attack.
      draws: the draws provider for this round's masks.
      agg: the aggregator (default ``make_aggregator(cfg.aggregator)`` on
        the gradients' device).
      attack_params: the ``[2]`` coefficients of ``attack.name='linear'``.

    Returns:
      (direction R [D] to descend, next state, aux dict).
    """
    _check_ported(cfg.name)
    n, d = grads.shape
    if n != cfg.n_workers:
        raise ValueError(f"grads has {n} rows, cfg.n_workers={cfg.n_workers}")
    if agg is None:
        agg = G.make_aggregator(cfg.aggregator, device=grads.device)
    if cfg.name == "robust_dgd":
        wire = _byzantine_overwrite(cfg, grads, attack_params)
        r, new = _robust_dgd_apply(cfg, agg, state, wire)
        return r, new, {"payload_floats_per_worker": d}
    wire = _compressed_wire(cfg, grads, draws, attack_params)
    if cfg.name == "rosdhb":
        r, new = _rosdhb_apply(cfg, agg, state, wire, static_hparams(cfg))
    else:
        r, new = _dgd_apply(cfg, agg, state, wire)
    return r, new, {"payload_floats_per_worker":
                    C.payload_floats(d, cfg.sparsifier)}


def apply_direction(params_flat: torch.Tensor, r: torch.Tensor,
                    gamma: float) -> torch.Tensor:
    """Step 7: theta <- theta - gamma R, one fused multiply-add (as XLA
    compiles the reference's round)."""
    return torch.add(params_flat, r, alpha=-gamma)
