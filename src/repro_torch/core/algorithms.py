"""Server-side algorithms on flat gradient banks (counterpart of
``repro.core.algorithms``, static path).

Ported: ``rosdhb`` (the paper's Algorithm 1, global or local sparsification),
``dasha`` (Byz-DASHA-PAGE with p = 1, the baseline the paper measures
RoSDHB against), ``robust_dgd`` (robust aggregation of raw gradients) and
``dgd`` (compressed, non-robust mean). The algorithm bank is still to be
ported.

Every function works on ``[n_workers, D]`` banks. The random draws of a round
(RandK masks) come from a draws provider (``repro_torch.testing``). The
server banks are float32 or bfloat16 (``momentum_dtype``); the server's
arithmetic is float32.

For RoSDHB on global Block-RandK (:func:`_payload_route`) the round never
builds the dense wire: the Byzantine overwrite runs on the
``[n, kb * block_size]`` payload and the momentum kernel
(``repro_torch.kernels.randk.momentum_update``) decays the bank and adds
the payload into the selected blocks in one pass, bitwise the dense round.
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
from repro_torch.kernels.randk import ops as RK

#: Algorithm names of the reference, and the ones this port can run.
ALGO_BANK: Tuple[str, ...] = ("rosdhb", "dasha", "robust_dgd", "dgd")
PORTED_ALGORITHMS: Tuple[str, ...] = ALGO_BANK

#: Server bank dtypes the port keeps (``AlgorithmConfig.momentum_dtype``).
BANK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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

    @property
    def is_full(self) -> bool:
        return self.mirror and self.prev_grad


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    """Specification of a Byzantine-robust compressed training run.

    Attributes:
      name: ``rosdhb`` | ``dasha`` | ``robust_dgd`` | ``dgd``.
      n_workers: total workers n.
      f: number of Byzantine workers (the first ``f`` indices).
      gamma: learning rate.
      beta: momentum coefficient; ``None`` -> Theorem 1's
        ``sqrt(1 - 24 gamma L)`` with ``smoothness_L``.
      smoothness_L: Lipschitz constant estimate for the beta schedule.
      mvr_a: DASHA's MVR coefficient ``a`` (default ``1 - beta``).
      sparsifier, aggregator, attack: the round's components.
      momentum_dtype: dtype of the server banks (``float32`` or
        ``bfloat16``; dasha's previous gradients stay float32).
      server_compute_dtype: dtype of the server's arithmetic; only
        ``float32`` is ported.
      state_layout: an explicit :class:`StateLayout`, or ``None`` for the
        minimal layout of the algorithm.
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
    momentum_dtype: str = "float32"
    server_compute_dtype: str = "float32"
    state_layout: Optional[StateLayout] = None

    @property
    def honest(self) -> int:
        return self.n_workers - self.f

    def resolved_state_layout(self) -> StateLayout:
        if self.state_layout is not None:
            return self.state_layout
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


def _check_ported(cfg: AlgorithmConfig) -> torch.dtype:
    """Raise on what the port cannot run; returns the bank dtype."""
    if cfg.name not in PORTED_ALGORITHMS:
        raise ValueError(
            f"algorithm {cfg.name!r} is not ported (ported: "
            f"{'|'.join(PORTED_ALGORITHMS)}; the reference also knows "
            f"'bank')")
    if cfg.momentum_dtype not in BANK_DTYPES:
        raise ValueError(f"momentum_dtype {cfg.momentum_dtype!r} is not "
                         f"ported (ported: {'|'.join(BANK_DTYPES)})")
    if cfg.server_compute_dtype != "float32":
        raise ValueError(f"server_compute_dtype {cfg.server_compute_dtype!r}"
                         f" is not ported (the server computes in float32)")
    return BANK_DTYPES[cfg.momentum_dtype]


def init_state(cfg: AlgorithmConfig, d: int, device=None) -> ServerState:
    """Initial server state under ``cfg``'s resolved layout, on ``device``
    (default the card): the momentum bank (and dasha's mirrors) in
    ``momentum_dtype``, dasha's previous gradients in float32. A layout
    that prunes dasha's slots raises."""
    mdt = _check_ported(cfg)
    dev = resolve_device(device)
    layout = cfg.resolved_state_layout()
    if cfg.name == "dasha" and not layout.is_full:
        raise ValueError(
            "state layout prunes mirror/prev_grad but dasha needs them (its "
            "MVR mirror state cannot be pruned)")
    zeros = torch.zeros((cfg.n_workers, d), dtype=mdt, device=dev)
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
    # Step 5: per-worker momentum m = beta*m_prev + (1-beta)*wire in
    # float32, as one fused multiply-add (torch.add with alpha is an FMA on
    # the CPU and on the card) that rounds as XLA's fusion of the
    # reference's compiled round does: onto (1-beta)*wire on float32 banks,
    # fma(beta, m, (1-beta) w); onto beta*m_prev on bfloat16 banks,
    # fma(1-beta, w, beta m) (ROADMAP Queue 3). The momentum kernel rounds
    # the same way. The add is in place on the fresh product (one [n, D]
    # buffer fewer); the wire itself may be the caller's gradients
    # (sparsifier 'none') and is left alone.
    beta, one_m_beta = hparams[0], hparams[2]
    if state.momentum.dtype == torch.bfloat16:
        m = (state.momentum.float() * beta).add_(wire.float(),
                                                 alpha=one_m_beta)
    else:
        m = (wire.float() * one_m_beta).add_(state.momentum.float(),
                                             alpha=beta)
    # Step 6: robust aggregation of the float32 momenta; the bank keeps
    # their rounding to momentum_dtype.
    r = agg(m)
    new = state._replace(momentum=m.to(state.momentum.dtype),
                         step=state.step + 1)
    return r, new


def _payload_route(cfg: AlgorithmConfig, d: int) -> bool:
    """RoSDHB on global Block-RandK with the kernels and an attack that
    keeps zero columns zero: the round can stay on the wire payload. With a
    global mask every honest row is zero off the selected blocks, so the
    Byzantine rows are too, and the dense wire adds nothing there."""
    sp = cfg.sparsifier
    return (cfg.name == "rosdhb" and C._kernel_eligible(sp, d)
            and not sp.local and cfg.attack.name in A.ZERO_PRESERVING)


def _rosdhb_payload_round(cfg: AlgorithmConfig, agg, state: ServerState,
                          grads: torch.Tensor, draws, hparams,
                          attack_params=None) -> Tuple[torch.Tensor,
                                                       ServerState]:
    # Steps 1-3 on the wire: the block ids and the [n, kb*bs] payload; step
    # 4 on its rows (the attack is per coordinate, so the selected columns
    # get the dense attack's values); step 5 decays the bank in place and
    # adds (1-beta)*payload into the selected blocks in one pass (a
    # bfloat16 bank also hands back the unrounded float32 momenta); step 6
    # aggregates the float32 momenta.
    sp = cfg.sparsifier
    payload, ids = C.compressed_payload(grads, draws, sp)
    payload = _byzantine_overwrite(cfg, payload, attack_params)
    m = RK.momentum_update(state.momentum, payload, ids,
                           block_size=sp.block_size, beta=hparams[0],
                           f32_out=state.momentum.dtype != torch.float32)
    del payload
    return agg(m), state._replace(step=state.step + 1)


def _dasha_round(cfg: AlgorithmConfig, agg, state: ServerState,
                 grads: torch.Tensor, draws, hparams,
                 attack_params=None) -> Tuple[torch.Tensor, ServerState]:
    # Byz-DASHA-PAGE, p = 1 (the reference's _dasha_step):
    #   m_i = g_i + (1-a)(m_i' - g_i')         (m_i = g_i on the first step)
    #   c_i = C((m_i - m_i') + b (m_i' - h_i')),  b = 1/(2 alpha)
    #   h_i = h_i' + c_i, Byzantine rows overwritten; R = F(h_1 .. h_n)
    # Each worker draws its own mask whatever the sparsifier's `local` flag
    # (independent compressors). a*b + c terms are single FMAs, as XLA
    # contracts them in the reference's compiled round.
    if state.mirror is None or state.prev_grad is None:
        raise ValueError("dasha needs the mirror/prev_grad state slots: "
                         "init the state with a dasha config")
    sp = dataclasses.replace(cfg.sparsifier, local=True)
    g32 = grads.float()
    m_prev = state.momentum.float()
    h_prev = state.mirror.float()
    if state.step == 0:
        m = g32
    else:
        m = torch.add(g32, m_prev - state.prev_grad, alpha=hparams[3])
    b = 1.0 / (2.0 * sp.alpha)
    x = torch.add(m - m_prev, m_prev - h_prev, alpha=b)
    h = C.compressed_estimate(x, draws, sp).add_(h_prev)
    del x
    h = _byzantine_overwrite(cfg, h, attack_params)
    r = agg(h)
    mdt = state.momentum.dtype
    return r, ServerState(momentum=m.to(mdt), mirror=h.to(mdt),
                          prev_grad=g32, step=state.step + 1,
                          attack=state.attack)


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
    """Bytes of the ``[n, D]`` server banks under ``cfg``'s layout: RoSDHB
    keeps one momentum vector per worker; a dasha layout adds the mirrors
    (in ``momentum_dtype``) and the float32 previous gradients (3x at
    float32)."""
    n = cfg.n_workers
    layout = cfg.resolved_state_layout()
    mdt_bytes = torch.finfo(BANK_DTYPES[cfg.momentum_dtype]).bits // 8
    total = n * d * mdt_bytes
    if layout.mirror:
        total += n * d * mdt_bytes
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
      state: current server state (its momentum is consumed: the payload
        route updates it in place).
      grads: per-worker gradients ``[n, D]``; the Byzantine rows are
        replaced by the attack.
      draws: the draws provider for this round's masks.
      agg: the aggregator (default ``make_aggregator(cfg.aggregator)`` on
        the gradients' device).
      attack_params: the ``[2]`` coefficients of ``attack.name='linear'``.

    Returns:
      (direction R [D] to descend, next state, aux dict).
    """
    _check_ported(cfg)
    n, d = grads.shape
    if n != cfg.n_workers:
        raise ValueError(f"grads has {n} rows, cfg.n_workers={cfg.n_workers}")
    if agg is None:
        agg = G.make_aggregator(cfg.aggregator, device=grads.device)
    if cfg.name == "robust_dgd":
        wire = _byzantine_overwrite(cfg, grads, attack_params)
        r, new = _robust_dgd_apply(cfg, agg, state, wire)
        return r, new, {"payload_floats_per_worker": d}
    aux = {"payload_floats_per_worker": C.payload_floats(d, cfg.sparsifier)}
    if cfg.name == "dasha":
        r, new = _dasha_round(cfg, agg, state, grads, draws,
                              static_hparams(cfg), attack_params)
    elif _payload_route(cfg, d):
        r, new = _rosdhb_payload_round(cfg, agg, state, grads, draws,
                                       static_hparams(cfg), attack_params)
    else:
        wire = _compressed_wire(cfg, grads, draws, attack_params)
        if cfg.name == "rosdhb":
            r, new = _rosdhb_apply(cfg, agg, state, wire, static_hparams(cfg))
        else:
            r, new = _dgd_apply(cfg, agg, state, wire)
    return r, new, aux


def apply_direction(params_flat: torch.Tensor, r: torch.Tensor,
                    gamma: float) -> torch.Tensor:
    """Step 7: theta <- theta - gamma R, one fused multiply-add (as XLA
    compiles the reference's round)."""
    return torch.add(params_flat, r, alpha=-gamma)
