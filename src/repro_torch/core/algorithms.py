"""Server-side algorithms on flat gradient banks (counterpart of
``repro.core.algorithms``, static path).

Ported: ``rosdhb`` (the paper's Algorithm 1, global or local sparsification),
``dasha`` (Byz-DASHA-PAGE with p = 1, the baseline the paper measures
RoSDHB against), ``robust_dgd`` (robust aggregation of raw gradients) and
``dgd`` (compressed, non-robust mean), and ``bank``: the algorithm bank of
the Table-1 grid (:func:`make_algorithm_bank`), which runs ``B`` lanes at
once, each with its own algorithm, attack, aggregator and hyperparameters
(:class:`ScenarioParams`).

Every function works on ``[n_workers, D]`` banks. The random draws of a round
(RandK masks) come from a draws provider (``repro_torch.testing``). The
server banks are float32, bfloat16, float16 or float8_e4m3fn
(``momentum_dtype``); every store into a float8 bank rounds as the
reference's does (``utils.dtypes.to_dtype``: NaN past the largest finite
value, where PyTorch saturates). RoSDHB's momentum and aggregation run in
``server_compute_dtype`` (float32, bfloat16 or float16).

The streaming parameter server (``repro_torch.serve``) runs the memoryless
algorithms split in two: the clients' wire half (:func:`make_wire_fn`) and
the server's apply half (:func:`make_serve_apply_fn`), which also takes a
``present`` row mask and a staleness ``discount`` per row.

For RoSDHB on global Block-RandK (:func:`_payload_route`) the round never
builds the dense wire: the Byzantine overwrite runs on the
``[n, kb * block_size]`` payload and the momentum kernel
(``repro_torch.kernels.randk.momentum_update``) decays the bank and adds
the payload into the selected blocks in one pass, bitwise the dense round.

The lanes of a grid (``grads [B, n, D]``, :func:`_lanes_round`) carry an
explicit leading lane axis. Each lane's values are those of its lone round:
the round groups the lanes by algorithm (and hyperparameter values), runs
each algorithm's wire step on its lanes, the attack bank once over all
lanes, and the aggregator bank once over all lanes, so the kernels launch
once per branch whatever ``B``. The per-lane values a compiled JAX bank
traces (branch indices, hyperparameters, step sizes) are plan data here,
read on the host once.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import aggregators as G
from repro_torch.core import attacks as A
from repro_torch.core import compression as C
from repro_torch.core import wire as W
from repro_torch.device import resolve_device
from repro_torch.kernels.randk import ops as RK
from repro_torch.utils.dtypes import FLOAT8, lowp, to_dtype

#: Branch order of the full algorithm bank (and the known algorithms).
ALGO_BANK: Tuple[str, ...] = ("rosdhb", "dasha", "robust_dgd", "dgd")
PORTED_ALGORITHMS: Tuple[str, ...] = ALGO_BANK + ("bank",)

#: Server bank dtypes the port keeps (``AlgorithmConfig.momentum_dtype``).
BANK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16, "float8_e4m3fn": FLOAT8}
#: The dtypes of RoSDHB's server arithmetic
#: (``AlgorithmConfig.server_compute_dtype``). float8 is not one: PyTorch
#: has no float8 arithmetic, so a float8 compute dtype raises.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "float16": torch.float16}


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
      name: ``rosdhb`` | ``dasha`` | ``robust_dgd`` | ``dgd`` | ``bank``
        (the algorithm bank: each lane's algorithm from
        ``ScenarioParams.algo_idx``, see :func:`make_algorithm_bank`).
      n_workers: total workers n.
      f: number of Byzantine workers (the first ``f`` indices).
      gamma: learning rate.
      beta: momentum coefficient; ``None`` -> Theorem 1's
        ``sqrt(1 - 24 gamma L)`` with ``smoothness_L``.
      smoothness_L: Lipschitz constant estimate for the beta schedule.
      mvr_a: DASHA's MVR coefficient ``a`` (default ``1 - beta``).
      sparsifier, aggregator, attack: the round's components.
      momentum_dtype: dtype of the server banks (:data:`BANK_DTYPES`;
        dasha's previous gradients stay float32).
      server_compute_dtype: dtype of RoSDHB's momentum and aggregation
        (:data:`COMPUTE_DTYPES`, :func:`_momentum`).
      clip_norm: per-worker L2 clip of the gradients before compression
        (``None``: no clip).
      bank: the algorithm branches when ``name='bank'`` (``None``: the full
        :data:`ALGO_BANK`); each lane's hyperparameters then come from its
        ``ScenarioParams``.
      state_layout: an explicit :class:`StateLayout`, or ``None`` for the
        minimal layout of the algorithms the config can run.
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
    clip_norm: Optional[float] = None
    bank: Optional[Tuple[str, ...]] = None
    state_layout: Optional[StateLayout] = None

    @property
    def honest(self) -> int:
        return self.n_workers - self.f

    def algorithms(self) -> Tuple[str, ...]:
        """The algorithm branches this config can run: the bank's entries
        for ``name='bank'``, else the one algorithm."""
        if self.name == "bank":
            return tuple(self.bank) if self.bank else ALGO_BANK
        return (self.name,)

    def resolved_state_layout(self) -> StateLayout:
        if self.state_layout is not None:
            return self.state_layout
        return StateLayout.for_algorithms(self.algorithms())

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


def theorem1_hparams(L: float, ratio: float,
                     c: float = 23200.0) -> Tuple[float, float]:
    """Theorem 1's (gamma, beta): gamma = (k/d)/(cL), beta = sqrt(1-24 gamma L)
    (c = 23200 is the paper's conservative analysis constant)."""
    gamma = ratio / (c * L)
    beta = math.sqrt(1.0 - 24.0 * gamma * L)
    return gamma, beta


class ScenarioParams(NamedTuple):
    """Per-lane scenario values of a grid bank (the reference's traced
    ``ScenarioParams``): each present field has a leading lane (or cell)
    axis and overrides the static config. Host tensors: the round reads
    them once to group the lanes.

    ``attack_coeffs``: ``[B, 2]`` attack parameters (the linear family's
    ``(a, b)``, or an attack-bank branch's vector).
    ``attack_idx``: ``[B]`` attack-bank branch (``cfg.attack.name='bank'``).
    ``agg_idx``: ``[B]`` aggregator-bank branch.
    ``ratio``: ``[B]`` keep-ratio (``compression.TRACED_RATIO_KINDS``).
    ``algo_idx``: ``[B]`` algorithm-bank branch (``cfg.name='bank'``).
    ``hparams``: ``[B, 4]`` ``(beta, mvr_a, 1-beta, 1-mvr_a)``, float32,
    the complements computed in double precision at plan time
    (:func:`static_hparams`), so a bank lane rounds as its lone algorithm.
    ``gamma``: ``[B]`` step size, used by the simulator's update.
    """

    attack_coeffs: Optional[torch.Tensor] = None
    attack_idx: Optional[torch.Tensor] = None
    agg_idx: Optional[torch.Tensor] = None
    ratio: Optional[torch.Tensor] = None
    algo_idx: Optional[torch.Tensor] = None
    hparams: Optional[torch.Tensor] = None
    gamma: Optional[torch.Tensor] = None


class ServerState(NamedTuple):
    """Server-side state: the ``[n, D]`` momentum bank, DASHA's optional
    banks (``None`` under the pruned layout), the round counter, and the
    adversary's memory (``repro_torch.adversary.AttackState``; ``None`` for
    the stateless attacks). A grid's lanes add a leading ``[B]`` axis to
    every tensor; the counter is shared."""

    momentum: torch.Tensor
    mirror: Optional[torch.Tensor]
    prev_grad: Optional[torch.Tensor]
    step: int
    attack: Optional[Any] = None


def _adversary():
    # local import: repro_torch.adversary imports the sweep engine, which
    # imports this module
    from repro_torch.adversary import core as adv
    return adv


def _check_ported(cfg: AlgorithmConfig) -> torch.dtype:
    """Raise on what the port cannot run; returns the bank dtype."""
    if cfg.name not in PORTED_ALGORITHMS:
        raise ValueError(
            f"unknown algorithm: {cfg.name!r} (expected one of "
            f"{'|'.join(PORTED_ALGORITHMS)})")
    if cfg.momentum_dtype not in BANK_DTYPES:
        raise ValueError(f"momentum_dtype {cfg.momentum_dtype!r} is not "
                         f"ported (ported: {'|'.join(BANK_DTYPES)})")
    if cfg.server_compute_dtype not in COMPUTE_DTYPES:
        why = (": PyTorch has no float8 arithmetic" if "float8" in
               cfg.server_compute_dtype else "")
        raise ValueError(f"server_compute_dtype {cfg.server_compute_dtype!r}"
                         f" is not ported{why} (ported: "
                         f"{'|'.join(COMPUTE_DTYPES)})")
    return BANK_DTYPES[cfg.momentum_dtype]


def init_state(cfg: AlgorithmConfig, d: int, device=None,
               lanes: Optional[int] = None) -> ServerState:
    """Initial server state under ``cfg``'s resolved layout, on ``device``
    (default the card): the momentum bank (and dasha's mirrors) in
    ``momentum_dtype``, dasha's previous gradients in float32, and the
    adversary's memory where the attack needs it
    (``adversary.needs_attack_state``). ``lanes`` adds the leading lane
    axis of a grid. A layout that prunes dasha's slots from a config that
    can run dasha raises."""
    mdt = _check_ported(cfg)
    dev = resolve_device(device)
    layout = cfg.resolved_state_layout()
    if "dasha" in cfg.algorithms() and not layout.is_full:
        raise ValueError(
            "state layout prunes mirror/prev_grad but the config can run a "
            f"dasha branch (algorithms={cfg.algorithms()}): dasha's MVR "
            "mirror state cannot be pruned")
    lead = () if lanes is None else (int(lanes),)
    shape = lead + (cfg.n_workers, d)
    zeros = torch.zeros(shape, dtype=mdt, device=dev)
    adv = _adversary()
    atk = (adv.init_attack_state(d, device=dev, lanes=lanes)
           if adv.needs_attack_state(cfg.attack.name, cfg.f) else None)
    return ServerState(
        momentum=zeros,
        mirror=zeros.clone() if layout.mirror else None,
        prev_grad=torch.zeros(shape, device=dev)
        if layout.prev_grad else None,
        step=0, attack=atk)


def _attack(cfg: AlgorithmConfig, atk_state, wire: torch.Tensor, draws,
            attack_params=None) -> Tuple[torch.Tensor, Any]:
    """Replace rows [0, f) of the wire with the attack computed from the
    honest rows [f, n): the stateful adversaries (the tracked mimic,
    spectral, ipm_greedy) step their carried memory; the rest are the
    stateless dispatch (gauss draws its noise from ``draws``). Returns the
    new wire and the adversary's new memory."""
    name = cfg.attack.name
    if cfg.f == 0 or name == "none":
        return wire, atk_state
    honest = wire[cfg.f:]
    adv = _adversary()
    if name == "bank":
        raise ValueError("the attack bank runs over lanes: call server_round "
                         "with a ScenarioParams (see sweep.FusedBank)")
    if adv.is_stateful(name):
        if atk_state is None:
            raise ValueError(
                f"stateful attack {name!r} needs the adversary memory: build "
                "the server state with init_state(cfg, d) (ServerState.attack)")
        coeffs = (attack_params if attack_params is not None
                  else adv.static_coeffs(cfg.attack, cfg.n_workers, cfg.f))
        atk_state, byz = adv.ADVERSARIES[name].step(atk_state, honest, cfg.f,
                                                    draws, coeffs)
    else:
        byz = A.apply_attack(cfg.attack, honest, cfg.f, params=attack_params,
                             draws=draws)
    return torch.cat([byz.to(wire.dtype), honest], dim=0), atk_state


def _byzantine_overwrite(cfg: AlgorithmConfig, wire: torch.Tensor,
                         attack_params=None, draws=None) -> torch.Tensor:
    """:func:`_attack` for the attacks that keep no memory."""
    return _attack(cfg, None, wire, draws, attack_params)[0]


def _compressed_wire(cfg: AlgorithmConfig, grads: torch.Tensor, draws,
                     attack_params=None) -> torch.Tensor:
    # Steps 1-4: the round's masks and the unbiased reconstruction, then the
    # Byzantine overwrite of the wire quantity (stateless attacks).
    g_tilde = C.compressed_estimate(grads, draws, cfg.sparsifier)
    return _byzantine_overwrite(cfg, g_tilde, attack_params, draws)


def _momentum_fma(m_prev: torch.Tensor, wire: torch.Tensor, beta: float,
                  one_m_beta: float) -> torch.Tensor:
    """``beta * m_prev + (1 - beta) * wire`` in float32 as one fused
    multiply-add rounding as XLA's fusion of the reference's compiled round
    does: onto ``(1-beta)*wire`` on float32 banks, ``fma(beta, m, (1-beta)
    w)``; onto ``beta*m_prev`` on bfloat16 banks, ``fma(1-beta, w, beta m)``
    (ROADMAP Queue 3). In place on the fresh product (the wire may be the
    caller's gradients)."""
    if m_prev.dtype == torch.bfloat16:
        return (m_prev.float() * beta).add_(wire.float(), alpha=one_m_beta)
    return (wire.float() * one_m_beta).add_(m_prev.float(), alpha=beta)


def _momentum(m_prev: torch.Tensor, wire: torch.Tensor, beta: float,
              one_m_beta: float, cdt: torch.dtype, present=None,
              discount=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 5 in the compute dtype ``cdt``: ``beta * m_prev + (1 - beta) *
    discount * wire`` on the rows that reported, ``m_prev`` on the others.
    Returns ``(m, keep)``: the momenta the aggregation takes and what the
    bank keeps before its rounding to ``momentum_dtype``.

    float32: one fused multiply-add (:func:`_momentum_fma`). bfloat16 rounds
    as the reference's compiled round does (``test_torch_momentum.py::
    test_bf16_compute_dtype_matches_the_reference``): ``beta``, ``1-beta``,
    the operands and each product are bfloat16, the sum is one float32 add;
    the aggregation takes it rounded to bfloat16, a float32 bank keeps it
    unrounded (XLA elides the round trip where ``m`` is widened), a narrower
    bank its bfloat16 rounding. float16 rounds as that round does on
    float16 (``test_torch_bank_dtypes.py::
    test_float16_compute_dtype_matches_the_reference``): one product in
    float16, then one float32 fused multiply-add of the other onto it,
    rounded to float16, which every bank keeps; the product rounded first
    is ``(1-beta) * w`` on float32 and float16 banks, ``beta * m`` on
    bfloat16 and float8 ones (the products XLA contracts there)."""
    if cdt == torch.float32:
        w = wire if discount is None else wire.float() * discount[:, None]
        m = _momentum_fma(m_prev, w, beta, one_m_beta)
        if present is not None:
            m = torch.where(present[:, None], m, m_prev.float())
        return m, m
    rnd = lambda v: float(torch.tensor(v, dtype=cdt))  # noqa: E731
    mp = m_prev.to(cdt)
    w = wire.to(cdt)
    if discount is not None:
        w = w * discount.to(cdt)[:, None]
    if cdt == torch.float16:
        if m_prev.dtype in (torch.bfloat16, FLOAT8):
            m = (mp * rnd(beta)).float().add_(w.float(),
                                              alpha=rnd(one_m_beta))
        else:
            m = (w * rnd(one_m_beta)).float().add_(mp.float(),
                                                   alpha=rnd(beta))
        m = m.to(cdt)
        if present is not None:
            m = torch.where(present[:, None], m, mp)
        return m, m
    keep = (mp * rnd(beta)).float() + (w * rnd(one_m_beta)).float()
    if present is not None:
        keep = torch.where(present[:, None], keep, mp.float())
    m = keep.to(cdt)
    return m, (keep if m_prev.dtype == torch.float32 else m)


def _rosdhb_apply(cfg: AlgorithmConfig, agg, state: ServerState,
                  wire: torch.Tensor, hparams, present=None,
                  discount=None) -> Tuple[torch.Tensor, ServerState]:
    # Step 5: per-worker momentum m = beta*m_prev + (1-beta)*wire in
    # server_compute_dtype (float32: one fused multiply-add, as torch.add
    # with alpha is on the CPU and on the card; the momentum kernel rounds
    # the same way). The streaming server's rows that did not report keep
    # their momentum; late rows are weighted by their discount. Step 6:
    # robust aggregation of the momenta; the bank keeps their rounding to
    # momentum_dtype.
    m, keep = _momentum(state.momentum, wire, hparams[0], hparams[2],
                        COMPUTE_DTYPES[cfg.server_compute_dtype], present,
                        discount)
    r = agg(m)
    new = state._replace(momentum=to_dtype(keep, state.momentum.dtype),
                         step=state.step + 1)
    return r, new


def _payload_route(cfg: AlgorithmConfig, d: int) -> bool:
    """RoSDHB on global Block-RandK with the kernels and an attack that
    keeps zero columns zero: the round can stay on the wire payload. With a
    global mask every honest row is zero off the selected blocks, so the
    Byzantine rows are too, and the dense wire adds nothing there."""
    sp = cfg.sparsifier
    return (cfg.name == "rosdhb" and C._kernel_eligible(sp, d)
            and not sp.local and cfg.attack.name in A.ZERO_PRESERVING
            and cfg.server_compute_dtype == "float32")


#: Columns of the ``[n, D]`` bank that one pass of the dense RoSDHB round
#: takes at a time (:func:`_rosdhb_dense_columns`).
DENSE_COLUMNS = 1 << 24


def _dense_by_columns(cfg: AlgorithmConfig, d: int) -> bool:
    """The dense RoSDHB round is a function of each column on its own: the
    masks drawn once, the dense wire (no kernel round trip), an attack
    and an aggregator that work coordinate by coordinate."""
    return (cfg.name == "rosdhb"
            and not C._kernel_eligible(cfg.sparsifier, d)
            and cfg.attack.name in A.ZERO_PRESERVING
            and cfg.aggregator.name in ("cwtm", "median", "mean")
            and not cfg.aggregator.pre_nnm)


def _rosdhb_dense_columns(cfg: AlgorithmConfig, agg, state: ServerState,
                          grads: torch.Tensor, draws, hparams,
                          attack_params=None) -> Tuple[torch.Tensor,
                                                       ServerState]:
    # Steps 1-6 of the dense round a slice of DENSE_COLUMNS columns at a
    # time: the round's masks drawn once, then compress, the attack, the
    # momentum and the aggregation of each slice, bitwise the whole
    # round's (every step works column by column). At D ~ 1e9 the whole
    # round's float32 [n, D] transients would not fit one card.
    n, d = grads.shape
    mask = C.make_masks(draws, n, d, cfg.sparsifier, grads.dtype)
    cdt = COMPUTE_DTYPES[cfg.server_compute_dtype]
    momentum = torch.empty_like(state.momentum)
    r = None
    for lo in range(0, d, DENSE_COLUMNS):
        cols = slice(lo, min(d, lo + DENSE_COLUMNS))
        wire = _byzantine_overwrite(cfg, C.compress(
            grads[:, cols], mask[..., cols], cfg.sparsifier), attack_params,
            draws)
        m, keep = _momentum(state.momentum[:, cols], wire, hparams[0],
                            hparams[2], cdt)
        part = agg(m)
        if r is None:
            r = part.new_empty(part.shape[:-1] + (d,))
        r[..., cols] = part
        momentum[:, cols] = to_dtype(keep, momentum.dtype)
        del wire, m, keep, part
    return r, state._replace(momentum=momentum, step=state.step + 1)


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
    payload = _byzantine_overwrite(cfg, payload, attack_params, draws)
    m = RK.momentum_update(state.momentum, payload, ids,
                           block_size=sp.block_size, beta=hparams[0],
                           f32_out=state.momentum.dtype != torch.float32)
    del payload
    return agg(m), state._replace(step=state.step + 1)


def _dasha_wire(state_m: torch.Tensor, state_h: torch.Tensor,
                state_prev: torch.Tensor, grads: torch.Tensor, step: int,
                one_m_a: float, b: float, compress
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Byz-DASHA-PAGE's wire before the attack, p = 1 (the reference's
    ``_dasha_step``):
      m_i = g_i + (1-a)(m_i' - g_i')         (m_i = g_i on the first step)
      c_i = C((m_i - m_i') + b (m_i' - h_i')),  b = 1/(2 alpha)
      h_i = h_i' + c_i
    ``compress`` is C on ``[..., n, D]``. a*b + c terms are single FMAs, as
    XLA contracts them in the reference's compiled round. Returns
    ``(h, m, g32)``."""
    g32 = grads.float()
    m_prev = state_m.float()
    h_prev = state_h.float()
    if step == 0:
        m = g32
    else:
        m = torch.add(g32, m_prev - state_prev, alpha=one_m_a)
    x = torch.add(m - m_prev, m_prev - h_prev, alpha=b)
    return compress(x).add_(h_prev), m, g32


def _dasha_round(cfg: AlgorithmConfig, agg, state: ServerState,
                 grads: torch.Tensor, draws, hparams,
                 attack_params=None) -> Tuple[torch.Tensor, ServerState]:
    # Each worker draws its own mask whatever the sparsifier's `local` flag
    # (independent compressors).
    if state.mirror is None or state.prev_grad is None:
        raise ValueError("dasha needs the mirror/prev_grad state slots: "
                         "init the state with a dasha config")
    sp = dataclasses.replace(cfg.sparsifier, local=True)
    h, m, g32 = _dasha_wire(
        state.momentum, state.mirror, state.prev_grad, grads, state.step,
        hparams[3], 1.0 / (2.0 * sp.alpha),
        lambda x: C.compressed_estimate(x, draws, sp))
    h, atk = _attack(cfg, state.attack, h, draws, attack_params)
    r = agg(h)
    mdt = state.momentum.dtype
    return r, ServerState(momentum=to_dtype(m, mdt), mirror=to_dtype(h, mdt),
                          prev_grad=g32, step=state.step + 1, attack=atk)


def _row_mask(wire: torch.Tensor, prev: torch.Tensor, present: torch.Tensor,
              discount: torch.Tensor) -> torch.Tensor:
    """The streaming server's row bank: rows that did not report keep
    ``prev``; the others take ``discount * wire`` (1.0 for a fresh row, an
    exact multiply, so full participation is the unmasked round)."""
    eff = lowp(torch.mul, wire, to_dtype(discount[:, None], wire.dtype),
               dtype=wire.dtype)
    return torch.where(present[:, None], eff, prev)


def _dgd_apply(cfg, agg, state, wire, present=None, discount=None):
    # Compressed DGD, non-robust: the plain mean (the aggregator is unused).
    del agg
    if present is None:
        return wire.mean(dim=0), state._replace(step=state.step + 1)
    # streamed: the momentum slot doubles as the last-received wire bank
    bank = _row_mask(wire, to_dtype(state.momentum, wire.dtype), present,
                     discount)
    return bank.mean(dim=0), state._replace(
        momentum=to_dtype(bank, state.momentum.dtype), step=state.step + 1)


def _robust_dgd_apply(cfg, agg, state, wire, present=None, discount=None):
    # Robust DGD without compression: aggregate the raw gradients.
    if present is None:
        return agg(wire), state._replace(step=state.step + 1)
    bank = _row_mask(wire, to_dtype(state.momentum, wire.dtype), present,
                     discount)
    return agg(bank), state._replace(
        momentum=to_dtype(bank, state.momentum.dtype), step=state.step + 1)


def static_hparams(cfg: AlgorithmConfig) -> Tuple[float, float, float, float]:
    """``(beta, mvr_a, 1-beta, 1-mvr_a)``, complements in double precision
    (the constants the reference folds in); the slots an algorithm does not
    use are 0 and 1."""
    beta = cfg.resolved_beta() if cfg.name == "rosdhb" else 0.0
    a = cfg.resolved_mvr_a() if cfg.name == "dasha" else 0.0
    return (beta, a, 1.0 - beta, 1.0 - a)


#: Algorithms the streaming parameter server (``repro_torch.serve``) runs:
#: the memoryless-wire rules, whose client payload depends only on the
#: current gradient and the round's broadcast draws. ``dasha`` is excluded:
#: its wire is a compressed difference against server-side mirrors and
#: per-client momentum, so its control variates go stale the moment a
#: client misses a round.
SERVE_ALGORITHMS: Tuple[str, ...] = ("rosdhb", "robust_dgd", "dgd")

_SERVE_APPLY = {"rosdhb": _rosdhb_apply, "robust_dgd": _robust_dgd_apply,
                "dgd": _dgd_apply}


def _check_serveable(name: str) -> None:
    if name not in SERVE_ALGORITHMS:
        raise ValueError(
            f"algorithm {name!r} cannot run as a streaming service "
            f"(serveable: {'|'.join(SERVE_ALGORITHMS)})"
            + (": dasha's wire is a compressed difference against "
               "server-side mirrors — its per-client control variates go "
               "stale under partial participation" if name == "dasha"
               else ""))


def make_wire_fn(cfg: AlgorithmConfig):
    """The clients' half of a serveable algorithm's round: ``wire_fn(
    atk_state, grads, draws) -> (wire [n, D], new_atk_state)``, the ops
    :func:`server_round` runs before the server's apply (after the clip),
    so a client pool streaming these rows reproduces the simulator's
    trajectory bitwise."""
    _check_serveable(cfg.name)
    _check_ported(cfg)
    if cfg.name == "robust_dgd":
        def wire_fn(atk_state, grads, draws):
            return _attack(cfg, atk_state, grads, draws)  # raw gradients
    else:
        def wire_fn(atk_state, grads, draws):
            return _attack(cfg, atk_state, C.compressed_estimate(
                grads, draws, cfg.sparsifier), draws)
    return wire_fn


def make_serve_apply_fn(cfg: AlgorithmConfig, agg):
    """The server's half: ``apply_fn(state, wire, present, discount) ->
    (direction [D], new ServerState)``. ``present`` is the ``[n]`` bool row
    mask of the clients that reported this round and ``discount`` their
    ``[n]`` float32 staleness weights. With every row present and
    ``discount == 1`` it computes the simulator's round bitwise (a multiply
    by 1.0 and ``where(True, ...)`` are exact)."""
    _check_serveable(cfg.name)
    _check_ported(cfg)
    hparams = static_hparams(cfg)
    apply_half = _SERVE_APPLY[cfg.name]

    def apply_fn(state: ServerState, wire: torch.Tensor,
                 present: torch.Tensor, discount: torch.Tensor
                 ) -> Tuple[torch.Tensor, ServerState]:
        if cfg.name == "rosdhb":
            return apply_half(cfg, agg, state, wire, hparams,
                              present=present, discount=discount)
        return apply_half(cfg, agg, state, wire, present=present,
                          discount=discount)

    return apply_fn


def algo_index(name: str, entries: Optional[Sequence[str]] = None) -> int:
    """Branch index of algorithm ``name`` inside ``entries`` (default the
    full :data:`ALGO_BANK`)."""
    entries = tuple(entries) if entries is not None else ALGO_BANK
    try:
        return entries.index(name)
    except ValueError:
        raise ValueError(
            f"algorithm {name!r} is not a branch of the algorithm bank "
            f"{entries}") from None


def server_state_bytes(cfg: AlgorithmConfig, d: int) -> int:
    """Bytes of the ``[n, D]`` server banks under ``cfg``'s layout: RoSDHB
    keeps one momentum vector per worker; a dasha layout adds the mirrors
    (in ``momentum_dtype``) and the float32 previous gradients (3x at
    float32)."""
    n = cfg.n_workers
    layout = cfg.resolved_state_layout()
    mdt_bytes = BANK_DTYPES[cfg.momentum_dtype].itemsize
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


def _clip(grads: torch.Tensor, clip_norm: float) -> torch.Tensor:
    """Per-worker L2 clip of ``[..., n, D]`` gradients to ``clip_norm``."""
    norms = torch.linalg.vector_norm(grads.float(), dim=-1, keepdim=True)
    scale = torch.clamp(clip_norm / torch.clamp(norms, min=1e-12), max=1.0)
    return grads * scale.to(grads.dtype)


def server_round(cfg: AlgorithmConfig, state: ServerState,
                 grads: torch.Tensor, draws, agg=None,
                 attack_params=None, scenario: Optional[ScenarioParams] = None
                 ) -> Tuple[torch.Tensor, ServerState, dict]:
    """Execute one server round.

    Args:
      cfg: algorithm configuration.
      state: current server state (its momentum is consumed: the payload
        route updates it in place).
      grads: per-worker gradients ``[n, D]``, or ``[B, n, D]`` for the
        lanes of a grid; the Byzantine rows are replaced by the attack.
      draws: the draws provider for this round (a
        ``testing.GridDraws`` for lanes).
      agg: the aggregator (default ``make_round_aggregator(cfg.aggregator)``
        on the gradients' device).
      attack_params: the ``[2]`` coefficients of ``attack.name='linear'``.
      scenario: the lanes' :class:`ScenarioParams` (banks of attacks,
        aggregators, algorithms, ratios). Required by ``name='bank'``.

    Returns:
      (direction R [D] (or [B, D]) to descend, next state, aux dict).
    """
    _check_ported(cfg)
    n, d = grads.shape[-2:]
    if n != cfg.n_workers:
        raise ValueError(f"grads has {n} rows, cfg.n_workers={cfg.n_workers}")
    if cfg.clip_norm is not None:
        grads = _clip(grads, cfg.clip_norm)
    if grads.ndim == 3 or scenario is not None or "bank" in (
            cfg.name, cfg.attack.name, cfg.aggregator.name):
        run = (make_algorithm_bank(cfg) if cfg.name == "bank"
               else functools.partial(_lanes_round, cfg))
        if grads.ndim == 3:
            return run(state, grads, draws, agg, scenario, attack_params)
        r, new, aux = run(_lift(state), grads[None], draws, agg,
                          _lift_scenario(scenario), attack_params)
        return r[0], _drop(new), {k: v[0] for k, v in aux.items()}
    if agg is None:
        agg = G.make_aggregator(cfg.aggregator, device=grads.device)
    if cfg.name == "robust_dgd":
        wire, atk = _attack(cfg, state.attack, grads, draws, attack_params)
        r, new = _robust_dgd_apply(cfg, agg, state._replace(attack=atk),
                                   wire)
        return r, new, {"payload_floats_per_worker": d}
    aux = {"payload_floats_per_worker": C.payload_floats(d, cfg.sparsifier)}
    if cfg.name == "dasha":
        r, new = _dasha_round(cfg, agg, state, grads, draws,
                              static_hparams(cfg), attack_params)
    elif _payload_route(cfg, d):
        r, new = _rosdhb_payload_round(cfg, agg, state, grads, draws,
                                       static_hparams(cfg), attack_params)
    elif _dense_by_columns(cfg, d):
        r, new = _rosdhb_dense_columns(cfg, agg, state, grads, draws,
                                       static_hparams(cfg), attack_params)
    else:
        # no name holds the unattacked wire: at an LLM's D each [n, D]
        # float32 bank is 13.3 GB
        wire, atk = _attack(cfg, state.attack, C.compressed_estimate(
            grads, draws, cfg.sparsifier), draws, attack_params)
        state = state._replace(attack=atk)
        if cfg.name == "rosdhb":
            r, new = _rosdhb_apply(cfg, agg, state, wire, static_hparams(cfg))
        else:
            r, new = _dgd_apply(cfg, agg, state, wire)
    return r, new, aux


def make_round_aggregator(cfg: G.AggregatorConfig, device=None):
    """The aggregator a round takes: the bank for ``name='bank'``
    (``agg(x, idx)``), else the rule (``agg(x)``)."""
    if cfg.name == "bank":
        return G.make_aggregator_bank(cfg, device=device)
    return G.make_aggregator(cfg, device=device)


# --------------------------------------------------------------------------
# Lanes: the grid's [B, n, D] round
# --------------------------------------------------------------------------


class LaneDraws(NamedTuple):
    """One round's draws read per lane: the global masks ``[B, D]``, the
    per-worker masks ``[B, n, D]`` and the attack's draws (``None`` where no
    lane needs them; a mask is ``None`` too when it draws nothing)."""

    global_mask: Optional[torch.Tensor]
    local_mask: Optional[torch.Tensor]
    attack: Any


class _LanePlan(NamedTuple):
    algos: Tuple[str, ...]
    hparams: Tuple[Tuple[float, ...], ...]
    attack_entries: Optional[Tuple[str, ...]]
    attack_idx: Optional[Tuple[int, ...]]
    coeffs: Optional[torch.Tensor]
    agg_idx: Optional[Tuple[int, ...]]
    ratio: Optional[torch.Tensor]


def _per_lane(v, b: int, what: str) -> Tuple:
    vals = G.host_values(v)
    if len(vals) != b:
        raise ValueError(f"{what}: {len(vals)} values for {b} lanes")
    return vals


def _lane_plan(cfg: AlgorithmConfig, sc: Optional[ScenarioParams], b: int,
               device, attack_params) -> _LanePlan:
    """The lanes' algorithm, hyperparameters, attack branch and parameters,
    aggregator branch and ratio, from the scenario or the static config."""
    sc = sc if sc is not None else ScenarioParams()
    entries = cfg.algorithms()
    if cfg.name == "bank":
        if sc.algo_idx is None:
            raise ValueError(
                "algorithm bank needs a per-lane branch selector: pass a "
                "ScenarioParams with algo_idx (and hparams) — see "
                "sweep.FusedBank.scenario_params")
        if sc.hparams is None:
            raise ValueError(
                "algorithm bank needs per-lane hyperparameters: pass a "
                "ScenarioParams with hparams=[beta, mvr_a, 1-beta, 1-mvr_a] "
                "(see algorithms.static_hparams)")
        algos = tuple(entries[i] for i in _per_lane(sc.algo_idx, b,
                                                    "algo_idx"))
    else:
        algos = (cfg.name,) * b
    if sc.hparams is not None:
        rows = torch.as_tensor(sc.hparams).reshape(-1, 4).tolist()
        if len(rows) != b:
            raise ValueError(f"hparams: {len(rows)} rows for {b} lanes")
        hparams = tuple(tuple(r) for r in rows)
    else:
        hparams = (static_hparams(cfg),) * b
    coeffs = sc.attack_coeffs if sc.attack_coeffs is not None \
        else attack_params
    a_entries = a_idx = None
    if cfg.f > 0 and cfg.attack.name != "none":
        adv = _adversary()
        if cfg.attack.name == "bank":
            a_entries = tuple(cfg.attack.bank or adv.DEFAULT_ATTACK_BANK)
            if sc.attack_idx is None or coeffs is None:
                raise ValueError(
                    "bank attack needs per-lane branch selectors: pass a "
                    "ScenarioParams with attack_idx and attack_coeffs (see "
                    "sweep.FusedBank.scenario_params)")
            a_idx = _per_lane(sc.attack_idx, b, "attack_idx")
        else:
            if cfg.attack.name == "linear":
                if coeffs is None:
                    raise ValueError("linear attack needs a coeffs vector")
                branch = "linear"
            else:
                entry = adv.bank_entry(cfg.attack, cfg.n_workers, cfg.f)
                if entry is None:
                    raise ValueError(f"unknown attack: {cfg.attack.name!r}")
                branch = entry[0]
                coeffs = entry[1] if coeffs is None else coeffs
            a_entries, a_idx = (branch,), (0,) * b
        coeffs = torch.as_tensor(coeffs, dtype=torch.float32).reshape(-1, 2)
        coeffs = coeffs.to(device).expand((b, 2)) if len(coeffs) == 1 \
            else coeffs.to(device)
    agg_idx = None
    if cfg.aggregator.name == "bank" or sc.agg_idx is not None:
        if sc.agg_idx is None:
            raise ValueError("aggregator bank needs per-lane branch indices: "
                             "pass a ScenarioParams with agg_idx")
        agg_idx = _per_lane(sc.agg_idx, b, "agg_idx")
    ratio = None
    if sc.ratio is not None:
        ratio = torch.as_tensor(sc.ratio, dtype=torch.float32).reshape(-1)
        ratio = (ratio.expand(b) if len(ratio) == 1 else ratio).to(device)
    return _LanePlan(algos, hparams, a_entries, a_idx, coeffs, agg_idx,
                     ratio)


def _lane_draws(cfg: AlgorithmConfig, lp: _LanePlan, draws, n: int, d: int,
                dtype: torch.dtype) -> LaneDraws:
    """Each kind of draw the lanes need, once per seed, read per lane."""
    from repro_torch.testing import GridDraws
    if isinstance(draws, LaneDraws):
        return draws
    b = len(lp.algos)
    grid = draws if isinstance(draws, GridDraws) else GridDraws([draws],
                                                                (0,) * b)
    if grid.lanes != b:
        raise ValueError(f"draws for {grid.lanes} lanes, grads for {b}")
    sp = cfg.sparsifier
    ratio = lp.ratio
    algos = set(lp.algos)
    compressed = algos & {"rosdhb", "dgd"}

    def masks(spx, local):
        if C._draws_nothing(spx, ratio):
            return None
        raw = grid.per_lane(lambda p: C.mask_draw(
            p, d, spx, local_workers=n if local else 0, ratio=ratio))
        return C.mask_from_draw(raw, d, spx, dtype, ratio)

    global_mask = masks(sp, False) if compressed and not sp.local else None
    local_mask = (masks(dataclasses.replace(sp, local=True), True)
                  if "dasha" in algos or (compressed and sp.local) else None)
    atk = None
    if lp.attack_idx is not None:
        adv = _adversary()
        used = {lp.attack_entries[i] for i in set(lp.attack_idx)}
        kinds = {k for e in used for k in adv.ADVERSARIES[e].draws}
        f = cfg.f
        atk = adv.AttackDraws(
            normal=grid.per_lane(lambda p: p.normal((f, d), stream="attack"))
            if "normal" in kinds else None,
            uniform=grid.per_lane(lambda p: p.uniform((2,), stream="attack"))
            if "uniform" in kinds else None)
    return LaneDraws(global_mask, local_mask, atk)


class _CopyOnWrite:
    """A ``[B, ...]`` state tensor written group by group: a group that
    covers every lane replaces it, the first partial write copies it."""

    def __init__(self, t: Optional[torch.Tensor]):
        self.t, self._own = t, False

    def put(self, lanes: G.Lanes, count: int, v: torch.Tensor) -> None:
        if count == self.t.shape[0]:
            self.t, self._own = v, True
            return
        if not self._own:
            self.t, self._own = self.t.clone(), True
        self.t[lanes] = v


def _lanes_round(cfg: AlgorithmConfig, state: ServerState,
                 grads: torch.Tensor, draws, agg,
                 scenario: Optional[ScenarioParams], attack_params
                 ) -> Tuple[torch.Tensor, ServerState, dict]:
    """One round of ``B`` lanes (``grads [B, n, D]``), each lane its lone
    round: the wire of each algorithm group (steps 1-4 before the attack),
    the attack bank over every lane, then momentum/mirrors per group and the
    aggregator bank over every lane (dgd lanes take the plain mean)."""
    b, n, d = grads.shape
    dev = grads.device
    lp = _lane_plan(cfg, scenario, b, dev, attack_params)
    ld = _lane_draws(cfg, lp, draws, n, d, grads.dtype)
    sp = cfg.sparsifier
    f = cfg.f
    if "dasha" in lp.algos and (state.mirror is None
                                or state.prev_grad is None):
        raise ValueError("dasha needs the mirror/prev_grad state slots: "
                         "init the state with a dasha-capable config")
    ratios = None if lp.ratio is None else G.host_values(lp.ratio)

    def group_key(i):
        algo, hp = lp.algos[i], lp.hparams[i]
        if algo == "rosdhb":
            return (algo, hp[0], hp[2])
        if algo == "dasha":
            # b = 1/(2 alpha): with a lane's ratio, alpha = 1/ratio in
            # float32 as the reference traces it
            b_ = (1.0 / (2.0 * sp.alpha) if ratios is None else float(
                np.float32(1.0) / (np.float32(2.0) * (
                    np.float32(1.0) / np.float32(ratios[i])))))
            return (algo, hp[3], b_)
        return (algo,)

    groups = G.lane_groups(tuple(group_key(i) for i in range(b)), dev)
    # steps 1-4 (before the attack), per group
    parts = []
    for key, lanes, count in groups:
        algo = key[0]
        g = G.take(grads, lanes)
        ratio = None if lp.ratio is None else G.take(lp.ratio, lanes)
        extra = None
        if algo == "robust_dgd":
            w = g
        elif algo == "dasha":
            mask = (None if ld.local_mask is None
                    else G.take(ld.local_mask, lanes))
            spl = dataclasses.replace(sp, local=True)
            w, m, g32 = _dasha_wire(
                G.take(state.momentum, lanes), G.take(state.mirror, lanes),
                G.take(state.prev_grad, lanes), g, state.step, key[1], key[2],
                lambda x: C.compress(x, mask, spl, ratio)
                if mask is not None else x)
            extra = (m, g32)
        else:
            src = ld.local_mask if sp.local else ld.global_mask
            if src is None:  # the mask draws nothing: no compression
                w = g
            else:
                mask = G.take(src, lanes)
                w = C.compress(g, mask if sp.local else mask.unsqueeze(-2),
                               sp, ratio)
        parts.append((key, lanes, count, w, extra))
    if len(parts) == 1:
        wire = parts[0][3]
    else:
        wire = grads.new_empty((b, n, d))
        for _, lanes, _, w, _ in parts:
            wire[lanes] = w
    # step 4: the attack bank over every lane
    atk = state.attack
    if lp.attack_idx is not None:
        adv = _adversary()
        if atk is None and any(adv.is_stateful(lp.attack_entries[i])
                               for i in set(lp.attack_idx)):
            raise ValueError(
                "the attack needs the adversary memory: build the server "
                "state with init_state(cfg, d, lanes=B) (ServerState.attack)")
        atk, byz = adv.make_attack_bank(lp.attack_entries, f)(
            atk, wire[:, f:], ld.attack, lp.attack_idx, lp.coeffs)
        wire = torch.cat([byz.to(wire.dtype), wire[:, f:]], dim=1)
    # step 5 per group, then step 6 over every lane
    mdt = state.momentum.dtype
    cdt = COMPUTE_DTYPES[cfg.server_compute_dtype]
    mom, mir, prev = (_CopyOnWrite(state.momentum), _CopyOnWrite(state.mirror),
                      _CopyOnWrite(state.prev_grad))
    x = wire
    for key, lanes, count, _, extra in parts:
        if key[0] == "rosdhb":
            m, keep = _momentum(G.take(state.momentum, lanes),
                                G.take(wire, lanes), key[1], key[2], cdt)
            if count == b:
                x = m
            else:  # several groups: the wire was assembled afresh
                x[lanes] = m
            mom.put(lanes, count, to_dtype(keep, mdt))
        elif key[0] == "dasha":
            m, g32 = extra
            mom.put(lanes, count, to_dtype(m, mdt))
            mir.put(lanes, count, to_dtype(G.take(wire, lanes), mdt))
            prev.put(lanes, count, g32)
    if agg is None and lp.algos.count("dgd") < b:
        agg = make_round_aggregator(cfg.aggregator, device=dev)
    if lp.agg_idx is not None and cfg.aggregator.name != "bank":
        agg = G.make_aggregator_bank(cfg.aggregator, device=dev)
    robust = tuple(a != "dgd" for a in lp.algos)
    r = None
    for is_robust, lanes, count in G.lane_groups(robust, dev):
        xs = x if count == b else G.take(x, lanes)
        if not is_robust:
            rr = xs.mean(dim=-2)
        elif lp.agg_idx is not None:
            idx = lp.agg_idx if count == b else tuple(
                lp.agg_idx[i] for i in range(b) if robust[i])
            rr = agg(xs, idx)
        else:
            rr = agg(xs)
        if count == b:
            r = rr
        else:
            if r is None:
                r = x.new_empty((b, d))
            r[lanes] = rr
    new = ServerState(momentum=mom.t, mirror=mir.t, prev_grad=prev.t,
                      step=state.step + 1, attack=atk)
    k = C.payload_floats(d, sp)
    if lp.ratio is not None:
        kk = torch.clamp(torch.round(lp.ratio * d), min=1.0)
        payload = torch.where(torch.tensor([a == "robust_dgd"
                                            for a in lp.algos], device=dev),
                              torch.full_like(kk, float(d)), kk)
    else:
        payload = torch.tensor([float(d) if a == "robust_dgd" else float(k)
                                for a in lp.algos], device=dev)
    return r, new, {"payload_floats_per_worker": payload}


def _lift(state: ServerState) -> ServerState:
    """One lane: a leading axis of 1 on every tensor of the state."""
    lift = lambda t: None if t is None else t[None]  # noqa: E731
    atk = state.attack
    if atk is not None:
        atk = type(atk)(*(t[None] for t in atk))
    return ServerState(lift(state.momentum), lift(state.mirror),
                       lift(state.prev_grad), state.step, atk)


def _drop(state: ServerState) -> ServerState:
    drop = lambda t: None if t is None else t[0]  # noqa: E731
    atk = state.attack
    if atk is not None:
        atk = type(atk)(*(t[0] for t in atk))
    return ServerState(drop(state.momentum), drop(state.mirror),
                       drop(state.prev_grad), state.step, atk)


def _lift_scenario(sc: Optional[ScenarioParams]
                   ) -> Optional[ScenarioParams]:
    if sc is None:
        return None
    return ScenarioParams(*(None if v is None else torch.as_tensor(v)[None]
                            for v in sc))


def make_algorithm_bank(cfg: AlgorithmConfig,
                        entries: Optional[Sequence[str]] = None):
    """Build the algorithm bank ``step(state, grads, draws, agg, scenario,
    attack_params=None) -> (R [B, D], state, aux)``: lane ``i`` runs
    algorithm
    ``entries[scenario.algo_idx[i]]`` with its ``scenario.hparams[i]``, over
    the shared state layout (a bank with dasha keeps its mirrors, one
    without prunes them, :class:`StateLayout`). Each algorithm's steps run
    once, on its lanes (:func:`_lanes_round`)."""
    entries = tuple(entries if entries is not None
                    else (cfg.bank or ALGO_BANK))
    if not entries:
        raise ValueError("algorithm bank needs at least one entry")
    unknown = [e for e in entries if e not in ALGO_BANK]
    if unknown:
        raise ValueError(
            f"unknown algorithm-bank entries {unknown} (known algorithms: "
            f"{'|'.join(ALGO_BANK)})")
    if "dasha" in entries and not cfg.resolved_state_layout().is_full:
        raise ValueError(
            "algorithm bank contains a dasha branch but cfg's StateLayout "
            "prunes mirror/prev_grad — dasha's variance-reduction state "
            "cannot be pruned (use StateLayout(True, True) or drop dasha)")
    bank_cfg = dataclasses.replace(cfg, name="bank", bank=entries)

    def apply(state: ServerState, grads: torch.Tensor, draws, agg,
              scenario: ScenarioParams, attack_params=None):
        return _lanes_round(bank_cfg, state, grads, draws, agg, scenario,
                            attack_params)

    return apply


def _bank_payload_floats(entries: Sequence[str], d: int,
                         sp: C.SparsifierConfig, ratio=None) -> torch.Tensor:
    """``[n_entries]`` float32 payload floats per worker of each branch
    (``[n_entries, B]`` for a ``[B]`` ratio)."""
    if ratio is not None:
        k = torch.clamp(torch.round(torch.as_tensor(
            ratio, dtype=torch.float32) * d), min=1.0)
    else:
        k = torch.tensor(float(C.payload_floats(d, sp)))
    return torch.stack([torch.full_like(k, float(d)) if e == "robust_dgd"
                        else k for e in entries])


def apply_direction(params_flat: torch.Tensor, r: torch.Tensor,
                    gamma: float) -> torch.Tensor:
    """Step 7: theta <- theta - gamma R, one fused multiply-add (as XLA
    compiles the reference's round)."""
    return torch.add(params_flat, r, alpha=-gamma)
