"""First-class, stateful Byzantine adversaries (counterpart of
``repro.adversary.core``).

An :class:`Adversary` is a named step ``step(state, honest, f, draws,
coeffs) -> (state, byz)``: ``honest`` is the stacked honest wire payload
``[h, d]``, ``byz`` the ``[f, d]`` Byzantine payload, ``coeffs`` a ``[2]``
parameter vector and ``state`` the uniformly-shaped :class:`AttackState`
(two ``[d]`` vector slots, a small scalar slab and a round counter). Every
step also takes a leading lane axis (``honest [L, h, d]``, ``coeffs
[L, 2]``, each state field ``[L, ...]``): a grid bank runs all its lanes of
one adversary in one call, and the lone step is the same code on one lane.

``draws`` is a draws provider (``repro_torch.testing``; gauss takes its
noise and ipm_greedy its two coins from the ``attack`` stream) or, for the
lanes of a grid, an :class:`AttackDraws` already read per lane.

The built-in bank:

* ``linear``     — the stateless mean/std family ``a*mu + b*sd`` (alie,
                   signflip, ipm, foe, zero as coefficient choices).
* ``mimic``      — mimic with a *tracked* target: an online power iteration
                   over the centered honest updates keeps the max-variance
                   direction ``z``; every Byzantine worker copies the honest
                   worker most aligned with it.
* ``gauss``      — honest mean + Gaussian noise.
* ``spectral``   — ``mu - scale * sigma_v * v`` along the carried top
                   covariance direction ``v``.
* ``ipm_greedy`` — epsilon-greedy Inner-Product Manipulation over two scales,
                   valued by the honest mean's round-to-round displacement.

:func:`make_attack_bank` gives each lane its own branch and runs each
branch once on its lanes (the reference's ``lax.switch`` under ``vmap``
computes every branch on every lane).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import aggregators as G
from repro_torch.core import attacks as A

NUM_SCALARS = 4


class AttackState(NamedTuple):
    """Uniformly-shaped adversary state shared by every attack.

    ``vec``:     ``[d]`` direction slot (spectral's power-iteration vector;
                 mimic's alignment direction ``z``).
    ``mu``:      ``[d]`` previous-round honest mean (``ipm_greedy``).
    ``scalars``: ``[NUM_SCALARS]`` (``ipm_greedy``: arm values 0-1, last
                 arm at 2).
    ``step``:    ``[]`` int32 round counter.

    Lanes add a leading axis to every field.
    """

    vec: torch.Tensor
    mu: torch.Tensor
    scalars: torch.Tensor
    step: torch.Tensor


def init_attack_state(d: int, dtype: torch.dtype = torch.float32,
                      device=None, lanes: Optional[int] = None
                      ) -> AttackState:
    """Zero-initialised :class:`AttackState` for a ``d``-dimensional wire
    (``lanes`` adds the leading lane axis)."""
    lead = () if lanes is None else (int(lanes),)
    dev = torch.device("cpu" if device is None else device)
    return AttackState(
        vec=torch.zeros(lead + (d,), dtype=dtype, device=dev),
        mu=torch.zeros(lead + (d,), dtype=dtype, device=dev),
        scalars=torch.zeros(lead + (NUM_SCALARS,), dtype=dtype, device=dev),
        step=torch.zeros(lead, dtype=torch.int32, device=dev))


class AttackDraws(NamedTuple):
    """The attack's draws of one round, per lane: gauss's ``[L, f, d]``
    normals and ipm_greedy's ``[L, 2]`` uniforms (``None`` where no lane
    needs them)."""

    normal: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None

    def take(self, lanes: G.Lanes) -> "AttackDraws":
        return AttackDraws(*(None if t is None else G.take(t, lanes)
                             for t in self))


StepFn = Callable[..., Tuple[AttackState, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Adversary:
    """A named adversary: its lanes step (``[L, ...]`` inputs) plus its bank
    metadata. :meth:`step` takes one lane or many."""

    name: str
    lanes_step: StepFn
    stateful: bool = False
    default_coeffs: Tuple[float, float] = (0.0, 0.0)
    #: what the step draws a round: ``normal`` ([f, d]) or ``uniform`` ([2])
    draws: Tuple[str, ...] = ()

    def draw(self, draws, lanes: int, f: int, d: int) -> AttackDraws:
        """This adversary's draws for ``lanes`` lanes of one seed (the same
        values for every lane), from a provider's ``attack`` stream."""
        normal = uniform = None
        if "normal" in self.draws:
            normal = draws.normal((f, d), stream="attack").expand(
                (lanes, f, d))
        if "uniform" in self.draws:
            uniform = draws.uniform((2,), stream="attack").expand((lanes, 2))
        return AttackDraws(normal, uniform)

    def step(self, state: AttackState, honest: torch.Tensor, f: int, draws,
             coeffs) -> Tuple[AttackState, torch.Tensor]:
        lone = honest.ndim == 2
        coeffs = torch.as_tensor(coeffs, dtype=torch.float32,
                                 device=honest.device)
        if lone:
            state = AttackState(*(t[None] for t in state))
            honest, coeffs = honest[None], coeffs[None]
        if not isinstance(draws, AttackDraws):
            draws = self.draw(draws, honest.shape[0], f, honest.shape[-1])
        new, byz = self.lanes_step(state, honest, f, draws, coeffs)
        if lone:
            return AttackState(*(t[0] for t in new)), byz[0]
        return new, byz


def _bump(state: Optional[AttackState]) -> Optional[AttackState]:
    # the stateless branches run without a state when no lane needs one
    return None if state is None else state._replace(step=state.step + 1)


def _col(v: torch.Tensor) -> torch.Tensor:
    """A ``[L]`` per-lane value shaped ``[L, 1]``."""
    return v.unsqueeze(-1)


def _linear_step(state, honest, f, draws, coeffs):
    """The stateless mean/std family (``attacks.linear_attack``)."""
    return _bump(state), A.linear_attack(honest, f, coeffs)


def _gauss_step(state, honest, f, draws, coeffs):
    """Honest mean + ``coeffs[0]`` times N(0, 1) noise (``attacks.gauss``)."""
    std = coeffs[:, 0].reshape(-1, 1, 1)
    return _bump(state), A.gauss(honest, f, draws.normal.to(honest.dtype),
                                 std=std)


def _power_step(state, honest):
    """One online power-iteration step over the centered honest updates:
    ``(mu, centered, v)`` with ``v`` unit-norm, seeded from the first
    centered update at round 0 and sign-aligned with the carried vector.
    Sums run in a fixed order per lane, so a lane's values do not depend on
    the other lanes of the call."""
    h32 = honest.to(torch.float32)
    mu = A._mean32(h32)
    c = h32 - mu.unsqueeze(-2)
    first = _col(state.step == 0)
    v_prev = torch.where(first, c[:, 0], state.vec)
    s = (c * v_prev.unsqueeze(-2)).sum(-1)                 # c @ v   [L, h]
    w = (s.unsqueeze(-1) * c).sum(-2) + 1e-12 * v_prev     # c.T @ s [L, d]
    w = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
    w = torch.where(_col((w * v_prev).sum(-1) < 0), -w, w)
    return mu, c, w


def _mimic_step(state, honest, f, draws, coeffs):
    """Tracked-target mimic: copy the honest worker whose centered update
    projects furthest (absolute value) onto the carried direction."""
    _, c, z = _power_step(state, honest)
    target = torch.argmax((c * z.unsqueeze(-2)).sum(-1).abs(), dim=-1)
    byz = honest[torch.arange(honest.shape[0], device=honest.device), target]
    return _bump(state)._replace(vec=z), A._rows(byz, f)


def _spectral_step(state, honest, f, draws, coeffs):
    """ALIE-style shift of ``coeffs[0]`` honest-spread standard deviations
    along the carried top covariance direction."""
    mu, c, v = _power_step(state, honest)
    proj = (c * v.unsqueeze(-2)).sum(-1)
    sigma = torch.sqrt(torch.mean(torch.square(proj), dim=-1) + 1e-12)
    byz = (mu - _col(coeffs[:, 0] * sigma) * v).to(honest.dtype)
    return _bump(state)._replace(vec=v), A._rows(byz, f)


def _ipm_greedy_step(state, honest, f, draws, coeffs):
    """Epsilon-greedy IPM over two scales ``coeffs = (weak, strong)``: the
    previous arm is scored by how far the honest mean moved, the arm values
    are running averages, exploration decays as ``1 / (1 + 0.1 t)``."""
    h32 = honest.to(torch.float32)
    mu = A._mean32(h32)
    reward = torch.linalg.vector_norm(mu - state.mu, dim=-1)
    last_arm = state.scalars[:, 2].to(torch.int64)
    vals = state.scalars[:, :2]
    hot = torch.nn.functional.one_hot(last_arm, 2).to(vals.dtype)
    vals = torch.where(_col(state.step > 0),
                       vals + 0.2 * (_col(reward) - vals) * hot, vals)
    eps_t = 1.0 / (1.0 + 0.1 * state.step.to(torch.float32))
    explore = draws.uniform[:, 0] < eps_t
    rand_arm = (draws.uniform[:, 1] < 0.5).to(torch.int64)
    arm = torch.where(explore, rand_arm, torch.argmax(vals, dim=-1))
    scale = torch.where(arm == 0, coeffs[:, 0], coeffs[:, 1])
    byz = (-_col(scale) * mu).to(honest.dtype)
    scalars = torch.stack([vals[:, 0], vals[:, 1], arm.to(vals.dtype),
                           state.scalars[:, 3]], dim=-1)
    new = _bump(state)._replace(mu=mu, scalars=scalars)
    return new, A._rows(byz, f)


#: The adversary registry. ``linear`` covers the stateless mean/std family
#: through its coefficients; the rest are the stateful or stochastic ones.
ADVERSARIES = {
    "linear": Adversary("linear", _linear_step, stateful=False),
    "mimic": Adversary("mimic", _mimic_step, stateful=True),
    "gauss": Adversary("gauss", _gauss_step, stateful=False,
                       default_coeffs=(1.0, 0.0), draws=("normal",)),
    "spectral": Adversary("spectral", _spectral_step, stateful=True,
                          default_coeffs=(1.5, 0.0)),
    "ipm_greedy": Adversary("ipm_greedy", _ipm_greedy_step, stateful=True,
                            default_coeffs=(0.5, 5.0), draws=("uniform",)),
}

#: Default branch order of the full attack bank.
DEFAULT_ATTACK_BANK: Tuple[str, ...] = ("linear", "mimic", "gauss",
                                        "spectral", "ipm_greedy")

#: Attack names a grid scenario may name. ``linear`` and ``bank`` are
#: internal to the engine (their parameters arrive per lane).
KNOWN_ATTACKS: Tuple[str, ...] = (
    "none", "alie", "signflip", "ipm", "foe", "zero",
    "mimic", "gauss", "spectral", "ipm_greedy")


def is_stateful(name: str) -> bool:
    a = ADVERSARIES.get(name)
    return a is not None and a.stateful


def needs_attack_state(attack_name: str, f: int) -> bool:
    """Whether a config's server state carries the :class:`AttackState`."""
    if f == 0 or attack_name == "none":
        return False
    return attack_name == "bank" or is_stateful(attack_name)


def bank_entry(cfg: A.AttackConfig, n: int, f: int
               ) -> Optional[Tuple[str, Tuple[float, float]]]:
    """``(branch, coeffs)``: the attack-bank branch that runs ``cfg`` and
    its ``[2]`` parameters, or ``None`` for attacks that cannot join a bank
    (``none``, and the internal ``linear`` and ``bank``)."""
    coeffs = A.linear_coeffs(cfg, n, f)
    if coeffs is not None:
        return ("linear", coeffs)
    if cfg.name == "mimic":
        return ("mimic", (0.0, 0.0))
    if cfg.name == "gauss":
        return ("gauss", (cfg.scale or 1.0, 0.0))
    if cfg.name == "spectral":
        return ("spectral", (cfg.scale or 1.5, 0.0))
    if cfg.name == "ipm_greedy":
        return ("ipm_greedy", (cfg.scale or 0.5, 5.0))
    return None


def static_coeffs(cfg: A.AttackConfig, n: int, f: int) -> torch.Tensor:
    """The ``[2]`` float32 coefficients of a statically configured attack."""
    entry = bank_entry(cfg, n, f)
    if entry is None:
        raise ValueError(f"attack {cfg.name!r} has no bank entry")
    return torch.tensor(entry[1], dtype=torch.float32)


def attack_index(name: str,
                 entries: Optional[Sequence[str]] = None) -> int:
    """Branch index of adversary ``name`` inside ``entries`` (default the
    full :data:`DEFAULT_ATTACK_BANK`)."""
    entries = tuple(entries) if entries is not None else DEFAULT_ATTACK_BANK
    try:
        return entries.index(name)
    except ValueError:
        raise ValueError(
            f"adversary {name!r} is not a branch of the attack bank "
            f"{entries}") from None


BankStepFn = Callable[..., Tuple[AttackState, torch.Tensor]]


def make_attack_bank(entries: Sequence[str], f: int) -> BankStepFn:
    """Build the attack bank ``step(state, honest, draws, idx, coeffs) ->
    (state, byz)`` over lanes: ``honest [B, h, d]``, ``idx`` the branch of
    each lane (host ints or a tensor), ``coeffs [B, 2]``, ``draws`` an
    :class:`AttackDraws` read per lane. Each branch runs once, on its lanes;
    a lane's state and rows are its lone step's. ``f`` holds for every
    branch."""
    entries = tuple(entries)
    unknown = [e for e in entries if e not in ADVERSARIES]
    if unknown:
        raise ValueError(
            f"unknown attack-bank entries {unknown} (known adversaries: "
            f"{'|'.join(ADVERSARIES)})")
    if not entries:
        raise ValueError("attack bank needs at least one entry")

    def apply(state: AttackState, honest: torch.Tensor, draws: AttackDraws,
              idx, coeffs: torch.Tensor) -> Tuple[AttackState, torch.Tensor]:
        idx = G.host_values(idx)
        if any(not 0 <= i < len(entries) for i in idx):
            raise ValueError(f"attack branch index outside the bank's "
                             f"{len(entries)} entries: {idx}")
        groups = G.lane_groups(idx, honest.device)
        if len(groups) == 1:
            return ADVERSARIES[entries[groups[0][0]]].lanes_step(
                state, honest, f, draws, coeffs)
        byz = honest.new_empty(honest.shape[:-2] + (f, honest.shape[-1]))
        new = None if state is None else AttackState(
            *(t.clone() for t in state))
        for branch, lanes, _ in groups:
            sub = None if state is None else AttackState(
                *(G.take(t, lanes) for t in state))
            st, b = ADVERSARIES[entries[branch]].lanes_step(
                sub, G.take(honest, lanes), f,
                draws.take(lanes) if draws is not None else None,
                G.take(coeffs, lanes))
            byz[lanes] = b
            if new is not None:
                for dst, src in zip(new, st):
                    dst[lanes] = src
        return new, byz

    return apply
