"""Byzantine attack strategies (counterpart of ``repro.core.attacks``).

Every attack maps the stacked honest vectors ``honest: [h, d]`` to ``f``
Byzantine vectors ``[f, d]`` (colluding, omniscient attackers). Ported: the
stateless mean/std family (``alie``, ``signflip``, ``ipm``, ``foe``,
``zero`` and the coefficient form ``linear``), the fixed-target ``mimic``
and ``gauss`` (honest mean plus noise from the draws provider). The stateful
adversaries, and the tracked ``mimic`` that ``core.algorithms`` runs, live in
``repro_torch.adversary``. The statistics take any leading axes before the
worker axis (``[..., h, d]``): a grid bank runs every lane at once, each lane
bitwise its lone run.

The worker-axis statistics reproduce the reference's rounding: the mean is a
sequential row sum times ``1/h`` and the population variance (no Bessel
correction, as ``jnp.std``) a sequential fused multiply-add of squares
divided by ``h``, the order XLA's fused reduction takes. Both run in
float32 on bfloat16 and float16 rows too, rounded where the reference
rounds. On float8_e4m3fn rows, which PyTorch has no arithmetic for, every
operation runs in float32 and rounds to float8 as the reference's does
(``utils.dtypes.lowp``), NaN past float8's range included; there the
reference's mean and variance stay in float8 (``jnp.mean`` widens only
float16 and bfloat16), each partial sum rounded (:func:`_stats8`).

:data:`ZERO_PRESERVING` names the attacks that send zero wherever every
honest row is zero: under a global mask their Byzantine rows are zero off
the selected blocks, so the attack can run on the wire payload alone.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch

from repro_torch.utils.dtypes import (FLOAT8, divide, is_float8, lowp,
                                      to_dtype, to_float8)


def _alie_z(n: int, f: int) -> float:
    """z-score threshold of ALIE: z = Phi^-1((n - f - s)/(n - f)) with
    s = floor(n/2 + 1) - f supporters needed to shift the median."""
    h = n - f
    s = math.floor(n / 2 + 1) - f
    frac = max(min((h - s) / h, 1.0 - 1e-6), 1e-6)
    return float(statistics.NormalDist().inv_cdf(frac))


def _mean32(x: torch.Tensor) -> torch.Tensor:
    """Mean over the worker axis (-2) in float32: rows summed in order,
    times ``1/h`` (the reference upcasts bfloat16 rows to float32 for it)."""
    rows = x.unbind(-2)
    acc = rows[0].to(torch.float32, copy=True)
    for row in rows[1:]:
        acc += row
    return acc * (1.0 / x.shape[-2])


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the worker axis, rounded once to ``x``'s dtype (float8
    rows: :func:`_stats8`)."""
    if is_float8(x):
        return _stats8(x)[0]
    return to_dtype(_mean32(x), x.dtype)


def _stats8(x: torch.Tensor, std: bool = False):
    """``(mean, std or None)`` over the worker axis of float8 rows as the
    reference computes them there: in float8, each operation (an add of the
    next row to the partial sum, the division by ``h`` rounded to float8,
    the centring, the square, the root) rounded to float8."""
    h = _as_dtype(x.shape[-2], FLOAT8)

    def mean(rows):
        acc = 0.0  # XLA's sum starts at +0
        for row in rows:
            acc = to_float8(row.float() + acc).float()
        return to_float8(divide(acc, h))

    mu = mean(x.unbind(-2))
    if not std:
        return mu, None
    var = mean(to_float8(torch.square(to_float8(row.float() - mu.float())
                                      .float()))
               for row in x.unbind(-2))
    return mu, to_float8(torch.sqrt(var.double()))


def _row_std(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Population standard deviation over the worker axis around the float32
    mean ``mu``. Each step is one fused multiply-add ``acc = c*c + acc``
    rounded once to float32: the product of two float32 values is exact in
    float64. The square root is taken in float64 too, which rounds to the
    correctly rounded float32 root (PyTorch's vectorised float32 root on the
    CPU is not). For bfloat16 rows the reference rounds the float32
    variance to bfloat16, takes its float32 root and rounds that."""
    acc = torch.zeros_like(mu)
    for row in x.unbind(-2):
        c = (row - mu).double()
        acc = torch.addcmul(acc.double(), c, c).to(mu.dtype)
    var = divide(acc, x.shape[-2])
    if x.dtype != torch.float32:
        var = to_dtype(var, x.dtype)
    return to_dtype(torch.sqrt(var.double()).to(torch.float32), x.dtype)


def _row_stats(x: torch.Tensor):
    """``(mean, std)`` over the worker axis in ``x``'s dtype; the std is
    taken around the unrounded float32 mean."""
    if is_float8(x):
        return _stats8(x, std=True)
    mu = _mean32(x)
    return to_dtype(mu, x.dtype), _row_std(x, mu)


def _as_dtype(c: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``: the reference's weakly typed
    constants take the array's type (``z`` becomes a bfloat16 on bfloat16
    rows), where PyTorch would multiply by the float32 constant."""
    if is_float8(dtype):
        return float(to_dtype(torch.tensor(c), dtype).float())
    return float(torch.tensor(c, dtype=dtype))


def _rows(byz: torch.Tensor, f: int) -> torch.Tensor:
    """``[..., d]`` -> ``f`` copies ``[..., f, d]``."""
    return byz.unsqueeze(-2).expand(byz.shape[:-1] + (f, byz.shape[-1]))


def alie(honest: torch.Tensor, f: int, z: float | None = None
         ) -> torch.Tensor:
    """A Little Is Enough: send mean - z * std, coordinate-wise."""
    h = honest.shape[-2]
    if z is None:
        z = _alie_z(h + f, f)
    mu, sd = _row_stats(honest)
    zc = _as_dtype(z, mu.dtype)
    if mu.dtype == torch.float16:
        # XLA fuses mu - z * sd on float16 rows and keeps the product in
        # float32 there (bfloat16's it rounds): one rounding
        return _rows((mu.float() - zc * sd.float()).half(), f)
    t = lowp(lambda s: zc * s, sd, dtype=mu.dtype)
    return _rows(lowp(torch.sub, mu, t, dtype=mu.dtype), f)


def linear_attack(honest: torch.Tensor, f: int,
                  coeffs) -> torch.Tensor:
    """The (a, b)-parameterised mean/std family: ``byz = a*mu + b*sd``.
    ``coeffs`` is ``[2]`` (or ``[..., 2]``, one pair per lane)."""
    mu, sd = _row_stats(honest)
    if isinstance(coeffs, torch.Tensor) and coeffs.ndim > 1:
        byz = coeffs[..., 0:1] * mu + coeffs[..., 1:2] * sd
    else:
        byz = coeffs[0] * mu + coeffs[1] * sd
    return _rows(byz, f)


def linear_coeffs(cfg: "AttackConfig", n: int, f: int):
    """``(a, b)`` such that ``linear_attack`` reproduces ``cfg``, or ``None``
    when the attack is outside the mean/std family."""
    if cfg.name == "alie":
        z = cfg.z if cfg.z is not None else _alie_z(n, f)
        return (1.0, -z)
    if cfg.name == "signflip":
        return (-(cfg.scale or 1.0), 0.0)
    if cfg.name == "ipm":
        return (-(cfg.scale or 0.5), 0.0)
    if cfg.name == "foe":
        return (-(cfg.scale or 10.0), 0.0)
    if cfg.name == "zero":
        return (0.0, 0.0)
    return None


def sign_flip(honest: torch.Tensor, f: int, scale: float = 1.0
              ) -> torch.Tensor:
    """Send the negated honest mean (scaled)."""
    mu = _row_mean(honest)
    c = _as_dtype(-scale, mu.dtype)
    return _rows(lowp(lambda m: c * m, mu, dtype=mu.dtype), f)


def ipm(honest: torch.Tensor, f: int, eps: float = 0.5) -> torch.Tensor:
    """Inner-Product Manipulation: -eps * honest mean."""
    return sign_flip(honest, f, scale=eps)


def foe(honest: torch.Tensor, f: int, scale: float = 10.0) -> torch.Tensor:
    """Fall of Empires: large-magnitude negated mean."""
    return sign_flip(honest, f, scale=scale)


def mimic(honest: torch.Tensor, f: int, target: int = 0) -> torch.Tensor:
    """All Byzantine workers copy one honest worker (fixed target)."""
    return _rows(honest[..., target, :], f)


def gauss(honest: torch.Tensor, f: int, noise, std=1.0) -> torch.Tensor:
    """Random Gaussian noise around the honest mean (weak baseline):
    ``mu + std * noise``. ``noise`` is the ``[..., f, d]`` N(0, 1) draw, or a
    draws provider to take it from (its ``attack`` stream); ``std`` a float
    or a per-lane tensor shaped to broadcast."""
    mu = _row_mean(honest)
    if not isinstance(noise, torch.Tensor):
        noise = noise.normal(honest.shape[:-2] + (f, honest.shape[-1]),
                             stream="attack").to(honest.dtype)
    return mu.unsqueeze(-2) + std * noise


def zero(honest: torch.Tensor, f: int) -> torch.Tensor:
    return honest.new_zeros(honest.shape[:-2] + (f, honest.shape[-1]))


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Named attack.

    Attributes:
      name: ``none`` | ``alie`` | ``signflip`` | ``ipm`` | ``foe`` |
        ``mimic`` | ``gauss`` | ``zero`` | ``spectral`` | ``ipm_greedy`` |
        ``linear`` (coefficients arrive through :func:`apply_attack`'s
        ``params``) | ``bank`` (the attack bank of ``repro_torch.adversary``,
        its branch chosen per lane). The stateful adversaries (the tracked
        ``mimic``, ``spectral``, ``ipm_greedy``) run in
        ``repro_torch.adversary`` with their memory in
        ``ServerState.attack``; :func:`apply_attack` is the stateless
        dispatch (its ``mimic`` is the fixed-target variant).
      scale: magnitude parameter (signflip/foe/ipm/gauss/spectral/
        ipm_greedy).
      z: optional override of the ALIE z-score.
      bank: branch names when ``name='bank'`` (``None``: the full
        ``repro_torch.adversary.DEFAULT_ATTACK_BANK``).
    """

    name: str = "alie"
    scale: float | None = None
    z: float | None = None
    bank: tuple | None = None


#: Attacks whose Byzantine vectors are zero on every coordinate where all
#: honest rows are zero and that keep no state (the mean/std family). The
#: server round's ``mimic`` is the tracked one, whose memory is a ``[D]``
#: vector: it is not among them.
ZERO_PRESERVING = ("none", "linear", "alie", "signflip", "ipm", "foe",
                   "zero")


def apply_attack(cfg: AttackConfig, honest: torch.Tensor, f: int,
                 params=None, draws=None) -> torch.Tensor:
    """Produce the ``[f, d]`` Byzantine payload from honest ``[h, d]``
    (stateless attacks; ``gauss`` takes its noise from ``draws``)."""
    if f == 0 or cfg.name == "none":
        return honest.new_zeros((f,) + honest.shape[1:])
    if cfg.name == "linear":
        if params is None:
            raise ValueError("linear attack needs a coeffs vector")
        return linear_attack(honest, f, params)
    if cfg.name == "alie":
        return alie(honest, f, z=cfg.z)
    if cfg.name == "signflip":
        return sign_flip(honest, f, scale=cfg.scale or 1.0)
    if cfg.name == "ipm":
        return ipm(honest, f, eps=cfg.scale or 0.5)
    if cfg.name == "foe":
        return foe(honest, f, scale=cfg.scale or 10.0)
    if cfg.name == "mimic":
        return mimic(honest, f)
    if cfg.name == "gauss":
        if draws is None:
            raise ValueError("gauss attack needs a draws provider")
        return gauss(honest, f, draws, std=cfg.scale or 1.0)
    if cfg.name == "zero":
        return zero(honest, f)
    raise ValueError(
        f"unknown attack: {cfg.name!r} (apply_attack handles the stateless "
        "attacks none|linear|alie|signflip|ipm|foe|mimic|gauss|zero; "
        "stateful adversaries live in repro_torch.adversary)")
