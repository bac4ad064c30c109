"""Byzantine attack strategies (counterpart of ``repro.core.attacks``).

Every attack maps the stacked honest vectors ``honest: [h, d]`` to ``f``
Byzantine vectors ``[f, d]`` (colluding, omniscient attackers). Ported: the
stateless mean/std family (``alie``, ``signflip``, ``ipm``, ``foe``,
``zero`` and the coefficient form ``linear``) and the fixed-target
``mimic``; ``gauss`` and the stateful adversaries are still to be ported.

The worker-axis statistics reproduce the reference's rounding: the mean is a
sequential row sum times ``1/h`` and the population variance (no Bessel
correction, as ``jnp.std``) a sequential fused multiply-add of squares
divided by ``h``, the order XLA's fused reduction takes. Both run in
float32 on bfloat16 rows too, rounded where the reference rounds.

:data:`ZERO_PRESERVING` names the attacks that send zero wherever every
honest row is zero: under a global mask their Byzantine rows are zero off
the selected blocks, so the attack can run on the wire payload alone.
"""

from __future__ import annotations

import dataclasses
import math
import statistics

import torch


def _alie_z(n: int, f: int) -> float:
    """z-score threshold of ALIE: z = Phi^-1((n - f - s)/(n - f)) with
    s = floor(n/2 + 1) - f supporters needed to shift the median."""
    h = n - f
    s = math.floor(n / 2 + 1) - f
    frac = max(min((h - s) / h, 1.0 - 1e-6), 1e-6)
    return float(statistics.NormalDist().inv_cdf(frac))


def _mean32(x: torch.Tensor) -> torch.Tensor:
    """Mean over the worker axis in float32: rows summed in order, times
    ``1/h`` (the reference upcasts bfloat16 rows to float32 for it)."""
    acc = x[0].to(torch.float32, copy=True)
    for row in x[1:]:
        acc += row
    return acc * (1.0 / x.shape[0])


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the worker axis, rounded once to ``x``'s dtype."""
    return _mean32(x).to(x.dtype)


def _row_std(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Population standard deviation over the worker axis around the float32
    mean ``mu``. Each step is one fused multiply-add ``acc = c*c + acc``
    rounded once to float32: the product of two float32 values is exact in
    float64. The square root is taken in float64 too, which rounds to the
    correctly rounded float32 root (PyTorch's vectorised float32 root on the
    CPU is not). For bfloat16 rows the reference rounds the float32
    variance to bfloat16, takes its float32 root and rounds that."""
    acc = torch.zeros_like(mu)
    for row in x:
        c = (row - mu).double()
        acc = torch.addcmul(acc.double(), c, c).to(mu.dtype)
    var = acc / x.shape[0]
    if x.dtype != torch.float32:
        var = var.to(x.dtype)
    return torch.sqrt(var.double()).to(torch.float32).to(x.dtype)


def _row_stats(x: torch.Tensor):
    """``(mean, std)`` over the worker axis in ``x``'s dtype; the std is
    taken around the unrounded float32 mean."""
    mu = _mean32(x)
    return mu.to(x.dtype), _row_std(x, mu)


def _as_dtype(c: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``: the reference's weakly typed
    constants take the array's type (``z`` becomes a bfloat16 on bfloat16
    rows), where PyTorch would multiply by the float32 constant."""
    return float(torch.tensor(c, dtype=dtype))


def alie(honest: torch.Tensor, f: int, z: float | None = None
         ) -> torch.Tensor:
    """A Little Is Enough: send mean - z * std, coordinate-wise."""
    h = honest.shape[0]
    if z is None:
        z = _alie_z(h + f, f)
    mu, sd = _row_stats(honest)
    byz = mu - _as_dtype(z, mu.dtype) * sd
    return byz.expand((f,) + byz.shape)


def linear_attack(honest: torch.Tensor, f: int,
                  coeffs) -> torch.Tensor:
    """The (a, b)-parameterised mean/std family: ``byz = a*mu + b*sd``."""
    mu, sd = _row_stats(honest)
    byz = coeffs[0] * mu + coeffs[1] * sd
    return byz.expand((f,) + byz.shape)


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
    byz = _as_dtype(-scale, mu.dtype) * mu
    return byz.expand((f,) + byz.shape)


def ipm(honest: torch.Tensor, f: int, eps: float = 0.5) -> torch.Tensor:
    """Inner-Product Manipulation: -eps * honest mean."""
    return sign_flip(honest, f, scale=eps)


def foe(honest: torch.Tensor, f: int, scale: float = 10.0) -> torch.Tensor:
    """Fall of Empires: large-magnitude negated mean."""
    return sign_flip(honest, f, scale=scale)


def mimic(honest: torch.Tensor, f: int, target: int = 0) -> torch.Tensor:
    """All Byzantine workers copy one honest worker (fixed target)."""
    byz = honest[target]
    return byz.expand((f,) + byz.shape)


def zero(honest: torch.Tensor, f: int) -> torch.Tensor:
    return honest.new_zeros((f,) + honest.shape[1:])


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    """Named attack.

    Attributes:
      name: ``none`` | ``alie`` | ``signflip`` | ``ipm`` | ``foe`` |
        ``mimic`` | ``zero`` | ``linear`` (coefficients arrive through
        :func:`apply_attack`'s ``params``).
      scale: magnitude parameter (signflip/foe/ipm).
      z: optional override of the ALIE z-score.
    """

    name: str = "alie"
    scale: float | None = None
    z: float | None = None


#: Ported attacks whose Byzantine vectors are zero on every coordinate where
#: all honest rows are zero (the mean/std family and mimic; all stateless).
ZERO_PRESERVING = ("none", "linear", "alie", "signflip", "ipm", "foe",
                   "mimic", "zero")


def apply_attack(cfg: AttackConfig, honest: torch.Tensor, f: int,
                 params=None) -> torch.Tensor:
    """Produce the ``[f, d]`` Byzantine payload from honest ``[h, d]``."""
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
    if cfg.name == "zero":
        return zero(honest, f)
    raise ValueError(
        f"attack {cfg.name!r} is not ported (ported: none|linear|alie|"
        "signflip|ipm|foe|mimic|zero)")
