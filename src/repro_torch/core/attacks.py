"""Byzantine attack strategies (counterpart of ``repro.core.attacks``).

Every attack maps the stacked honest vectors ``honest: [h, d]`` to ``f``
Byzantine vectors ``[f, d]`` (colluding, omniscient attackers). Ported: the
stateless mean/std family (``alie``, ``signflip``, ``ipm``, ``foe``,
``zero`` and the coefficient form ``linear``) and the fixed-target
``mimic``; ``gauss`` and the stateful adversaries are still to be ported.

The worker-axis statistics reproduce the reference's rounding: the mean is a
sequential row sum times ``1/h`` and the population variance (no Bessel
correction, as ``jnp.std``) a sequential fused multiply-add of squares
divided by ``h``, the order XLA's fused reduction takes.
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


def _row_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the worker axis: rows summed in order, times ``1/h``."""
    acc = x[0].clone()
    for row in x[1:]:
        acc += row
    return acc * (1.0 / x.shape[0])


def _row_std(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Population standard deviation over the worker axis. Each step is one
    fused multiply-add ``acc = c*c + acc`` rounded once to float32: the
    product of two float32 values is exact in float64. The square root is
    taken in float64 too, which rounds to the correctly rounded float32
    root (PyTorch's vectorised float32 root on the CPU is not)."""
    acc = torch.zeros_like(mu)
    for row in x:
        c = (row - mu).double()
        acc = torch.addcmul(acc.double(), c, c).to(mu.dtype)
    return torch.sqrt((acc / x.shape[0]).double()).to(mu.dtype)


def alie(honest: torch.Tensor, f: int, z: float | None = None
         ) -> torch.Tensor:
    """A Little Is Enough: send mean - z * std, coordinate-wise."""
    h = honest.shape[0]
    if z is None:
        z = _alie_z(h + f, f)
    mu = _row_mean(honest)
    byz = mu - z * _row_std(honest, mu)
    return byz.expand((f,) + byz.shape)


def linear_attack(honest: torch.Tensor, f: int,
                  coeffs) -> torch.Tensor:
    """The (a, b)-parameterised mean/std family: ``byz = a*mu + b*sd``."""
    mu = _row_mean(honest)
    sd = _row_std(honest, mu)
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
    byz = -scale * _row_mean(honest)
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
