"""Casts to the low-precision bank dtypes as the reference rounds them.

PyTorch and JAX round to float16, bfloat16 and ``float8_e4m3fn`` to nearest
even alike, and agree on float16's and bfloat16's overflow (to inf). On
float8_e4m3fn, which has no inf, JAX (ml_dtypes, and XLA's convert) gives
NaN for every value whose rounding is past the largest finite one (|x| >
464: 464 itself is the midpoint to the next step and rounds to even, 448),
for +-inf and for NaN, the sign kept; PyTorch's cast on the CPU saturates
to +-448 instead (on an H100 it gives NaN, PyTorch 2.11). :func:`to_dtype`
is the reference's cast on any device: every store into a float8 bank goes
through it.

PyTorch has no float8 arithmetic either, so an elementwise operation on
float8 values runs in float32 and rounds its result with :func:`to_dtype`
(:func:`lowp`), as XLA computes each float8 operation wider and rounds it
back.
"""

from __future__ import annotations

import torch

FLOAT8 = torch.float8_e4m3fn

#: The largest magnitude that rounds to a finite float8_e4m3fn (to 448).
FLOAT8_LIMIT = 464.0


def to_float8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to nearest even float8_e4m3fn, NaN (with ``x``'s sign)
    past :data:`FLOAT8_LIMIT`, for +-inf and for NaN. float64 is rounded to
    float32 first."""
    xf = x if x.dtype in (torch.float32, torch.float16, torch.bfloat16) \
        else x.float()
    bits = xf.to(FLOAT8).view(torch.uint8)
    # saturated +-448 is 0x7E / 0xFE; setting the low bit makes it the NaN
    # of the same sign (0x7F / 0xFF)
    over = ~(xf.abs() <= FLOAT8_LIMIT)
    return torch.where(over, bits | 0x7F, bits).view(FLOAT8)


def to_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.to(dtype)``, rounding to float8_e4m3fn as the reference does."""
    if dtype == FLOAT8 and x.dtype != FLOAT8:
        return to_float8(x)
    return x.to(dtype)


def is_float8(x) -> bool:
    """Whether ``x`` (a tensor or a dtype) is float8_e4m3fn."""
    return (x.dtype if isinstance(x, torch.Tensor) else x) == FLOAT8


def lowp(fn, *args: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``fn`` of ``args`` in ``dtype``: on float8 computed in float32 (every
    argument widened) and rounded once with :func:`to_dtype`; PyTorch's own
    arithmetic otherwise."""
    if dtype != FLOAT8:
        return fn(*args)
    return to_float8(fn(*(a.float() if isinstance(a, torch.Tensor) else a
                          for a in args)))
