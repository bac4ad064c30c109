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
back; a float8 sum adds in XLA's tree order, rounding each add
(:func:`xla_sum_f8`).
"""

from __future__ import annotations

import torch

FLOAT8 = torch.float8_e4m3fn

#: The largest magnitude that rounds to a finite float8_e4m3fn (to 448).
FLOAT8_LIMIT = 464.0


#: Values :func:`to_float8` rounds at a time: its float32 and boolean
#: transients over a whole [8, D] bank at D ~ 4e8 would not fit beside it.
FLOAT8_CHUNK = 1 << 26


def to_float8(x: torch.Tensor, out=None) -> torch.Tensor:
    """``x`` rounded to nearest even float8_e4m3fn, NaN (with ``x``'s sign)
    past :data:`FLOAT8_LIMIT`, for +-inf and for NaN. float64 is rounded to
    float32 first. A contiguous tensor of more than :data:`FLOAT8_CHUNK`
    values is rounded that many at a time. ``out``: a contiguous float8
    tensor of ``x``'s size (a slice of a bank row) that takes the result
    chunk by chunk, with no float8 copy of the whole of ``x`` beside it."""
    if out is not None:
        src, dst = x.reshape(-1), out.view(-1)
        for i in range(0, src.numel(), FLOAT8_CHUNK):
            dst[i:i + FLOAT8_CHUNK] = to_float8(src[i:i + FLOAT8_CHUNK])
        return out
    if x.numel() > FLOAT8_CHUNK and x.is_contiguous():
        flat = x.reshape(-1)
        out = torch.empty(flat.shape, dtype=FLOAT8, device=x.device)
        for i in range(0, flat.numel(), FLOAT8_CHUNK):
            out[i:i + FLOAT8_CHUNK] = to_float8(flat[i:i + FLOAT8_CHUNK])
        return out.view(x.shape)
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


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` correctly rounded on every device: the constant goes in
    as a tensor on ``x``'s device, since PyTorch's CUDA kernels multiply by
    the reciprocal of a host scalar divisor (one step off now and then)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


#: The window of XLA's tree reduction on the CPU (:func:`xla_sum_f8`).
XLA_WINDOW = 32


def xla_sum_f8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum of float8 values over ``dim`` as the reference's compiled
    ``jnp.sum`` gives it on the CPU, as float32 values that are float8:
    every add rounded to float8, in XLA's tree order. An axis of at most
    :data:`XLA_WINDOW` adds in order onto 0; a longer one is padded with
    zeros (half the padding in front, the odd one behind) to windows of
    32, each summed so, and the window sums are summed the same way."""
    x = x.float().movedim(dim, -1)
    while True:
        n = x.shape[-1]
        if n > XLA_WINDOW:
            w = -(-n // XLA_WINDOW)
            pad = w * XLA_WINDOW - n
            x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
            x = x.reshape(x.shape[:-1] + (w, XLA_WINDOW))
        acc = x.new_zeros(x.shape[:-1])
        for i in range(x.shape[-1]):
            acc = to_float8(acc + x[..., i]).float()
        if n <= XLA_WINDOW:
            return acc
        x = acc


def vector_norm(x: torch.Tensor) -> torch.Tensor:
    """``|x|``; of a float8 vector as the reference's compiled
    ``jnp.linalg.norm`` gives it on the CPU: the squares, each add of their
    sum (:func:`xla_sum_f8`) and the square root rounded to float8."""
    if x.dtype != FLOAT8:
        return torch.linalg.vector_norm(x)
    sq = xla_sum_f8(lowp(torch.square, x.reshape(-1), dtype=FLOAT8))
    return to_float8(torch.sqrt(sq))
