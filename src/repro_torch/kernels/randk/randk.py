"""CUDA kernel wrappers: Block-RandK compress, decompress and the fused
RoSDHB momentum update.

Replace ``repro/kernels/randk/randk.py:_compress_kernel`` (launched by
``block_compress``), ``:_decompress_kernel`` (``block_decompress``) and
``:_momentum_kernel`` (``momentum_scatter``). The kernels, ``csrc/randk.cu``,
are bound by device memory: a thread block moves one or more blocks of one
worker row as 16-byte vectors, one per thread. The reference works on one
row at a time; here one launch covers the ``[n, d]`` bank, with one id
vector shared by all rows (a global mask) or one per row (local masks).
Banks and payloads are float32, bfloat16, float16 or float8_e4m3fn: the
kernels compute in float32 and round once on store, float8 as the
reference rounds it (NaN past the largest finite value,
``utils.dtypes.to_float8``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

#: The kernels' dtype codes (``csrc/randk.cu``).
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
          torch.float8_e4m3fn: 3}


def _check_bank(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{what} takes float32, bfloat16, float16 or "
                        f"float8_e4m3fn, got {x.dtype}")
    if x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous [n, d] bank, got "
                         f"{tuple(x.shape)}")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"{what} takes 1 <= n <= 65535 rows, got "
                         f"{x.shape[0]}")


def _check_block(block_size: int, dtype: torch.dtype) -> None:
    nbytes = block_size * dtype.itemsize
    if block_size < 1 or nbytes % 16 or nbytes // 16 > 1024:
        raise ValueError(
            f"block_size {block_size} must span a multiple of 16 bytes and "
            f"at most 1024 16-byte vectors for {dtype}")


def _ids(ids: torch.Tensor, n: int, device) -> tuple:
    """Block ids as contiguous int32 on the card, with their row stride."""
    if ids.ndim not in (1, 2) or (ids.ndim == 2 and ids.shape[0] != n):
        raise ValueError(f"block ids must be [kb] or [{n}, kb], got "
                         f"{tuple(ids.shape)}")
    ids = ids.to(device=device, dtype=torch.int32).contiguous()
    return ids, (0 if ids.ndim == 1 else ids.shape[1])


def block_compress_cuda(g: torch.Tensor, ids: torch.Tensor, block_size: int,
                        alpha: float, out=None) -> torch.Tensor:
    """g ``[n, d]``, ids ``[kb]`` or ``[n, kb]`` (distinct, in
    ``[0, d/block_size)``) -> payload ``[n, kb * block_size]``, into
    ``out`` where given: a contiguous, 16-byte aligned ``[n, kb *
    block_size]`` tensor of g's dtype on g's card (a worker's rows of a
    round's payload, compressed as soon as the worker's gradient exists).
    The kernel's offsets are 64-bit: one row may span more than 2^32
    bytes (dbrx_132b's 4,492,216,320 float8 values)."""
    _check_bank(g, "block_compress")
    _check_block(block_size, g.dtype)
    n, d = g.shape
    if d % block_size:
        raise ValueError(f"d={d} is not a multiple of block_size={block_size}")
    ids, stride = _ids(ids, n, g.device)
    kb = ids.shape[-1]
    if out is None:
        payload = torch.empty((n, kb * block_size), dtype=g.dtype,
                              device=g.device)
    elif (out.dtype != g.dtype or out.device != g.device
          or tuple(out.shape) != (n, kb * block_size)
          or not out.is_contiguous() or out.data_ptr() % 16):
        raise ValueError(f"out must be a contiguous, 16-byte aligned {g.dtype}"
                         f" [{n}, {kb * block_size}] on {g.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    else:
        payload = out
    lib = build.load("randk")
    err = lib.block_compress(g.data_ptr(), ids.data_ptr(), payload.data_ptr(),
                             n, d, kb, block_size, stride, float(alpha),
                             DTYPES[g.dtype],
                             build.stream_ptr(g.get_device()))
    build.check(err, "block_compress")
    block_compress_cuda.launches += 1
    return payload


def slot_map(ids: torch.Tensor, nb: int) -> torch.Tensor:
    """Destination block -> payload row (``-1``: not selected), ``[nb]`` for
    ``[kb]`` ids or ``[n, nb]`` for ``[n, kb]`` ids, int32 on ids' device.
    One scatter on the device, no loop over blocks."""
    kb = ids.shape[-1]
    slots = torch.full(ids.shape[:-1] + (nb,), -1, dtype=torch.int32,
                       device=ids.device)
    src = torch.arange(kb, dtype=torch.int32, device=ids.device)
    return slots.scatter_(-1, ids.long(), src.expand(ids.shape))


def block_decompress_cuda(payload: torch.Tensor, ids: torch.Tensor,
                          block_size: int, d: int) -> torch.Tensor:
    """payload ``[n, kb * block_size]``, the ids it was compressed with ->
    dense ``[n, d]``, every destination block written once."""
    _check_bank(payload, "block_decompress")
    _check_block(block_size, payload.dtype)
    n = payload.shape[0]
    if d % block_size or payload.shape[1] % block_size:
        raise ValueError(f"d={d} and the payload width {payload.shape[1]} "
                         f"must be multiples of block_size={block_size}")
    nb, kb = d // block_size, payload.shape[1] // block_size
    ids, _ = _ids(ids, n, payload.device)
    if ids.shape[-1] != kb:
        raise ValueError(f"{ids.shape[-1]} block ids for a payload of {kb} "
                         f"blocks")
    slots = slot_map(ids, nb)
    stride = 0 if slots.ndim == 1 else nb
    dense = torch.empty((n, d), dtype=payload.dtype, device=payload.device)
    lib = build.load("randk")
    err = lib.block_decompress(payload.data_ptr(), slots.data_ptr(),
                               dense.data_ptr(), n, nb, kb, block_size, stride,
                               DTYPES[payload.dtype],
                               build.stream_ptr(payload.get_device()))
    build.check(err, "block_decompress")
    block_decompress_cuda.launches += 1
    return dense


def momentum_scatter_cuda(m: torch.Tensor, payload: torch.Tensor,
                          ids: torch.Tensor, block_size: int, beta: float,
                          *, window=None, slots=None,
                          out=None) -> torch.Tensor:
    """RoSDHB step 5 in place on the momentum bank ``m [n, d]`` (any of
    :data:`DTYPES`): every value decays by ``beta``, and the selected blocks
    add ``(1 - beta) * payload`` (``payload [n, kb * block_size]``, any of
    :data:`DTYPES`, the wire the ``ids`` compressed). Computed in float32,
    rounded once to ``m``'s dtype. Returns ``m``, or ``out`` where given.

    ``window`` ``(b0, b1)`` limits the launch to destination blocks ``b0``
    to ``b1 - 1`` (default the whole bank); the rest of ``m`` is left as it
    is. ``slots``: the round's :func:`slot_map` of ``ids``, built here when
    not given (a round that runs window after window builds it once).
    ``out`` (a bank narrower than float32 only): a float32 ``[n, (b1 - b0)
    * block_size]`` tensor of unit column stride (any row stride that is a
    multiple of 4) that receives the unrounded result."""
    _check_bank(m, "momentum_scatter")
    _check_bank(payload, "momentum_scatter payload")
    n, d = m.shape
    if block_size < 4 or block_size % 4 or block_size // 4 > 1024:
        raise ValueError(f"block_size {block_size} must be a multiple of 4 "
                         f"and at most 4096")
    if payload.shape[0] != n or payload.device != m.device:
        raise ValueError(f"payload {tuple(payload.shape)} on "
                         f"{payload.device} for a bank {tuple(m.shape)} on "
                         f"{m.device}")
    if d % block_size or payload.shape[1] % block_size:
        raise ValueError(f"d={d} and the payload width {payload.shape[1]} "
                         f"must be multiples of block_size={block_size}")
    if out is not None and m.dtype == torch.float32:
        raise ValueError("out is for a bank narrower than float32 (a "
                         "float32 bank holds the float32 result itself)")
    for t in (m, payload):
        if t.data_ptr() % 16:
            raise ValueError("momentum_scatter needs 16-byte aligned banks")
    nb, kb = d // block_size, payload.shape[1] // block_size
    b0, b1 = (0, nb) if window is None else (int(window[0]), int(window[1]))
    if not 0 <= b0 < b1 <= nb:
        raise ValueError(f"window [{b0}, {b1}) is not inside the bank's "
                         f"{nb} blocks")
    ids, _ = _ids(ids, n, m.device)
    if ids.shape[-1] != kb:
        raise ValueError(f"{ids.shape[-1]} block ids for a payload of {kb} "
                         f"blocks")
    if slots is None:
        slots = slot_map(ids, nb)
    elif (slots.dtype != torch.int32 or slots.device != m.device
          or slots.shape[-1] != nb or not slots.is_contiguous()
          or slots.ndim != ids.ndim):
        raise ValueError(f"slots must be the contiguous int32 slot map of "
                         f"the ids on {m.device}, [{nb}] or [{n}, {nb}]")
    stride = 0 if slots.ndim == 1 else nb
    width = (b1 - b0) * block_size
    if out is not None and (
            out.dtype != torch.float32 or out.device != m.device
            or tuple(out.shape) != (n, width) or out.stride(1) != 1
            or out.stride(0) % 4 or out.data_ptr() % 16):
        raise ValueError(f"out must be a 16-byte aligned float32 [{n}, "
                         f"{width}] of unit column stride and a row stride "
                         f"that is a multiple of 4 on {m.device}, got "
                         f"{out.dtype} {tuple(out.shape)} strides "
                         f"{out.stride()} on {out.device}")
    lib = build.load("randk")
    err = lib.momentum_scatter(
        m.data_ptr(), payload.data_ptr(), slots.data_ptr(),
        out.data_ptr() if out is not None else None, n, nb, b0, b1, kb,
        block_size, stride, out.stride(0) if out is not None else 0,
        float(beta), float(1.0 - beta), DTYPES[m.dtype],
        DTYPES[payload.dtype], build.stream_ptr(m.get_device()))
    build.check(err, "momentum_scatter")
    momentum_scatter_cuda.launches += 1
    return m if out is None else out


block_compress_cuda.launches = 0
block_decompress_cuda.launches = 0
momentum_scatter_cuda.launches = 0
