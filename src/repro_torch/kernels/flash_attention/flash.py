"""CUDA kernel wrappers: flash attention, forward and backward.

Replaces ``repro/kernels/flash_attention/flash.py:_flash_kernel`` (launched
by ``flash_attention``). The TPU kernel is forward-only, and ``jax.grad``
through it fails; the port trains through its kernel, so
``csrc/flash_attention.cu`` adds the FlashAttention-2 backward (a ``delta``
pass, then dk/dv per 128 keys (64 at head dim 256) and dq per 128 query
rows, no atomics). Bound by operations at the model's shapes: Hopper
kernels (``sm_90a``) with TMA loads into a 2-stage mbarrier ring,
``wgmma`` products with the accumulators in registers, one producer and
two consumer warpgroups per block. Those take bfloat16; float32 inputs,
which the TPU kernel takes too (it computes in float32 whatever its
inputs), go to ``csrc/flash_attention_f32.cu``: the same forward and
backward with every product an FFMA on the CUDA cores (tf32 ``wgmma``
would round the inputs to a 10-bit mantissa), counted under their own
wrappers, :func:`flash_fwd_f32_cuda` and :func:`flash_bwd_f32_cuda`.
Both libraries are built for head dims 64, 80, 112, 128 and 256
(:data:`HEAD_DIMS`), and at both dtypes the dk/dv blocks split their loop
over query heads and tiles across blocks where the grid would not fill the
card (:func:`dkdv_plan`, with each library's tiles), and at head dim 256
dq reads the dS^T that dk/dv writes (:func:`bwd_scratch`).

:class:`FlashAttention` is a ``torch.autograd.Function`` whose backward is
a second Function, :class:`FlashBackward`: the forward saves the per-row
log-sum-exp ``[B, H, Sq]`` in float32 for the backward. Both carry a
``setup_context`` and a ``vmap`` rule, so they run under ``torch.func``
(``grad`` and ``vmap``, nested to any depth: the simulator takes
per-worker gradients under ``vmap`` over workers and over lanes). The vmap
rule folds the mapped axis into the batch axis ``B`` and calls the
Function again, so however many levels map it, one kernel launches over
``[lanes x workers x B, S, H, D]``. On CPU tensors both Functions run the
plain versions (``ref.attention_fwd_ref``, ``ref.attention_bwd_ref``).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)

#: The head dims both libraries are built for (112, zamba2's, unpadded).
HEAD_DIMS = (64, 80, 112, 128, 256)
#: The float32 kernels' head dims: the bfloat16 ones'.
F32_HEAD_DIMS = HEAD_DIMS
#: The input dtypes the kernels take: bfloat16 (``csrc/flash_attention.cu``,
#: on the tensor cores) and float32 (``csrc/flash_attention_f32.cu``, on the
#: CUDA cores).
DTYPES = (torch.bfloat16, torch.float32)
#: Head dims up to this one that the kernel is not built for are taken
#: zero-padded to the next multiple of 128 (``ops.flash_attention``), as the
#: reference's ``ops.attention`` pads to whole 128-lane tiles.
PAD_MAX = 256


def head_dims(dtype: Optional[torch.dtype] = None) -> tuple:
    """The head dims the kernels of ``dtype`` are built for: both
    libraries', :data:`HEAD_DIMS`."""
    return HEAD_DIMS


def padded_dim(d: int, dtype: Optional[torch.dtype] = None) -> int:
    """The head dim the kernel of ``dtype`` (bfloat16's where None) runs for
    a model's head dim ``d``: ``d`` itself where it is built for it or past
    :data:`PAD_MAX`, else the next multiple of 128 (192 -> 256)."""
    return d if d in head_dims(dtype) or d > PAD_MAX else -(-d // 128) * 128


#: The bfloat16 dk/dv kernel's tiles by head dim: (keys a block, query rows
#: a streamed tile), ``Tiles<D>::kDkdvKeys`` and ``kBwdTile`` in
#: ``csrc/flash_attention.cu``.
DKDV_TILES = {64: (128, 64), 80: (128, 64), 112: (128, 64),
              128: (128, 64), 256: (64, 64)}
#: The float32 dk/dv kernel's tiles by head dim (``DkdvTile<D>`` in
#: ``csrc/flash_attention_f32.cu``: 16 RM keys a block, 16 KW query rows a
#: streamed tile).
F32_DKDV_TILES = {64: (128, 64), 80: (128, 64), 112: (128, 48),
                  128: (64, 64), 256: (64, 16)}


#: Waves of the card's SMs under which the dk/dv grid splits, by dtype. At
#: bfloat16 a grid of one wave or more keeps its blocks whole: on an H100
#: the vlm's 256 blocks split 3 ways ran 7.7% slower (the float32 partial
#: sums' traffic outweighed the better balance), while the 64 blocks of
#: gemma_2b and qwen25_3b split 9 ways ran 2.3-3.1x faster. The float32
#: kernels' blocks take longer, and split under two waves.
SPLIT_WAVES = {torch.bfloat16: 1, torch.float32: 2}


#: Head dims where the dk/dv kernels of both dtypes write dS^T to scratch
#: and dq reads it (``kDsPath`` in each .cu: at 256 dq would recompute S and
#: dP in narrow tiles), and the rows of a dq block there, to which each
#: dS^T row is padded (``kDqDsRows`` in the bfloat16 .cu, ``DqDsTile`` in
#: the float32 one).
DS_DIMS = (256,)
DQ_DS_ROWS = 128


def bwd_scratch(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                nsplit: int, dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of scratch the backward of ``dtype`` (bfloat16's where None)
    takes: the dk/dv split's float32 partial sums ``[2, nsplit, B, Sk, KV,
    D]`` where ``nsplit > 1``, then at a head dim of :data:`DS_DIMS` dS^T
    ``[B, H, Sk, Sq]`` in ``dtype`` with its rows padded to whole dq
    blocks; 0 where it needs none."""
    n = 4 * 2 * nsplit * b * sk * kv * d if nsplit > 1 else 0
    if d in DS_DIMS:
        item = 4 if dtype == torch.float32 else 2
        n += item * b * h * sk * (-(-sq // DQ_DS_ROWS) * DQ_DS_ROWS)
    return n


def _query_tiles(j0: int, keys: int, tile: int, sq: int, sk: int,
                 causal: bool, window: Optional[int], q_offset: int) -> int:
    """Query tiles of ``tile`` rows that some row seeing a key of ``[j0, j0
    + keys)`` falls in: the kernel's ``query_range``, begin aligned down to
    ``tile``."""
    jlast = min(j0 + keys, sk) - 1
    begin, end = 0, sq
    if causal:
        begin = max(0, j0 - q_offset)
    if window:
        end = min(end, jlast + window - q_offset)
    begin = begin // tile * tile
    return -(-(end - begin) // tile) if end > begin else 0


@functools.lru_cache(maxsize=256)
def dkdv_plan(b: int, sq: int, sk: int, h: int, kv: int, d: int,
              causal: bool, window: Optional[int], q_offset: int,
              sms: int, dtype: Optional[torch.dtype] = None) -> dict:
    """The dk/dv kernel's launch plan for inputs of ``dtype`` (its tiles,
    :data:`DKDV_TILES` or :data:`F32_DKDV_TILES`; bfloat16's where None) on
    a card of ``sms`` SMs.

    A block owns one key block of one kv head of one batch entry, and a run
    of its units: the (query head, query tile) pairs some row of which sees
    a key of the block, head-major (``rep`` heads of ``tiles[kb]`` tiles
    each). Where ``kv * b * key blocks`` is under :data:`SPLIT_WAVES` waves
    of ``sms`` the grid would leave SMs idle, so each key block's units are
    split into
    ``nsplit`` runs, ``ceil(4 sms / blocks)`` but no more than the heaviest
    block's units (nor than 65,535 grid rows): split ``s`` takes units
    ``[units * s // nsplit, units * (s + 1) // nsplit)``. Each run's dK and
    dV go unscaled to float32 scratch ``[2, nsplit, B, Sk, KV, D]``, and the
    sum pass (``flash_bwd_dkdv_sum_kernel``, ``flash_bwd_ffma_dkdv_sum_
    kernel``) adds them in split order: ``dk = sum_s fma(part_k[s], scale,
    .)``, ``dv = sum_s part_v[s]``, ``s = 0, 1, ...``, rounded to bfloat16
    last at bfloat16. The grid runs key block 0 first (the heaviest under a
    causal mask).

    Returns ``{"nsplit", "keys", "rows", "tiles": [tiles a key block],
    "runs": {(kb, s): (u0, u1)}}``: a pure function of the shape, ``sms``
    and ``dtype``, kept for the shapes of the last calls (every backward
    launch asks for it; the caller must not change it)."""
    keys, rows = (F32_DKDV_TILES if dtype == torch.float32 else
                  DKDV_TILES)[d]
    nkb = -(-sk // keys)
    tiles = [_query_tiles(kb * keys, keys, rows, sq, sk, causal, window,
                          q_offset) for kb in range(nkb)]
    rep = h // kv
    heaviest = rep * max(tiles)
    blocks = kv * b * nkb
    nsplit = 1
    if blocks < SPLIT_WAVES.get(dtype, 1) * sms:
        nsplit = max(1, min(-(-4 * sms // blocks), heaviest, 65535 // nkb))
    runs = {(kb, s): (rep * tiles[kb] * s // nsplit,
                      rep * tiles[kb] * (s + 1) // nsplit)
            for kb in range(nkb) for s in range(nsplit)}
    return {"nsplit": nsplit, "keys": keys, "rows": rows, "tiles": tiles,
            "runs": runs}


def fully_masked_rows(sq: int, sk: int, causal: bool, window: Optional[int],
                      q_offset: int) -> bool:
    """True when some query row sees no key. The dense reference averages v
    there; the kernel refuses such calls (a model's self-attention always
    sees its own position)."""
    if sk < 1:
        return True
    if causal and q_offset < 0:
        return True
    return window is not None and q_offset + sq - 1 > sk + window - 2


def refusal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, window: Optional[int] = None,
            q_offset: int = 0, pad: bool = False
            ) -> Optional[Tuple[type, str]]:
    """Why the kernels cannot take these inputs, as ``(exception type,
    message)``, or ``None`` when they can: bfloat16 or float32 (all three
    of one dtype) ``[B, S, heads, D]`` contiguous tensors, D in
    :data:`HEAD_DIMS` (float32: :data:`F32_HEAD_DIMS`; with ``pad``, also a D
    up to :data:`PAD_MAX`, which ``ops.flash_attention`` zero-pads to the
    next multiple of 128), GQA heads, no query row without a visible key,
    on a CUDA device (checked last, so the other reasons read the same on
    the CPU). It reads only what a tensor under ``torch.func.vmap`` still
    has (shape, dtype, layout, device), so it answers for a batched tensor
    as for the real one; the 16-byte alignment the loads need (TMA,
    ``cp.async``) is checked at the launch (:func:`_check`)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            return TypeError, (f"flash attention kernels take bfloat16 or "
                               f"float32, got {name} {t.dtype}")
        if t.dtype != q.dtype:
            return TypeError, (f"flash attention kernels take q, k and v of "
                               f"one dtype, got q {q.dtype} and {name} "
                               f"{t.dtype}")
        if t.ndim != 4 or not t.is_contiguous():
            return ValueError, (f"flash attention kernel takes contiguous "
                                f"[B, S, heads, D], got {name} "
                                f"{tuple(t.shape)}")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        return ValueError, (f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                            f"not fit q {tuple(q.shape)}")
    dims = head_dims(q.dtype)
    if (padded_dim(d, q.dtype) if pad else d) not in dims:
        return ValueError, (f"flash attention kernel is built for head dims "
                            f"{dims}" + (f" and takes those up to "
                                         f"{PAD_MAX} zero-padded"
                                         if pad else "") + f", got {d}")
    if h % kv or b > 65535 or h > 65535:
        return ValueError, (f"H={h} must be a multiple of KV={kv}; B, H <= "
                            f"65535")
    if window is not None and window < 1:
        return ValueError, f"window must be positive, got {window}"
    if fully_masked_rows(sq, sk, causal, window, q_offset):
        return ValueError, (
            f"query rows with no visible key (Sq={sq}, Sk={sk}, causal="
            f"{causal}, window={window}, q_offset={q_offset}): the kernel "
            f"does not take them")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            return ValueError, (f"flash attention kernel needs CUDA tensors, "
                                f"got {name} on {t.device}")
    return None


def supports(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool = True, window: Optional[int] = None,
             q_offset: int = 0) -> bool:
    """Whether the kernel takes these inputs (:func:`refusal` is None): the
    model's attention asks before it calls, and takes the plain attention
    where the kernel cannot run."""
    return refusal(q, k, v, causal, window, q_offset) is None


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int], q_offset: int) -> None:
    """What the launch needs: :func:`refusal`, then the 16-byte alignment
    of the real tensors (TMA loads, float32: 16-byte ``cp.async``)."""
    why = refusal(q, k, v, causal, window, q_offset)
    if why is not None:
        raise why[0](why[1])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention kernels load 16 bytes at a "
                             f"time and need 16-byte aligned tensors, got "
                             f"{name}")


def _problem(q, k, causal, window, q_offset) -> tuple:
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    return (b, sq, sk, h, kv, d, int(causal),
            0 if window is None else int(window), int(q_offset))


def _scale_arg(scale: Optional[float]) -> float:
    """The kernels' scale argument: 0 asks for ``1/sqrt(D)``."""
    return 0.0 if scale is None else float(scale)


def _fwd(lib: str, fn: str, q, k, v, causal, window, q_offset, scale):
    b, sq, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = build.entry(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_problem(q, k, causal, window, q_offset),
        _scale_arg(scale), build.stream_ptr(q.get_device()))
    build.check(err, fn)
    return o, lse


def _bwd(lib: str, fn: str, q, k, v, o, lse, dout, causal, window,
         q_offset, scale):
    dout = dout.contiguous()
    for name, t, dt in (("o", o, q.dtype), ("dout", dout, q.dtype),
                        ("lse", lse, torch.float32)):
        if t.device != q.device or t.dtype != dt or not t.is_contiguous() \
                or t.data_ptr() % 16:
            raise ValueError(f"flash backward: {name} must be a contiguous, "
                             f"16-byte aligned {dt} tensor on {q.device}")
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError("flash backward: o and dout must be shaped like q")
    b, sq, h, _ = q.shape
    if lse.shape != (b, h, sq):
        raise ValueError(f"flash backward: lse must be [B, H, Sq] = "
                         f"{[b, h, sq]}, got {list(lse.shape)}")
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    # the dk/dv blocks' split, and the scratch of its partial sums and of
    # dS^T where the kernels take them
    sk, kv, d = k.shape[1], k.shape[2], k.shape[3]
    nsplit = dkdv_plan(b, sq, sk, h, kv, d, causal, window, q_offset,
                       build.sm_count(q.get_device()), q.dtype)["nsplit"]
    n = bwd_scratch(b, sq, sk, h, kv, d, nsplit, q.dtype)
    part = torch.empty(n, dtype=torch.uint8, device=q.device) if n else None
    err = build.entry(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        0 if part is None else part.data_ptr(), nsplit,
        *_problem(q, k, causal, window, q_offset), _scale_arg(scale),
        build.stream_ptr(q.get_device()))
    build.check(err, fn)
    return dq, dk, dv


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward: ``(o [B, Sq, H, D] bf16, lse [B, H, Sq] f32)``;
    ``scale`` is the softmax scale (default ``1/sqrt(D)``). Float32 inputs
    go to :func:`flash_fwd_f32_cuda`."""
    if q.dtype == torch.float32:
        return flash_fwd_f32_cuda(q, k, v, causal, window, q_offset, scale)
    _check(q, k, v, causal, window, q_offset)
    out = _fwd("flash_attention", "flash_fwd", q, k, v, causal, window,
               q_offset, scale)
    flash_fwd_cuda.launches += 1
    return out


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward (delta, dk/dv, its sum pass where
    :func:`dkdv_plan` splits, dq kernels; at head dim 256 dq from the dS^T
    dk/dv wrote): ``(dq, dk, dv)`` in bf16, shaped like q, k, v. Float32
    inputs go to :func:`flash_bwd_f32_cuda`."""
    if q.dtype == torch.float32:
        return flash_bwd_f32_cuda(q, k, v, o, lse, dout, causal, window,
                                  q_offset, scale)
    _check(q, k, v, causal, window, q_offset)
    out = _bwd("flash_attention", "flash_bwd", q, k, v, o, lse, dout,
               causal, window, q_offset, scale)
    flash_bwd_cuda.launches += 1
    return out


def _check_f32(q: torch.Tensor, k, v, causal, window, q_offset) -> None:
    _check(q, k, v, causal, window, q_offset)
    if q.dtype != torch.float32:
        raise TypeError(f"the float32 flash kernels take float32, got "
                        f"{q.dtype}")


def flash_fwd_f32_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, window: Optional[int] = None,
                       q_offset: int = 0, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the float32 forward (``csrc/flash_attention_f32.cu``): ``(o
    [B, Sq, H, D], lse [B, H, Sq])``, both float32."""
    _check_f32(q, k, v, causal, window, q_offset)
    out = _fwd("flash_attention_f32", "flash_fwd_f32", q, k, v, causal,
               window, q_offset, scale)
    flash_fwd_f32_cuda.launches += 1
    return out


def flash_bwd_f32_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                       causal: bool = True, window: Optional[int] = None,
                       q_offset: int = 0, scale: Optional[float] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the float32 backward (delta, dk/dv, its sum pass where
    :func:`dkdv_plan` splits, dq kernels of ``csrc/flash_attention_f32.cu``;
    at head dim 256 dq from the dS^T dk/dv wrote): ``(dq, dk, dv)`` in
    float32; o and dout float32, lse the forward's."""
    _check_f32(q, k, v, causal, window, q_offset)
    out = _bwd("flash_attention_f32", "flash_bwd_f32", q, k, v, o, lse,
               dout, causal, window, q_offset, scale)
    flash_bwd_f32_cuda.launches += 1
    return out


flash_fwd_cuda.launches = 0
flash_bwd_cuda.launches = 0
flash_fwd_f32_cuda.launches = 0
flash_bwd_f32_cuda.launches = 0


def fold(tensors: Sequence[torch.Tensor], in_dims: Sequence[Optional[int]],
         size: int) -> list:
    """One level of ``vmap`` folded into the batch axis: each tensor's
    mapped axis (``None``: not mapped, expanded to ``size``) moved to the
    front and merged with the batch axis that follows it, contiguous."""
    out = []
    for t, d in zip(tensors, in_dims):
        t = t.expand((size,) + t.shape) if d is None else t.movedim(d, 0)
        out.append(t.reshape((size * t.shape[1],) + t.shape[2:])
                   .contiguous())
    return out


def unfold(t: torch.Tensor, size: int) -> torch.Tensor:
    """The folded batch axis split back into ``[size, B, ...]``."""
    return t.reshape((size, t.shape[0] // size) + t.shape[1:])


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    return q.device.type


class FlashBackward(torch.autograd.Function):
    """``(dq, dk, dv)`` of flash attention: the backward kernels on CUDA
    tensors (bfloat16 or float32), the plain backward on CPU tensors. Not
    differentiable again."""

    @staticmethod
    def forward(q, k, v, o, lse, dout, causal, window, q_offset,
                scale=None):
        if _device_of(q) == "cpu":
            return attention_bwd_ref(q, k, v, o, lse, dout, causal=causal,
                                     window=window, q_offset=q_offset,
                                     scale=scale)
        return flash_bwd_cuda(q, k, v, o, lse, dout, causal, window,
                              q_offset, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, dout, causal, window,
             q_offset, scale=None):
        n = info.batch_size
        args = fold((q, k, v, o, lse, dout), in_dims[:6], n)
        grads = FlashBackward.apply(*args, causal, window, q_offset, scale)
        return tuple(unfold(g, n) for g in grads), (0, 0, 0)


class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of flash attention, differentiable in q, k and v through
    :class:`FlashBackward`: the forward kernel on CUDA tensors, the plain
    forward on CPU tensors."""

    @staticmethod
    def forward(q, k, v, causal, window, q_offset, scale=None):
        if _device_of(q) == "cpu":
            return attention_fwd_ref(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset, scale=scale)
        return flash_fwd_cuda(q, k, v, causal, window, q_offset, scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_offset = inputs[:6]
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, q_offset) + tuple(inputs[6:])
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = FlashBackward.apply(q, k, v, o, lse, dout, *ctx.mask)
        return (dq, dk, dv) + (None,) * (len(ctx.mask))

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, q_offset, scale=None):
        n = info.batch_size
        o, lse = FlashAttention.apply(*fold((q, k, v), in_dims[:3], n),
                                      causal, window, q_offset, scale)
        return (unfold(o, n), unfold(lse, n)), (0, 0)
