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

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)

HEAD_DIMS = (64, 80, 128, 256)
#: The input dtypes the kernels take: bfloat16 (``csrc/flash_attention.cu``,
#: on the tensor cores) and float32 (``csrc/flash_attention_f32.cu``, on the
#: CUDA cores).
DTYPES = (torch.bfloat16, torch.float32)
#: Head dims up to this one that the kernel is not built for are taken
#: zero-padded to the next multiple of 128 (``ops.flash_attention``), as the
#: reference's ``ops.attention`` pads to whole 128-lane tiles.
PAD_MAX = 256


def padded_dim(d: int) -> int:
    """The head dim the kernel runs for a model's head dim ``d``: ``d``
    itself where it is built for it or past :data:`PAD_MAX`, else the next
    multiple of 128 (112 -> 128, 192 -> 256)."""
    return d if d in HEAD_DIMS or d > PAD_MAX else -(-d // 128) * 128


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
    :data:`HEAD_DIMS` (with ``pad``, also a D
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
    if (padded_dim(d) if pad else d) not in HEAD_DIMS:
        return ValueError, (f"flash attention kernel is built for head dims "
                            f"{HEAD_DIMS}" + (f" and takes those up to "
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
    err = build.entry(lib, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
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
    """Launch the backward (delta, dk/dv, dq kernels): ``(dq, dk, dv)`` in
    bf16, shaped like q, k, v. Float32 inputs go to
    :func:`flash_bwd_f32_cuda`."""
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
    """Launch the float32 backward (delta, dk/dv, dq kernels of
    ``csrc/flash_attention_f32.cu``): ``(dq, dk, dv)`` in float32; o and
    dout float32, lse the forward's."""
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
