"""Dispatch for flash attention: the plain version for CPU tensors, the
CUDA kernels (forward and backward, under ``torch.func`` too) for CUDA
tensors. A head dim below 128 that the kernels are not built for (zamba2's
112) is zero-padded to 128 around the kernel call, outside its
``autograd.Function``, as the reference's ``ops.attention`` pads to 128
lanes; the kernels take the head dim's own softmax scale as an argument."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash import (FlashAttention,
                                                       padded_dim)
from repro_torch.kernels.flash_attention.ref import attention_ref


def padded_attention(attend: Callable, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, dp: int, *args) -> torch.Tensor:
    """``attend(q, k, v, *args, scale)`` at head dim ``dp`` for inputs of
    head dim ``D < dp``: q, k and v zero-padded to ``dp`` (the padded lanes
    add nothing to q.k and give zero output lanes, sliced off) and the
    softmax scale ``1/sqrt(D)`` passed on, so the values are the unpadded
    attention's. Differentiable: the pad and the slice are autograd
    operations around ``attend``."""
    d = q.shape[-1]
    pad = (0, dp - d)
    return attend(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), *args,
                  1.0 / math.sqrt(d))[..., :d]


def _kernel(q, k, v, causal, window, q_offset, scale=None):
    return FlashAttention.apply(q, k, v, causal, window, q_offset, scale)[0]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) GQA attention, differentiable.
    q ``[B, Sq, H, D]``; k, v ``[B, Sk, KV, D]`` -> ``[B, Sq, H, D]``."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda tensors, got "
                         f"{q.device}")
    dp = padded_dim(q.shape[-1])
    if dp != q.shape[-1]:
        return padded_attention(_kernel, q, k, v, dp, causal, window,
                                q_offset)
    return _kernel(q, k, v, causal, window, q_offset)
