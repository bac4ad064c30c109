"""Dispatch for flash attention: the plain version for CPU tensors, the
CUDA kernels (forward and backward, under ``torch.func`` too) for CUDA
tensors."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash import FlashAttention
from repro_torch.kernels.flash_attention.ref import attention_ref


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
    return FlashAttention.apply(q, k, v, causal, window, q_offset)[0]
