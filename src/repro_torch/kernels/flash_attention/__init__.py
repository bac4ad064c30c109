from repro_torch.kernels.flash_attention.flash import (
    F32_HEAD_DIMS, HEAD_DIMS, FlashAttention, FlashBackward, bwd_scratch,
    dkdv_plan, flash_bwd_cuda, flash_bwd_f32_cuda, flash_fwd_cuda,
    flash_fwd_f32_cuda, fully_masked_rows, head_dims, padded_dim)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     padded_attention)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_mask,
                                                     attention_ref)

__all__ = ["F32_HEAD_DIMS", "HEAD_DIMS", "FlashAttention", "FlashBackward",
           "bwd_scratch", "dkdv_plan", "head_dims",
           "flash_attention", "flash_bwd_cuda", "flash_fwd_cuda",
           "flash_bwd_f32_cuda", "flash_fwd_f32_cuda",
           "fully_masked_rows", "padded_attention", "padded_dim",
           "attention_bwd_ref", "attention_fwd_ref", "attention_mask",
           "attention_ref"]
