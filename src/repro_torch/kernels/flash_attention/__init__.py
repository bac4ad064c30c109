from repro_torch.kernels.flash_attention.flash import (
    HEAD_DIMS, FlashAttention, FlashBackward, flash_bwd_cuda,
    flash_bwd_f32_cuda, flash_fwd_cuda, flash_fwd_f32_cuda, fully_masked_rows,
    padded_dim)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     padded_attention)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_mask,
                                                     attention_ref)

__all__ = ["HEAD_DIMS", "FlashAttention", "FlashBackward",
           "flash_attention", "flash_bwd_cuda", "flash_fwd_cuda",
           "flash_bwd_f32_cuda", "flash_fwd_f32_cuda",
           "fully_masked_rows", "padded_attention", "padded_dim",
           "attention_bwd_ref", "attention_fwd_ref", "attention_mask",
           "attention_ref"]
