"""llama-3.2-vision-11b [vlm] — 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256; cross-attention image layers (every 5th layer).
[hf:meta-llama/Llama-3.2-11B-Vision]

The ViT/projector frontend is a STUB per the assignment carve-out:
input_specs() provides precomputed patch embeddings [B, 1024, 4096]."""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="llama32_vision_11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        rope_theta=5e5,
        cross_attn_every=5,
        n_image_tokens=1024,
    ),
    citation="hf:meta-llama/Llama-3.2-11B-Vision",
)
