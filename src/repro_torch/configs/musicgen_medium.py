"""musicgen-medium [audio] — 48L d_model=1536 24H d_ff=6144 vocab=2048;
decoder-only over EnCodec tokens.  [arXiv:2306.05284]

The EnCodec frontend is a STUB per the assignment carve-out: input_specs()
provides precomputed frame embeddings [B, S, 1536]; targets are codebook ids.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="musicgen_medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab_size=2048,
        mlp="gelu",         # MusicGen uses standard transformer FFN
        norm="layernorm",
        input_kind="embeddings",
    ),
    citation="arXiv:2306.05284 (MusicGen)",
)
