"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000;
GeGLU; head_dim=256; tied embeddings.  [arXiv:2403.08295]"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="gemma_2b",
        family="dense",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16384,
        vocab_size=256000,
        mlp="geglu",
        tie_embeddings=True,
        rope_theta=1e4,
    ),
    citation="arXiv:2403.08295 (Gemma)",
)
