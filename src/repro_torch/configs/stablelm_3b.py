"""stablelm-3b [dense] — 32L d_model=2560 32H (GQA kv=32, i.e. MHA) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family, scaled per assignment]"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="stablelm_3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        d_ff=6912,
        vocab_size=50304,
        mlp="swiglu",
        norm="layernorm",   # StableLM-2 uses LayerNorm
        rope_theta=1e4,
    ),
    citation="hf:stabilityai/stablelm-2-1_6b",
)
