"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752/expert
vocab=100352; 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base]"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="dbrx_132b",
        family="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=10752,
        vocab_size=100352,
        n_experts=16,
        top_k=4,
        rope_theta=5e5,
    ),
    citation="hf:databricks/dbrx-base",
)
