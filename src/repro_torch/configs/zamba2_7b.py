"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64; Mamba2 backbone + ONE weight-shared attention block applied
after every 6 mamba layers (13 invocations + 3 trailing mamba layers).
[arXiv:2411.15242]"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="zamba2_7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        attn_every=6,
    ),
    citation="arXiv:2411.15242 (Zamba2)",
)
