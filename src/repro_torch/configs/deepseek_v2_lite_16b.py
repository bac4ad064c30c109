"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408/expert
vocab=102400; MLA kv_lora=512; MoE 64 routed experts top-6 + 2 shared;
first layer dense.  [arXiv:2405.04434]

Note: the assignment note mentions "160 routed" while the headline spec says
"MoE 64e top-6" — we follow the headline spec (64 routed, top-6) and record
the discrepancy here.
"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="deepseek_v2_lite_16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        n_experts=64,
        top_k=6,
        n_shared_experts=2,
        first_k_dense=1,
        use_mla=True,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    citation="arXiv:2405.04434 (DeepSeek-V2)",
)
