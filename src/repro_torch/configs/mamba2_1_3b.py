"""mamba2-1.3b [ssm] — 48L d_model=2048 attention-free, vocab=50280,
ssm_state=128.  SSD (state-space duality) [arXiv:2405.21060]"""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(
        name="mamba2_1_3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=1,          # unused (attention-free)
        n_kv_heads=1,
        d_ff=0,             # no MLP: the mamba block carries expand=2
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_conv_width=4,
        ssm_chunk=256,
        ssm_n_groups=1,
    ),
    citation="arXiv:2405.21060 (SSD)",
)
