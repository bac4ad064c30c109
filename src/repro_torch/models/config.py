"""Model configuration (counterpart of ``repro.models.config``): the same
``ModelConfig`` with every field, so a configuration carries across to the
reference field for field. The port builds all six families
(``repro_torch.models.transformer``)."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config class for dense / moe / ssm / hybrid / vlm / audio decoders.

    Only the fields relevant to a family are consumed by the builder; the
    reference's ``models/transformer.py`` documents the layer patterns
    (``attn_every`` for hybrids, ``cross_attn_every`` for VLMs,
    ``first_k_dense`` for MoE stacks).
    """

    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: Optional[int] = None  # default: d_model // n_heads
    qkv_bias: bool = False
    mlp: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # None = full causal attention

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    first_k_dense: int = 0  # leading dense layers in an MoE stack (DeepSeek)

    # --- MLA (DeepSeek-V2) ---
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    ssm_n_groups: int = 1

    # --- hybrid (Zamba2): one weight-shared attention block applied after
    #     every ``attn_every`` mamba layers ---
    attn_every: int = 0

    # --- VLM (Llama-3.2-Vision): every ``cross_attn_every``-th layer is a
    #     cross-attention layer over stub image embeddings ---
    cross_attn_every: int = 0
    n_image_tokens: int = 1024

    # --- input modality: "tokens" (ids) or "embeddings" (audio stub) ---
    input_kind: str = "tokens"

    # --- attention backend: None or True takes the flash-attention kernel
    #     path (``repro_torch.kernels.flash_attention``: the CUDA kernels on
    #     the card, which take bf16 only, and their plain dense version on
    #     the CPU); False takes the plain query-chunked ``causal_attention``.
    #     Train-mode self-attention only. ---
    use_flash_attention: Optional[bool] = None

    dtype: str = "bfloat16"

    # ----------------------------------------------------------------- #

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if the arch can decode at 500k+ context: SSM/hybrid natively,
        attention archs via a sliding window."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, n_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant of the same family (assignment: <=2 layers,
        d_model <= 512, <= 4 experts)."""
        hd = 64
        n_heads = max(2, d_model // 128)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        kw = dict(
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=hd,
            d_ff=2 * d_model,
            vocab_size=min(self.vocab_size, 512),
        )
        if self.n_experts:
            kw.update(n_experts=min(self.n_experts, max_experts),
                      top_k=min(self.top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_k_dense=min(self.first_k_dense, 1))
        if self.use_mla:
            kw.update(kv_lora_rank=64, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
                      ssm_chunk=32)
        if self.attn_every:
            kw.update(attn_every=1, n_layers=2)
        if self.cross_attn_every:
            kw.update(cross_attn_every=2, n_layers=2, n_image_tokens=16)
        return dataclasses.replace(self, **kw)
