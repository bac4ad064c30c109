"""Config registry (counterpart of ``repro.configs.base``): input shapes,
architectures and the shape-dependent policy.

The port carries every architecture of the reference: the dense
``stablelm_3b`` (the LLM training path), ``qwen25_3b`` (GQA with a QKV
bias), ``gemma_2b`` (MQA, head dim 256, GeGLU, tied embeddings) and
``mistral_large_123b``; the audio ``musicgen_medium`` (embedding inputs);
the vlm ``llama32_vision_11b`` (gated cross-attention layers); the MoE
``dbrx_132b`` (16 experts, top 4) and ``deepseek_v2_lite_16b`` (MLA, 64
routed experts top 6 and 2 shared, one leading dense layer); the SSM
``mamba2_1_3b``; and the hybrid ``zamba2_7b`` (Mamba2 with one shared
attention block every 6 layers). ``get_arch("mnist_cnn")`` also returns
the paper's own CNN (``configs/mnist_cnn.py``), which stays out of
``ARCH_IDS`` as in the reference."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# sliding window applied to attention archs for the long_500k decode shape
LONG_CONTEXT_WINDOW = 8_192


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """An assigned architecture: model config, RoSDHB ratio, source (the
    reference's ``fsdp`` sharding policy has no single-card counterpart)."""

    model: ModelConfig
    citation: str
    rosdhb_ratio: float = 0.05  # default k/d for the RoSDHB train step

    @property
    def name(self) -> str:
        return self.model.name


#: The reference's architecture ids, and those the port can build.
ARCH_IDS = [
    "stablelm_3b", "mamba2_1_3b", "deepseek_v2_lite_16b", "musicgen_medium",
    "dbrx_132b", "mistral_large_123b", "llama32_vision_11b", "qwen25_3b",
    "gemma_2b", "zamba2_7b",
]
PORTED_ARCHS = list(ARCH_IDS)

_ALIASES = {
    "stablelm-3b": "stablelm_3b",
    "mamba2-1.3b": "mamba2_1_3b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "musicgen-medium": "musicgen_medium",
    "dbrx-132b": "dbrx_132b",
    "mistral-large-123b": "mistral_large_123b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "qwen2.5-3b": "qwen25_3b",
    "gemma-2b": "gemma_2b",
    "zamba2-7b": "zamba2_7b",
}


def get_arch(arch_id: str) -> ArchSpec:
    arch_id = _ALIASES.get(arch_id, arch_id).replace("-", "_").replace(".", "_")
    if arch_id not in ARCH_IDS + ["mnist_cnn"]:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch_id}").SPEC


def model_for_shape(spec: ArchSpec, shape: InputShape) -> ModelConfig:
    """Apply shape-dependent policy (sliding window for long-context decode
    on attention archs)."""
    cfg = spec.model
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid") \
            and not cfg.use_mla:
        cfg = cfg.with_overrides(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def list_archs():
    return list(ARCH_IDS)
