"""The paper's own Section-4 model: ~11.8k-parameter CNN for 10-class
28x28 grayscale classification. Not part of the assigned-arch pool; used by
the paper-faithful reproduction benchmarks (``benchmarks/bench_torch_*``;
the CNN itself is ``repro_torch.models.cnn``)."""

from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

SPEC = ArchSpec(
    model=ModelConfig(name="mnist_cnn", family="dense", n_layers=0,
                      d_model=0, n_heads=0, n_kv_heads=0, d_ff=0,
                      vocab_size=10),
    citation="the paper, Section 4",
)
