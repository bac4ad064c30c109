from repro_torch.kernels.median.median import median_cuda, median_weights
from repro_torch.kernels.median.ops import median
from repro_torch.kernels.median.ref import median_ref

__all__ = ["median", "median_cuda", "median_ref", "median_weights"]
