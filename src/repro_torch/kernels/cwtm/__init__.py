from repro_torch.kernels.cwtm.cwtm import (cwtm_cuda, cwtm_weights,
                                          sort_network_compares,
                                          sorted_weighted_cuda)
from repro_torch.kernels.cwtm.ops import cwtm
from repro_torch.kernels.cwtm.ref import cwtm_ref

__all__ = ["cwtm", "cwtm_cuda", "cwtm_ref", "cwtm_weights",
           "sort_network_compares", "sorted_weighted_cuda"]
