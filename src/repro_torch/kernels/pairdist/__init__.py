from repro_torch.kernels.pairdist.ops import pairdist
from repro_torch.kernels.pairdist.pairdist import pairdist_cuda
from repro_torch.kernels.pairdist.ref import pairdist_ref

__all__ = ["pairdist", "pairdist_cuda", "pairdist_ref"]
