from repro_torch.kernels.randk.ops import (compress, decompress,
                                          momentum_update)
from repro_torch.kernels.randk.randk import (block_compress_cuda,
                                             block_decompress_cuda,
                                             momentum_scatter_cuda, slot_map)
from repro_torch.kernels.randk.ref import (block_compress_ref,
                                           block_decompress_ref,
                                           momentum_scatter_ref)

__all__ = ["compress", "decompress", "momentum_update", "block_compress_cuda",
           "block_decompress_cuda", "momentum_scatter_cuda", "slot_map",
           "block_compress_ref", "block_decompress_ref",
           "momentum_scatter_ref"]
