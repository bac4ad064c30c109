"""Hand-written Hopper kernels of the port, one family per TPU kernel family
of ``repro.kernels``.

Each family keeps the reference's three files: ``<name>.py`` (the CUDA
wrapper, with a ``launches`` counter), ``ops.py`` (dispatch: the plain
version for a CPU tensor, the kernel for a CUDA tensor, an error otherwise)
and ``ref.py`` (the plain PyTorch version). The CUDA C++ sources live in
``repro_torch/csrc/`` and are compiled on first use by :mod:`.build`.
"""

from __future__ import annotations


def kernel_wrappers():
    """``{name: wrapper}`` of every kernel wrapper with a launch counter."""
    from repro_torch.kernels.cwtm.cwtm import cwtm_cuda
    from repro_torch.kernels.flash_attention.flash import (
        flash_bwd_cuda, flash_bwd_f32_cuda, flash_fwd_cuda, flash_fwd_f32_cuda)
    from repro_torch.kernels.median.median import median_cuda
    from repro_torch.kernels.pairdist.pairdist import pairdist_cuda
    from repro_torch.kernels.randk.randk import (block_compress_cuda,
                                                 block_decompress_cuda,
                                                 momentum_scatter_cuda)
    return {"pairdist": pairdist_cuda, "cwtm": cwtm_cuda,
            "median": median_cuda, "block_compress": block_compress_cuda,
            "block_decompress": block_decompress_cuda,
            "momentum_scatter": momentum_scatter_cuda,
            "flash_fwd": flash_fwd_cuda, "flash_bwd": flash_bwd_cuda,
            "flash_fwd_f32": flash_fwd_f32_cuda,
            "flash_bwd_f32": flash_bwd_f32_cuda}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}
