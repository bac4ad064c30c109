"""PyTorch + CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``repro`` stays the reference; this package never imports it
nor JAX. Plain tensor code is PyTorch; the reference's Pallas TPU kernels on
the ported path are hand-written CUDA C++ (``csrc/``, bound by
``kernels/build.py``). Entry points run on the card unless their caller asks
for ``device="cpu"``, where each kernel wrapper runs its plain PyTorch
version instead.
"""
