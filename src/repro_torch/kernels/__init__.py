"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the reference's ``kernel / ops / ref`` split: ``kernel``
wraps the CUDA C++ or Triton kernel and counts its launches, ``ref`` is the
plain PyTorch version, and ``ops`` sends a CUDA tensor to the kernel and a
CPU tensor to the plain version.

* ``matmul``  — K1, CUDA C++ (``matmul/csrc/matmul.cu``).
* ``rmsnorm`` — K2, Triton.
* ``flash``   — K3, CUDA C++ (``flash/csrc/flash.cu``).
* ``ssd``     — K4, CUDA C++ (``ssd/csrc/ssd.cu``).
"""
