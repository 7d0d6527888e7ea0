"""Hand-written Hopper kernels of the port, one package per TPU kernel.

Each package keeps the reference's ``kernel / ops / ref`` split: ``kernel``
wraps the CUDA C++ or Triton kernel and counts its launches, ``ref`` is the
plain PyTorch version, and ``ops`` sends a CUDA tensor to the kernel and a
CPU tensor to the plain version.

* ``matmul``  — K1, CUDA C++: bf16 on the tensor cores
  (``matmul/csrc/matmul_sm90.cu``), fp32 on the CUDA cores
  (``matmul/csrc/matmul.cu``).
* ``rmsnorm`` — K2, Triton.
* ``flash``   — K3, CUDA C++: bf16 on the tensor cores
  (``flash/csrc/flash_sm90.cu``), fp32 on the CUDA cores
  (``flash/csrc/flash.cu``).

``csrc/sm90.cuh`` holds the Hopper building blocks (TMA, mbarriers, wgmma
descriptors, tensor maps) the two tensor-core kernels share.
* ``ssd``     — K4, CUDA C++ (``ssd/csrc/ssd.cu``).
"""
