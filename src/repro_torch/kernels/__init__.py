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
* ``ssd``     — K4, CUDA C++, three chunk-parallel passes: bf16 at
  P = N = chunk = 64 on the tensor cores (``ssd/csrc/ssd_sm90.cu``), the
  rest on the CUDA cores (``ssd/csrc/ssd.cu``); the recurrence pass both
  share is in ``ssd/csrc/ssd_common.cuh``.

``csrc/sm90.cuh`` holds the Hopper building blocks (TMA, mbarriers, wgmma
descriptors, tensor maps) the three tensor-core kernels share.
"""
