"""K1 on the card: wrapper of the hand-written CUDA matmul (``csrc/matmul.cu``).

Replaces ``repro.kernels.matmul.kernel.matmul_pallas``.  The source note
in ``csrc/matmul.cu`` says what bounds the kernel on an H100 and what its
design does about it.  The library is built with ``nvcc`` for ``sm_90a`` at
first launch (:mod:`repro_torch.kernels.build`) and launched on PyTorch's
current stream; :attr:`matmul_cuda.launches` counts the launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    """The shape preconditions of ``matmul_pallas`` that the port keeps.

    Ragged shapes are allowed: the kernel masks its edges instead of
    refusing blocks that do not tile.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"matmul: need (M,K)@(K,N), got {tuple(x.shape)} @ {tuple(w.shape)}"
        )
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"matmul: empty operand {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(
            f"matmul: need float32 or bfloat16 operands of one dtype, got "
            f"{x.dtype} and {w.dtype}"
        )


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCE)
    lib.pccl_matmul.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pccl_matmul.restype = ctypes.c_int
    return lib


def matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` by the CUDA kernel: fp32 accumulation, output in ``x.dtype``.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device and raises on anything else; it never computes on another path.
    """
    check_operands(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"matmul_cuda: need both operands on one CUDA device, got "
            f"{x.device} and {w.device}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_cuda: operands must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    if max(M, N, K) > _INT32_MAX:
        raise ValueError(f"matmul_cuda: dims {(M, K, N)} exceed int32")
    lib = _library()
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pccl_matmul(
            _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            M, N, K, stream,
        )
    if err != 0:
        raise RuntimeError(f"matmul_cuda: kernel launch failed (cudaError {err})")
    matmul_cuda.launches += 1
    return out


matmul_cuda.launches = 0
