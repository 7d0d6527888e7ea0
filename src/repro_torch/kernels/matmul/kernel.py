"""K1 on the card: wrapper of the two hand-written CUDA matmuls.

Replaces ``repro.kernels.matmul.kernel.matmul_pallas``.  Two routes, each a
kernel of its own, chosen by the pure predicate :func:`tensor_core_route`
on dtype, K and N (never on M, so per-chunk calls take the route of the
whole-M call):

* ``"wgmma"`` — bf16 with ``K % 8 == 0`` and ``N % 8 == 0`` (TMA's 16-byte
  strides): ``csrc/matmul_sm90.cu``, wgmma on the tensor cores fed by TMA;
* ``"fma"`` — fp32, and bf16 shapes TMA cannot address:
  ``csrc/matmul.cu``, fp32 FMA on the CUDA cores.  fp32 stays there
  because TF32, the tensor cores' fp32 input, keeps 10 mantissa bits and
  misses the fp32 tolerance.

The source notes say what bounds each kernel on an H100 and what its
design does about it.  Each library is built with ``nvcc`` for ``sm_90a``
at first launch (:mod:`repro_torch.kernels.build`) and launched on
PyTorch's current stream.  :data:`~repro_torch.kernels.build.LAUNCHES`
counts its launches under ``"matmul"``, by route.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import GEOMETRY_ARGTYPES, LAUNCHES, verify_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "matmul.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "matmul_sm90.cu"
SOURCES = {"fma": SOURCE, "wgmma": SOURCE_SM90}
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


def tensor_core_route(dtype: torch.dtype, K: int, N: int) -> bool:
    """True iff ``(M, K) @ (K, N)`` in ``dtype`` runs on the tensor cores.

    bf16 operands whose rows TMA can address (``K`` and ``N`` multiples of
    8, so every row starts on 16 bytes).  A function of dtype, K and N
    only: the route, tile shape and K order never depend on M.
    """
    return dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0


def matmul_route(x_shape, w_shape, dtype: torch.dtype) -> str:
    """The kernel :func:`matmul_cuda` launches for ``x (M, K) @ w (K, N)``:
    ``"wgmma"`` or ``"fma"``.  M is not read."""
    K, N = x_shape[1], w_shape[1]
    return "wgmma" if tensor_core_route(dtype, K, N) else "fma"


def _library(route: str) -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCES[route])
    if route == "wgmma":
        fn = lib.pccl_matmul_sm90
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        geometry = lib.pccl_matmul_sm90_geometry
        geometry.argtypes = [ctypes.c_int, ctypes.c_int, *GEOMETRY_ARGTYPES]  # M, N
    else:
        fn = lib.pccl_matmul
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        geometry = lib.pccl_matmul_geometry
        geometry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, *GEOMETRY_ARGTYPES]
    fn.restype = geometry.restype = ctypes.c_int
    return lib


def matmul_cuda(
    x: torch.Tensor, w: torch.Tensor, *, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``x @ w`` by a CUDA kernel: fp32 accumulation, output in ``x.dtype``.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device and raises on anything else; it never computes on another path.
    The route is :func:`tensor_core_route`'s; on the tensor-core route the
    operands must also start on 16 bytes (TMA), else it raises.  ``out``
    (optional, contiguous ``(M, N)`` in ``x.dtype``) receives the result.
    """
    check_operands(x, w)
    route = matmul_route(x.shape, w.shape, x.dtype)
    verify_launch(f"matmul:{route}", matmul_cuda, (x, w))
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
    if route == "wgmma" and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("matmul_cuda: the tensor-core route needs 16-byte aligned operands")
    lib = _library(route)
    if out is None:
        out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    elif (tuple(out.shape) != (M, N) or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous() or (route == "wgmma" and out.data_ptr() % 4)):
        raise ValueError(f"matmul_cuda: out must be a contiguous ({M}, {N}) {x.dtype} tensor "
                         f"on {x.device}")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            err = lib.pccl_matmul_sm90(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, stream)
        else:
            err = lib.pccl_matmul(
                _DTYPES[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K, stream,
            )
    if err != 0:
        raise RuntimeError(f"matmul_cuda: {route} kernel launch failed (error {err})")
    LAUNCHES.record("matmul", route)
    return out
