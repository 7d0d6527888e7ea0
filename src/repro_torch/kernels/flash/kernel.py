"""K3 on the card: wrapper of the two hand-written CUDA flash attentions.

Replaces ``repro.kernels.flash.kernel.flash_attention_pallas``.  Two routes,
each a kernel of its own, chosen by the pure predicate
:func:`tensor_core_route` on dtype and head dim:

* ``"wgmma"`` — bf16 with ``D % 16 == 0`` and ``D <= 128``:
  ``csrc/flash_sm90.cu``, Q Kᵀ and P V by wgmma on the tensor cores, fed
  by TMA (it scales the fp32 scores instead of q, and rounds P to bf16
  before P V, within the bf16 tolerance);
* ``"fma"`` — fp32, and other head dims up to 128: ``csrc/flash.cu``,
  fp32 FMA on the CUDA cores.  fp32 stays there because TF32, the tensor
  cores' fp32 input, misses the fp32 tolerance.

The source notes say what bounds each kernel on an H100 and what its
design does about it.  Each library is built with ``nvcc`` for ``sm_90a``
at first launch (:mod:`repro_torch.kernels.build`) and launched on
PyTorch's current stream.  :data:`~repro_torch.kernels.build.LAUNCHES`
counts its launches under ``"flash"``, by route.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import LAUNCHES

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "flash_sm90.cu"
SOURCES = {"fma": SOURCE, "wgmma": SOURCE_SM90}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_INT32_MAX = 2**31 - 1


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool) -> None:
    """The shape preconditions of ``flash_attention_pallas`` that the port keeps.

    ``causal`` needs aligned windows (S == T), as there.  Ragged S and T
    are allowed: the kernel masks its edge tiles instead of refusing blocks
    that do not divide the sequence.
    """
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention: need q (B,S,H,D) and k, v (B,T,K,D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, S, H, D = q.shape
    Bk, T, K, Dk = k.shape
    if Bk != B or Dk != D or K == 0 or H % K:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} need one B "
            "and D, and H a multiple of K"
        )
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError(f"flash_attention: empty operand q {tuple(q.shape)} k {tuple(k.shape)}")
    if causal and S != T:
        raise ValueError(f"flash_attention: causal kernel assumes aligned q/kv windows, S={S} T={T}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: need float32 or bfloat16 operands of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )


def tensor_core_route(dtype: torch.dtype, D: int) -> bool:
    """True iff attention with head dim ``D`` in ``dtype`` runs on the tensor cores.

    bf16 with D a multiple of 16 (wgmma's k-step, and TMA's 16-byte rows)
    up to 128.  A function of dtype and D only.
    """
    return dtype == torch.bfloat16 and D % 16 == 0 and D <= MAX_HEAD_DIM


def _library(route: str) -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCES[route])
    ints = [ctypes.c_int] * 7  # B, S, T, H, K, D, causal
    ptrs = [ctypes.c_void_p] * 4  # q, k, v, o
    if route == "wgmma":
        fn = lib.pccl_flash_fwd_sm90
        fn.argtypes = [*ptrs, *ints, ctypes.c_float, ctypes.c_void_p]
    else:
        fn = lib.pccl_flash_fwd
        fn.argtypes = [ctypes.c_int, *ptrs, *ints, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Softmax attention of q over k, v by a CUDA kernel, output in ``q.dtype``.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device, with head dim D <= 128, and raises on anything else; it never
    computes on another path.  The route is :func:`tensor_core_route`'s; on
    the tensor-core route q, k and v must also start on 16 bytes (TMA),
    else it raises.
    """
    check_operands(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention_cuda: need q, k, v on one CUDA device, got "
            f"{q.device}, {k.device}, {v.device}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: q, k and v must be contiguous")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {D} > {MAX_HEAD_DIM}")
    if max(B * H, S, T) > _INT32_MAX:
        raise ValueError(f"flash_attention_cuda: dims {(B, S, H, T)} exceed int32")
    route = "wgmma" if tensor_core_route(q.dtype, D) else "fma"
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: the tensor-core route needs 16-byte aligned q, k, v")
    lib = _library(route)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, D, int(causal), 1.0 / math.sqrt(D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "wgmma":
            err = lib.pccl_flash_fwd_sm90(*args, stream)
        else:
            err = lib.pccl_flash_fwd(_DTYPES[q.dtype], *args, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: {route} kernel launch failed (error {err})")
    LAUNCHES.record("flash", route)
    return out
