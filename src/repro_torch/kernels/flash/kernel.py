"""K3 on the card: wrapper of the hand-written CUDA flash attention (``csrc/flash.cu``).

Replaces ``repro.kernels.flash.kernel.flash_attention_pallas``.  The source
note in ``csrc/flash.cu`` says what bounds the kernel on an H100 and what
its design does about it.  The library is built with ``nvcc`` for
``sm_90a`` at first launch (:mod:`repro_torch.kernels.build`) and launched
on PyTorch's current stream; :attr:`flash_attention_cuda.launches` counts
the launches.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash.cu"
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


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCE)
    lib.pccl_flash_fwd.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.pccl_flash_fwd.restype = ctypes.c_int
    return lib


def flash_attention_cuda(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Softmax attention of q over k, v by the CUDA kernel, output in ``q.dtype``.

    Takes contiguous CUDA tensors of one dtype (float32 or bfloat16) on one
    device, with head dim D <= 128, and raises on anything else; it never
    computes on another path.
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
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.pccl_flash_fwd(
            _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, T, H, K, D, int(causal), 1.0 / math.sqrt(D), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: kernel launch failed (cudaError {err})")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
