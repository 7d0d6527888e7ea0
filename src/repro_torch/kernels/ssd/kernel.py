"""K4 on the card: wrapper of the hand-written CUDA SSD scan (``csrc/ssd.cu``).

Replaces ``repro.kernels.ssd.kernel.ssd_pallas``.  The source note in
``csrc/ssd.cu`` says what bounds the kernel on an H100 and what its design
does about it.  Beyond the TPU kernel it takes an fp32 ``initial_state``
and reads shared ``(B,S,N)`` B/C by index.  The library is built with
``nvcc`` for ``sm_90a`` at first launch (:mod:`repro_torch.kernels.build`)
and launched on PyTorch's current stream; :attr:`ssd_cuda.launches` counts
the launches.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
_INT32_MAX = 2**31 - 1


def check_operands(X, la, Bm, Cm, *, chunk: int, initial_state=None) -> None:
    """Shapes of ``ssd_reference``'s operands."""
    if X.ndim != 4:
        raise ValueError(f"ssd: need X (B,S,H,P), got {tuple(X.shape)}")
    B, S, H, P = X.shape
    if X.numel() == 0:
        raise ValueError(f"ssd: empty X {tuple(X.shape)}")
    if tuple(la.shape) != (B, S, H):
        raise ValueError(f"ssd: la {tuple(la.shape)} != (B,S,H) = {(B, S, H)}")
    if Bm.shape != Cm.shape or Bm.ndim not in (3, 4) or tuple(Bm.shape[:2]) != (B, S) or (
        Bm.ndim == 4 and Bm.shape[2] != H
    ):
        raise ValueError(
            f"ssd: B/C must both be (B,S,N) or (B,S,H,N) with X {tuple(X.shape)}, got "
            f"{tuple(Bm.shape)} and {tuple(Cm.shape)}"
        )
    if chunk < 1:
        raise ValueError(f"ssd: chunk {chunk} < 1")
    N = Bm.shape[-1]
    if initial_state is not None and tuple(initial_state.shape) != (B, H, P, N):
        raise ValueError(
            f"ssd: initial_state {tuple(initial_state.shape)} != (B,H,P,N) = {(B, H, P, N)}"
        )


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCE)
    lib.pccl_ssd.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.pccl_ssd.restype = ctypes.c_int
    lib.pccl_ssd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.pccl_ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd_cuda(
    X: torch.Tensor,
    la: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Y (B,S,H,P), final state (B,H,P,N)) by the CUDA kernel, both in ``X.dtype``.

    Takes contiguous CUDA tensors on one device: X, B and C of one dtype
    (float32 or bfloat16), la and ``initial_state`` (optional; zeros when
    None) in float32.  Raises on anything else; it never computes on
    another path.
    """
    check_operands(X, la, Bm, Cm, chunk=chunk, initial_state=initial_state)
    ops = [X, la, Bm, Cm] + ([initial_state] if initial_state is not None else [])
    if X.device.type != "cuda" or any(t.device != X.device for t in ops):
        raise ValueError(
            f"ssd_cuda: need every operand on one CUDA device, got {[str(t.device) for t in ops]}"
        )
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("ssd_cuda: operands must be contiguous")
    if X.dtype not in _DTYPES or Bm.dtype != X.dtype or Cm.dtype != X.dtype:
        raise ValueError(
            f"ssd_cuda: need X, B, C float32 or bfloat16 of one dtype, got "
            f"{X.dtype}, {Bm.dtype}, {Cm.dtype}"
        )
    if la.dtype != torch.float32 or (
        initial_state is not None and initial_state.dtype != torch.float32
    ):
        raise ValueError("ssd_cuda: la and initial_state must be float32")
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    if max(B * H, S * H * max(P, N)) > _INT32_MAX:
        raise ValueError(f"ssd_cuda: dims {(B, S, H, P, N)} exceed int32")
    lib = _library()
    smem = lib.pccl_ssd_smem_bytes(P, N, chunk)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"ssd_cuda: (P, N, chunk) = {(P, N, chunk)} needs {smem} bytes of shared "
            f"memory per block, over {SMEM_LIMIT}"
        )
    Y = torch.empty_like(X)
    fin = torch.empty((B, H, P, N), dtype=X.dtype, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.pccl_ssd(
            _DTYPES[X.dtype], X.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            Y.data_ptr(), fin.data_ptr(), B, S, H, P, N, chunk, int(Bm.ndim == 4), stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_cuda: kernel launch failed (cudaError {err})")
    ssd_cuda.launches += 1
    return Y, fin


ssd_cuda.launches = 0
