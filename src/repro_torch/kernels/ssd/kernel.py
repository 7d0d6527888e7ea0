"""K4 on the card: wrapper of the two hand-written CUDA SSD scans.

Replaces ``repro.kernels.ssd.kernel.ssd_pallas``.  Both routes run the scan
as three chunk-parallel passes (chunk states, the recurrence across chunks,
outputs; ``csrc/ssd_common.cuh``), chosen by the pure predicate
:func:`tensor_core_route` on dtype, P, N and chunk:

* ``"wgmma"`` — bf16 with P = N = chunk = 64 (Zamba2's widths):
  ``csrc/ssd_sm90.cu``, the chunk products by wgmma on the tensor cores, fed
  by TMA; it takes dte·B and the masked decay W as bf16 hi + lo pairs
  and rounds the state before each chunk to bf16, within the bf16
  tolerance;
* ``"fma"`` — fp32, and every other shape: ``csrc/ssd.cu``, fp32 FMA on
  the CUDA cores, a block staging 64-wide tiles of P and slices of N, so
  it takes the mLSTM's P = 1024, N = 512 (it refuses only a chunk whose
  tiles overflow a block's shared memory, ``SMEM_LIMIT``).

Beyond the TPU kernel both take an fp32 ``initial_state`` and read shared
``(B,S,N)`` B/C by index.  The source notes say what bounds each pass on an
H100 and what the design does about it.  The scratch of the passes (chunk
states, chunk totals, states before each chunk, and on the fma route each
chunk's masked L × L scores) comes from here, with ``torch.empty``.  Each
library is built with ``nvcc`` for ``sm_90a`` at first launch
(:mod:`repro_torch.kernels.build`) and launched on PyTorch's current
stream.  :data:`~repro_torch.kernels.build.LAUNCHES` counts its calls
under ``"ssd"``, by route (one per call, the three passes together).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import LAUNCHES

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "ssd_sm90.cu"
SOURCES = {"fma": SOURCE, "wgmma": SOURCE_SM90}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
TENSOR_CORE_WIDTH = 64  # P = N = chunk on the tensor-core route
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


def tensor_core_route(dtype: torch.dtype, P: int, N: int, chunk: int) -> bool:
    """True iff the scan of ``dtype`` operands with head dim ``P``, state
    size ``N`` and chunk ``chunk`` runs on the tensor cores.

    bf16 with P = N = chunk = 64: one wgmma m64n64 tile per chunk product.
    A function of these four only, not of B, S, H or the B/C layout.
    """
    return dtype == torch.bfloat16 and P == N == chunk == TENSOR_CORE_WIDTH


def _library(route: str) -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCES[route])
    ptrs = [ctypes.c_void_p] * 10  # X, la, B, C, init, Y, fin, states, totals, before
    if route == "wgmma":
        fn = lib.pccl_ssd_sm90
        fn.argtypes = [*ptrs, *[ctypes.c_int] * 4, ctypes.c_void_p]  # B, S, H, bc_per_head
    else:
        fn = lib.pccl_ssd
        # dtype, ptrs, scores, B, S, H, P, N, L, bc_per_head, stream
        fn.argtypes = [ctypes.c_int, *ptrs, ctypes.c_void_p, *[ctypes.c_int] * 7,
                       ctypes.c_void_p]
        lib.pccl_ssd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.pccl_ssd_smem_bytes.restype = ctypes.c_longlong
    fn.restype = ctypes.c_int
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
    """(Y (B,S,H,P), final state (B,H,P,N)) by a CUDA kernel, both in ``X.dtype``.

    Takes contiguous CUDA tensors on one device: X, B and C of one dtype
    (float32 or bfloat16), la and ``initial_state`` (optional; zeros when
    None) in float32.  The route is :func:`tensor_core_route`'s; on the
    tensor-core route X, B and C must also start on 16 bytes (TMA).  Raises
    on anything else, and when a launch fails; it never computes on another
    path.
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
    nc = -(-S // chunk)
    if max(B * H * nc * P, S * H * max(P, N)) > _INT32_MAX:
        raise ValueError(f"ssd_cuda: dims {(B, S, H, P, N)} exceed int32")
    route = "wgmma" if tensor_core_route(X.dtype, P, N, chunk) else "fma"
    if route == "wgmma" and any(t.data_ptr() % 16 for t in (X, Bm, Cm)):
        raise ValueError("ssd_cuda: the tensor-core route needs 16-byte aligned X, B, C")
    lib = _library(route)
    if route == "fma":
        smem = lib.pccl_ssd_smem_bytes(P, N, chunk)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"ssd_cuda: (P, N, chunk) = {(P, N, chunk)} needs {smem} bytes of shared "
                f"memory per block, over {SMEM_LIMIT}"
            )
    dev = X.device
    Y = torch.empty_like(X)
    fin = torch.empty((B, H, P, N), dtype=X.dtype, device=dev)
    states = torch.empty((B, H, nc, P, N), dtype=torch.float32, device=dev)
    totals = torch.empty((B, H, nc), dtype=torch.float32, device=dev)
    before = torch.empty((B, H, nc, P, N), dtype=X.dtype if route == "wgmma" else torch.float32,
                         device=dev)
    ptrs = (X.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            Y.data_ptr(), fin.data_ptr(), states.data_ptr(), totals.data_ptr(), before.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma":
            err = lib.pccl_ssd_sm90(*ptrs, B, S, H, int(Bm.ndim == 4), stream)
        else:
            scores = torch.empty((B, H, nc, chunk, chunk), dtype=torch.float32, device=dev)
            err = lib.pccl_ssd(_DTYPES[X.dtype], *ptrs, scores.data_ptr(), B, S, H, P, N, chunk,
                               int(Bm.ndim == 4), stream)
    if err != 0:
        raise RuntimeError(f"ssd_cuda: {route} kernel launch failed (error {err})")
    LAUNCHES.record("ssd", route)
    return Y, fin
