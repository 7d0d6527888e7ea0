"""K4 on the card: wrapper of the three hand-written CUDA SSD scans.

Replaces ``repro.kernels.ssd.kernel.ssd_pallas``.  Every route runs the
scan as three chunk-parallel passes (chunk states, the recurrence across
chunks, outputs; ``csrc/ssd_common.cuh``), chosen by the pure function
:func:`ssd_route` of dtype, P, N and chunk:

* ``"wgmma"`` — bf16 with P = N = chunk = 64 (Zamba2's widths):
  ``csrc/ssd_sm90.cu``, the chunk products by wgmma on the tensor cores, fed
  by TMA; it takes dte·B and the masked decay W as bf16 hi + lo pairs
  and rounds the state before each chunk to bf16, within the bf16
  tolerance;
* ``"wgmma_tiled"`` — bf16 with chunk 64 and P, N other multiples of 64
  (the mLSTM's P = 1024, N = 512): ``csrc/ssd_sm90_tiled.cu``, the same
  products over 64-row P-tiles, with N-slices streamed by TMA through a
  ring; dte scales X instead of B, and the state before each chunk is a
  bf16 hi + lo pair (one bf16 rounding of it, summed over N = 512, misses
  the bf16 tolerance);
* ``"fma"`` — fp32, and every other shape: ``csrc/ssd.cu``, fp32 FMA on
  the CUDA cores, 8×8 register tiles fed from shared memory by ``cp.async``
  rings; a block runs several 256-column tiles of X in turn, heads side by
  side where B and C are shared and P is 64 or 128 (it refuses only a
  chunk whose rings and decays overflow a block's shared memory,
  ``SMEM_LIMIT``).

Beyond the TPU kernel all take an fp32 ``initial_state`` and read shared
``(B,S,N)`` B/C by index.  The source notes say what bounds each pass on an
H100 and what the design does about it.  The scratch of the passes (chunk
states, chunk totals, states before each chunk, and on the fma route each
chunk's raw L × L scores C Bᵀ, once per (b, chunk) where B and C are shared)
comes from here, with ``torch.empty``.  Each
library is built with ``nvcc`` for ``sm_90a`` at first launch
(:mod:`repro_torch.kernels.build`) and launched on PyTorch's current
stream.  :data:`~repro_torch.kernels.build.LAUNCHES` counts its calls
under ``"ssd"``, by route (one per call, the three passes together).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.build import GEOMETRY_ARGTYPES, LAUNCHES, verify_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd.cu"
SOURCE_SM90 = Path(__file__).resolve().parent / "csrc" / "ssd_sm90.cu"
SOURCE_SM90_TILED = Path(__file__).resolve().parent / "csrc" / "ssd_sm90_tiled.cu"
SOURCES = {"fma": SOURCE, "wgmma": SOURCE_SM90, "wgmma_tiled": SOURCE_SM90_TILED}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
TENSOR_CORE_WIDTH = 64  # the chunk, and the tile of P and N, on the tensor-core routes
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

    bf16 with chunk 64 and P, N multiples of 64: wgmma m64n64 tiles, one
    per chunk product at P = N = 64, 64-row P-tiles and 64-column N-slices
    beyond.  A function of these four only, not of B, S, H or the B/C
    layout.
    """
    w = TENSOR_CORE_WIDTH
    return (dtype == torch.bfloat16 and chunk == w and min(P, N) > 0
            and P % w == 0 and N % w == 0)


def _library(route: str) -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCES[route])
    ptrs = [ctypes.c_void_p] * 10  # X, la, B, C, init, Y, fin, states, totals, before
    if route == "wgmma_tiled":
        fn = lib.pccl_ssd_sm90_tiled
        fn.argtypes = [*ptrs, *[ctypes.c_int] * 6, ctypes.c_void_p]  # B, S, H, P, N, bc_per_head
        geometry = lib.pccl_ssd_sm90_tiled_geometry
        geometry.argtypes = [*[ctypes.c_int] * 6, *GEOMETRY_ARGTYPES]  # pass, B, S, H, P, N
    elif route == "wgmma":
        fn = lib.pccl_ssd_sm90
        fn.argtypes = [*ptrs, *[ctypes.c_int] * 4, ctypes.c_void_p]  # B, S, H, bc_per_head
        geometry = lib.pccl_ssd_sm90_geometry
        geometry.argtypes = [*[ctypes.c_int] * 4, *GEOMETRY_ARGTYPES]  # pass, B, S, H
    else:
        fn = lib.pccl_ssd
        # dtype, ptrs, scores, B, S, H, P, N, L, bc_per_head, stream
        fn.argtypes = [ctypes.c_int, *ptrs, ctypes.c_void_p, *[ctypes.c_int] * 7,
                       ctypes.c_void_p]
        lib.pccl_ssd_smem_bytes.argtypes = [ctypes.c_int]  # L
        lib.pccl_ssd_smem_bytes.restype = ctypes.c_longlong
        geometry = lib.pccl_ssd_geometry
        # dtype, pass, B, S, H, P, N, L, bc_per_head
        geometry.argtypes = [*[ctypes.c_int] * 9, *GEOMETRY_ARGTYPES]
    fn.restype = geometry.restype = ctypes.c_int
    return lib


def ssd_route(dtype: torch.dtype, P: int, N: int, chunk: int) -> str:
    """The kernel :func:`ssd_cuda` launches: ``"wgmma"`` at P = N = chunk =
    64, ``"wgmma_tiled"`` at the other tensor-core widths, else ``"fma"``."""
    if not tensor_core_route(dtype, P, N, chunk):
        return "fma"
    return "wgmma" if P == N == TENSOR_CORE_WIDTH else "wgmma_tiled"


def buffers(X_shape, N: int, chunk: int, dtype: torch.dtype, route: str, *,
            per_head: bool) -> Dict[str, tuple]:
    """(shape, dtype) of every buffer one :func:`ssd_cuda` call writes, by
    name: the outputs ``Y`` and ``fin`` and the passes' scratch (``scores``
    on the fma route only, the raw C Bᵀ of each chunk: ``(B, nc, L, L)``
    for B and C shared across heads, ``(B, H, nc, L, L)`` for ``per_head``
    ones; ``before``, the state before each chunk, in fp32 on fma, bf16 on
    wgmma, and a bf16 hi + lo pair on wgmma_tiled)."""
    B, S, H, P = X_shape
    nc = -(-S // chunk)
    before = {"fma": ((B, H, nc, P, N), torch.float32), "wgmma": ((B, H, nc, P, N), dtype),
              "wgmma_tiled": ((B, H, nc, 2, P, N), dtype)}[route]  # the last: hi, lo
    out = {"Y": ((B, S, H, P), dtype), "fin": ((B, H, P, N), dtype),
           "states": ((B, H, nc, P, N), torch.float32), "totals": ((B, H, nc), torch.float32),
           "before": before}
    if route == "fma":
        out["scores"] = ((B, H, nc, chunk, chunk) if per_head else (B, nc, chunk, chunk),
                         torch.float32)
    return out


def ssd_cuda(
    X: torch.Tensor,
    la: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,
    out: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Y (B,S,H,P), final state (B,H,P,N)) by a CUDA kernel, both in ``X.dtype``.

    Takes contiguous CUDA tensors on one device: X, B and C of one dtype
    (float32 or bfloat16), la and ``initial_state`` (optional; zeros when
    None) in float32.  The route is :func:`ssd_route`'s; on the
    tensor-core routes X, B and C must also start on 16 bytes (TMA).  Raises
    on anything else, and when a launch fails; it never computes on another
    path.  ``out`` (optional) maps names of :func:`buffers` to contiguous
    tensors of their shape and dtype, which the launch writes instead of
    buffers of its own.
    """
    check_operands(X, la, Bm, Cm, chunk=chunk, initial_state=initial_state)
    route = ssd_route(X.dtype, X.shape[3], Bm.shape[-1], chunk)
    verify_launch(f"ssd:{route}", ssd_cuda, (X, la, Bm, Cm),
                  {"chunk": chunk, "initial_state": initial_state})
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
    if max(B * H * nc * P * (2 if route == "wgmma_tiled" else 1), S * H * max(P, N)) > _INT32_MAX:
        raise ValueError(f"ssd_cuda: dims {(B, S, H, P, N)} exceed int32")
    if route != "fma" and any(t.data_ptr() % 16 for t in (X, Bm, Cm)):
        raise ValueError("ssd_cuda: the tensor-core routes need 16-byte aligned X, B, C")
    lib = _library(route)
    if route == "fma":
        smem = lib.pccl_ssd_smem_bytes(chunk)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"ssd_cuda: (P, N, chunk) = {(P, N, chunk)} needs {smem} bytes of shared "
                f"memory per block, over {SMEM_LIMIT}"
            )
    dev = X.device
    given = dict(out or {})
    bufs = {}
    for name, (shape, dtype) in buffers(X.shape, N, chunk, X.dtype, route,
                                        per_head=Bm.ndim == 4).items():
        t = given.pop(name, None)
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=dev)
        elif (tuple(t.shape) != shape or t.dtype != dtype or t.device != dev
              or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"ssd_cuda: out[{name!r}] must be a contiguous, 16-byte aligned "
                             f"{shape} {dtype} tensor on {dev}")
        bufs[name] = t
    if given:
        raise ValueError(f"ssd_cuda: out has no buffer {sorted(given)} on the {route} route")
    Y, fin, states, totals, before = (bufs[n] for n in ("Y", "fin", "states", "totals", "before"))
    ptrs = (X.data_ptr(), la.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            initial_state.data_ptr() if initial_state is not None else None,
            Y.data_ptr(), fin.data_ptr(), states.data_ptr(), totals.data_ptr(), before.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if route == "wgmma_tiled":
            err = lib.pccl_ssd_sm90_tiled(*ptrs, B, S, H, P, N, int(Bm.ndim == 4), stream)
        elif route == "wgmma":
            err = lib.pccl_ssd_sm90(*ptrs, B, S, H, int(Bm.ndim == 4), stream)
        else:
            err = lib.pccl_ssd(_DTYPES[X.dtype], *ptrs, bufs["scores"].data_ptr(), B, S, H, P, N,
                               chunk, int(Bm.ndim == 4), stream)
    if err != 0:
        raise RuntimeError(f"ssd_cuda: {route} kernel launch failed (error {err})")
    LAUNCHES.record("ssd", route)
    return Y, fin
