"""The round kernel on the card: wrapper of ``csrc/rounds.cu``.

:func:`stacked_round_cuda` runs one table-driven row move on rank-stacked
``(ranks, slots, elements)`` operands: for each pair ``(d, j)`` of ``n × k``
(receiver, slot), row ``(src_ranks[d], src_ids[d, j])`` of ``src`` is added
into (``reduce``) or stored over row ``(d, dst_ids[d, j])`` of ``out``.  The
tables are the engine's own (rank, slot) tables; a table of ``None`` is the
identity (rank ``d``, slot ``j``).  Both operands are contiguous and of one
dtype and row length; ``out`` may be ``src`` (a round in place).  The row
moves in units of 16 bytes where the row's bytes and both bases allow, else
one element at a time (:func:`unit_of`).

It replaces no TPU kernel (the JAX package leaves a round's gather and
scatter to XLA) and no kernel of the port: it takes the place of PyTorch's
advanced-index gather, add and ``index_put_`` in the engine's rank-stacked
rounds (``repro_torch.comm.exec_engine``).  A store moves any dtype; a
reduce takes the floating dtypes the engine's callers hand it (float32,
float64, float16, bfloat16) and int32 and int64, and raises on any other.
The library is built with ``nvcc`` for ``sm_90a`` at first launch and
launched on PyTorch's current stream.
:data:`~repro_torch.kernels.build.LAUNCHES` counts its launches under
``"round"`` by the mode of the round the launch belongs to: ``inplace``
(one pass on the buffer), ``staged`` (each of the two launches of a round
through a scratch buffer) and ``copy`` (the engine's other index copies).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.build import GEOMETRY_ARGTYPES, LAUNCHES, verify_launch

SOURCE = Path(__file__).resolve().parent / "csrc" / "rounds.cu"
ROUTES = ("inplace", "staged", "copy")
#: the library's op code of a reduce in each dtype (0 is a store)
ADD_OPS = {torch.float32: 1, torch.float64: 2, torch.float16: 3, torch.bfloat16: 4,
           torch.int32: 5, torch.int64: 6}
_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z


def unit_of(row_bytes: int, element_size: int, *pointers: int) -> int:
    """Bytes a thread moves at once: 16 where the row's bytes and every base
    pointer are multiples of 16, else one element."""
    if row_bytes % 16 == 0 and all(p % 16 == 0 for p in pointers):
        return 16
    return element_size


def op_of(dtype: torch.dtype, reduce: bool) -> int:
    """The library's op code: 0 for a store, the dtype's add otherwise."""
    if not reduce:
        return 0
    if dtype not in ADD_OPS:
        raise ValueError(
            f"stacked_round_cuda: no reduce in {dtype}; the kernel adds "
            f"{', '.join(str(d).rsplit('.', 1)[1] for d in ADD_OPS)}"
        )
    return ADD_OPS[dtype]


def _library() -> ctypes.CDLL:
    from repro_torch.kernels.build import load

    lib = load(SOURCE)
    fn = lib.pccl_stacked_round
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    geometry = lib.pccl_stacked_round_geometry
    geometry.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                         ctypes.c_int, *GEOMETRY_ARGTYPES]
    fn.restype = geometry.restype = ctypes.c_int
    return lib


def _check_table(name: str, t: Optional[torch.Tensor], entries: int, device) -> None:
    if t is None:
        return
    if (t.dtype != torch.int64 or t.device != device or t.numel() != entries
            or not t.is_contiguous()):
        raise ValueError(f"stacked_round_cuda: {name} must be a contiguous int64 table of "
                         f"{entries} entries on {device}")


def _pointer(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stacked_round_cuda(
    src: torch.Tensor,
    src_ranks: Optional[torch.Tensor],
    src_ids: Optional[torch.Tensor],
    dst_ids: Optional[torch.Tensor],
    n: int,
    k: int,
    *,
    out: torch.Tensor,
    reduce: bool = False,
    route: str = "copy",
) -> torch.Tensor:
    """Move ``n × k`` rows of ``src`` into ``out`` by their tables, in one
    launch; returns ``out``.

    ``src`` and ``out`` are contiguous 3-D ``(ranks, slots, elements)`` CUDA
    tensors of one dtype and row length.  ``src_ranks`` (``n`` entries),
    ``src_ids`` and ``dst_ids`` (``n · k``) are contiguous int64 tables on
    the same device, or ``None`` for the identity.  A thread moves
    :func:`unit_of` bytes at once.  ``route`` names the launch in
    :data:`~repro_torch.kernels.build.LAUNCHES`.  The tables' entries are
    trusted: the engine proves at compile time that a round's receive slots
    are distinct per rank, and in range of the buffer it was compiled for.
    """
    if route not in ROUTES:
        raise ValueError(f"stacked_round_cuda: route {route!r} is not one of {ROUTES}")
    if src.ndim != 3 or out.ndim != 3 or src.shape[2] != out.shape[2]:
        raise ValueError(f"stacked_round_cuda: need (ranks, slots, elements) operands of one "
                         f"row length, got {tuple(src.shape)} and {tuple(out.shape)}")
    if src.dtype != out.dtype:
        raise ValueError(f"stacked_round_cuda: operands of {src.dtype} and {out.dtype}")
    op = op_of(src.dtype, reduce)
    if not (0 < n <= _GRID_YZ and 0 < k <= _GRID_YZ):
        raise ValueError(f"stacked_round_cuda: {n} receivers x {k} slots; each must be "
                         f"1 to {_GRID_YZ}")
    size = src.element_size()
    row_bytes = src.shape[2] * size
    unit = unit_of(row_bytes, size, src.data_ptr(), out.data_ptr())
    # the gate's memo keys on shapes: a launch one element a thread is named apart
    label = f"round:{route}" if unit == 16 else f"round:{route}:{unit}B"
    verify_launch(label, stacked_round_cuda, (src, src_ranks, src_ids, dst_ids, n, k),
                  {"out": out, "reduce": reduce})
    if src.device.type != "cuda" or out.device != src.device:
        raise ValueError(f"stacked_round_cuda: need both operands on one CUDA device, got "
                         f"{src.device} and {out.device}")
    if not (src.is_contiguous() and out.is_contiguous()):
        raise ValueError("stacked_round_cuda: operands must be contiguous")
    _check_table("src_ranks", src_ranks, n, src.device)
    _check_table("src_ids", src_ids, n * k, src.device)
    _check_table("dst_ids", dst_ids, n * k, src.device)
    if (src_ranks is None and src.shape[0] < n or src_ids is None and src.shape[1] < k
            or out.shape[0] < n or dst_ids is None and out.shape[1] < k):
        raise ValueError(f"stacked_round_cuda: identity tables need {n} ranks of {k} slots, "
                         f"got {tuple(src.shape)} and {tuple(out.shape)}")
    if row_bytes == 0:
        return out
    lib = _library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.pccl_stacked_round(
            op, unit, src.data_ptr(), out.data_ptr(), _pointer(src_ranks), _pointer(src_ids),
            _pointer(dst_ids), src.shape[1], out.shape[1], row_bytes // unit, n, k, stream,
        )
    if err != 0:
        raise RuntimeError(f"stacked_round_cuda: launch failed (error {err})")
    LAUNCHES.record("round", route)
    return out
