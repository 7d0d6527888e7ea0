"""Entry point of K1, the blocked matmul: the CUDA kernel or its plain version.

A CUDA tensor goes to a hand-written kernel (``kernel.matmul_cuda``):
bf16 with K and N multiples of 8 to the tensor-core kernel (wgmma, TMA),
everything else to the CUDA-core kernel (fp32 FMA), as
``kernel.tensor_core_route`` decides from dtype, K and N.  Both mask ragged
edges, so every shape runs and nothing gives way to the plain version.  A CPU tensor goes to the plain version (``ref.py``),
because the CPU has no kernel to launch.  Any other device raises.

``block_k`` sets the contraction slice of the plain version.  The CUDA
kernels' tiles are fixed in their sources, and each one's per-element sum
runs over the whole contraction in order, so its result depends on no
block size and on no M.
:func:`tiles_exactly` is kept only as the fusion layer's routing predicate
(``repro_torch.comm.fusion``), as in the reference.
"""

from __future__ import annotations

import torch

from .kernel import check_operands, matmul_cuda
from .ref import matmul_reference


def tiles_exactly(
    M: int, K: int, N: int,
    *, block_m: int = 128, block_n: int = 128, block_k: int = 128,
) -> bool:
    """True iff the (clipped) blocks tile ``(M, K, N)`` with no remainder."""
    if M == 0 or K == 0 or N == 0:
        return False
    bm, bk, bn = min(block_m, M), min(block_k, K), min(block_n, N)
    return not (M % bm or K % bk or N % bn)


def matmul(x: torch.Tensor, w: torch.Tensor, *, block_k: int = 128) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation, output in ``x.dtype``."""
    if x.device.type == "cuda":
        return matmul_cuda(x, w)
    if x.device.type != "cpu" or w.device != x.device:
        raise ValueError(
            f"matmul: operands on {x.device} and {w.device}; need one CUDA "
            "device, or the CPU for the plain version"
        )
    check_operands(x, w)
    return matmul_reference(x, w, block_k=block_k)
