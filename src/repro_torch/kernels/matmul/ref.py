"""Plain PyTorch version of K1, the blocked matmul.

Accumulates one ``block_k`` slice of the contraction at a time into an
fp32 ``(M, N)`` sum, as ``repro.kernels.matmul.kernel._matmul_kernel``
does, and casts to ``x.dtype`` once at the end.  Numerically equivalent to
the CUDA kernel (fp32 accumulation, one cast) but not bit-identical to it:
the order of the sum inside a slice differs.  The CPU tests run it; on
the card only ``chip_smoke.py`` runs it, to hold the kernel against it.
"""

from __future__ import annotations

import torch


def matmul_reference(x: torch.Tensor, w: torch.Tensor, *, block_k: int = 128) -> torch.Tensor:
    K = x.shape[1]
    bk = min(block_k, K)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for k0 in range(0, K, bk):
        # in place: one fp32 (M, N) accumulator for the whole contraction
        acc += x[:, k0:k0 + bk].float() @ w[k0:k0 + bk].float()
    return acc.to(x.dtype)
