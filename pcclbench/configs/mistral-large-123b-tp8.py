"""Plain reference of Mistral-Large-123B's tensor-parallel layer seams.

Every operand is rank-stacked, ``(n, *local)`` with row ``r`` rank ``r``'s
tensor, as the program takes it.  Each function that adds computes in
float32 from the operands as given, one block of rows at a time, and
returns float32; the two that only move data return the operand's type.
Plain torch only: nothing of the program is imported.
"""

from __future__ import annotations

import torch

BLOCK_ROWS = 2048


def _blocks(rows: int):
    for a in range(0, rows, BLOCK_ROWS):
        yield slice(a, min(a + BLOCK_ROWS, rows))


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """``(n, R, C)`` → ``(R, C)``: the sum over ranks, which every rank holds."""
    out = torch.empty(x.shape[1:], dtype=torch.float32, device=x.device)
    for b in _blocks(x.shape[1]):
        out[b] = x[:, b].float().sum(0)
    return out


def reduce_scatter(x: torch.Tensor) -> torch.Tensor:
    """``(n, n·k, C)`` → ``(n, k, C)``: rank ``r`` holds the sum of block ``r``."""
    n, rows = x.shape[:2]
    k = rows // n
    return all_reduce(x).reshape(n, k, *x.shape[2:])


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``(n, k, C)`` → ``(n·k, C)``: the ranks' blocks in rank order, on every rank."""
    return x.reshape(-1, *x.shape[2:])


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """``(n, n·b, C)`` → ``(n, n·b, C)``: block ``q`` of rank ``r``'s result
    is block ``r`` of rank ``q``'s operand."""
    n, rows = x.shape[:2]
    b = rows // n
    return x.reshape(n, n, b, *x.shape[2:]).transpose(0, 1).reshape(x.shape)


def rmsnorm(s: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """Row-wise RMSNorm of ``s`` with weight ``gamma``, in float32."""
    out = torch.empty_like(s, dtype=torch.float32)
    g = gamma.float()
    for b in _blocks(s.shape[0]):
        v = s[b].float()
        out[b] = v * torch.rsqrt(v.pow(2).mean(-1, keepdim=True) + eps) * g
    return out


def all_reduce_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float) -> torch.Tensor:
    """The first seam: RMSNorm of the ranks' summed activations ``(n, T, D)``."""
    return rmsnorm(all_reduce(x), gamma, eps)


def matmul_reduce_scatter(xm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The second seam: ``(n, T, K) @ (K, D)`` on each rank, then the
    reduce-scatter of the products over tokens → ``(n, T / n, D)``."""
    n, T, _ = xm.shape
    k = T // n
    wf = w.float()
    out = torch.zeros((n, k, w.shape[1]), dtype=torch.float32, device=xm.device)
    with _no_tf32():
        for r in range(n):
            for q in range(n):
                out[r] += xm[q, r * k:(r + 1) * k].float() @ wf
    return out


class _no_tf32:
    """Float32 products in float32, not TF32, for as long as the block runs."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
