"""Plain PyTorch version of K2, RMSNorm × weight: the direct formula.

The same arithmetic as ``repro.kernels.rmsnorm.ref.rmsnorm_reference``, in
fp32, cast to ``x.dtype`` once.  The CPU tests run it; on the card only
``chip_smoke.py`` runs it, to hold the Triton kernel against it.
"""

from __future__ import annotations

import torch


def rmsnorm_reference(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
