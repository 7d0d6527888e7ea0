"""Entry point of K2, RMSNorm × weight: the Triton kernel or its plain version.

A CUDA tensor goes to the Triton kernel (``kernel.rmsnorm_triton``); a CPU
tensor to the plain version (``ref.py``), because the CPU has no kernel to
launch.  Any other device raises.  Both check the same preconditions.
"""

from __future__ import annotations

from typing import Optional

import torch

from .kernel import check_operands, rmsnorm_triton
from .ref import rmsnorm_reference


def rmsnorm(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    eps: float = 1e-5,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Row-wise RMSNorm of ``x`` scaled by ``w``; ``out`` may be ``x``."""
    if x.device.type == "cuda":
        return rmsnorm_triton(x, w, eps=eps, out=out)
    if x.device.type != "cpu" or w.device != x.device:
        raise ValueError(
            f"rmsnorm: operands on {x.device} and {w.device}; need one CUDA "
            "device, or the CPU for the plain version"
        )
    check_operands(x, w)
    y = rmsnorm_reference(x, w, eps=eps)
    if out is None:
        return y
    out.copy_(y)
    return out
