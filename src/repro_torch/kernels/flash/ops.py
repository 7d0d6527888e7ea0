"""Entry point of K3, flash attention: the CUDA kernel or its plain version.

A CUDA tensor goes to the hand-written kernel (``kernel.flash_attention_cuda``),
which masks ragged edges, so it runs every shape it accepts and never gives
way to the plain version.  A CPU tensor goes to the plain version
(``ref.py``), because the CPU has no kernel to launch.  Any other device
raises.  The reference's Pallas block sizes have no counterpart: the CUDA
kernel's tiles are fixed in its source, and its result depends on no block
size.
"""

from __future__ import annotations

import torch

from .kernel import check_operands, flash_attention_cuda
from .ref import attention_reference


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Softmax(q kᵀ/√D) v with GQA, causal by default; output in ``q.dtype``."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type != "cpu" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention: operands on {q.device}, {k.device}, {v.device}; need "
            "one CUDA device, or the CPU for the plain version"
        )
    check_operands(q, k, v, causal=causal)
    return attention_reference(q, k, v, causal=causal)
