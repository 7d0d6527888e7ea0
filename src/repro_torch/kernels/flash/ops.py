"""Entry point of K3, flash attention: the CUDA kernel or its plain version.

A CUDA tensor goes to a hand-written kernel (``kernel.flash_attention_cuda``):
bf16 with D a multiple of 16 up to 128 to the tensor-core kernel (wgmma,
TMA), everything else to the CUDA-core kernel (fp32 FMA), as
``kernel.tensor_core_route`` decides from dtype and D.  Both mask ragged
edges, so every shape they accept runs and nothing gives way to the plain
version.  A CPU tensor goes to the plain version (``ref.py``), because
the CPU has no kernel to launch, and autograd differentiates it directly.
Any other device raises.  When a gradient can flow, a CUDA call goes
through :class:`~repro_torch.kernels.autograd.PlainGradient`: the kernel
runs forward, and the backward is the plain version's autograd (the
reference has no backward kernel).  The reference's Pallas block sizes
have no counterpart: the CUDA kernels' tiles are fixed in their sources,
and their results depend on no block size.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.autograd import PlainGradient, needs_grad

from .kernel import check_operands, flash_attention_cuda
from .ref import attention_reference


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True
) -> torch.Tensor:
    """Softmax(q kᵀ/√D) v with GQA, causal by default; output in ``q.dtype``."""
    if q.device.type == "cuda":
        if needs_grad(q, k, v):
            return PlainGradient.apply(flash_attention_cuda, attention_reference,
                                       {"causal": causal}, q, k, v)
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.device.type != "cpu" or k.device != q.device or v.device != q.device:
        raise ValueError(
            f"flash_attention: operands on {q.device}, {k.device}, {v.device}; need "
            "one CUDA device, or the CPU for the plain version"
        )
    check_operands(q, k, v, causal=causal)
    return attention_reference(q, k, v, causal=causal)
