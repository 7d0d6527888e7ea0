"""Entry points of K4, the SSD scan: the CUDA kernel or its plain version.

:func:`ssd` sends a CUDA tensor to the hand-written kernel
(``kernel.ssd_cuda``), which masks a ragged last chunk, takes an initial
state and reads shared B/C by index, so it runs every shape it accepts and
never gives way to the plain version.  A CPU tensor goes to the plain
version (``ref.py``), because the CPU has no kernel to launch, and autograd
differentiates it directly.  Any other device raises.  When a gradient can
flow, a CUDA call goes through :class:`~repro_torch.kernels.autograd.PlainGradient`:
the kernel runs forward, and the backward is ``ssd_reference``'s autograd
(the reference has no backward kernel) for X, la, B, C and the initial
state, with no gradient taken through a final state nobody reads.  Both
return the final state in ``X.dtype``, as ``ssd_reference`` does (the
reference's Pallas kernel emitted fp32).

Models call :func:`ssd` when ``cfg.use_pallas`` is set and
``ref.ssd_reference`` otherwise; :func:`ssd_decode_step` is plain torch on
every device, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.autograd import PlainGradient, needs_grad

from .kernel import check_operands, ssd_cuda
from .ref import ssd_decode_step, ssd_reference


def _kernel(X, la, Bm, Cm, initial_state, *, chunk):
    return ssd_cuda(X, la, Bm, Cm, chunk=chunk, initial_state=initial_state)


def _plain(X, la, Bm, Cm, initial_state, *, chunk):
    return ssd_reference(X, la, Bm, Cm, chunk=chunk, initial_state=initial_state)


def ssd(
    X: torch.Tensor,
    la: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int = 64,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if X.device.type == "cuda":
        if initial_state is not None:
            initial_state = initial_state.float()  # the reference's astype(f32)
        if needs_grad(X, la, Bm, Cm, initial_state):
            return PlainGradient.apply(_kernel, _plain, {"chunk": chunk},
                                       X, la, Bm, Cm, initial_state)
        return ssd_cuda(X, la, Bm, Cm, chunk=chunk, initial_state=initial_state)
    ops = [la, Bm, Cm] + ([initial_state] if initial_state is not None else [])
    if X.device.type != "cpu" or any(t.device != X.device for t in ops):
        raise ValueError(
            f"ssd: operands on {[str(t.device) for t in [X] + ops]}; need one CUDA "
            "device, or the CPU for the plain version"
        )
    check_operands(X, la, Bm, Cm, chunk=chunk, initial_state=initial_state)
    return ssd_reference(X, la, Bm, Cm, chunk=chunk, initial_state=initial_state)


__all__ = ["ssd", "ssd_decode_step"]
