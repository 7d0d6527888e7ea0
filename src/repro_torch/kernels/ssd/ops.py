"""Entry points of K4, the SSD scan: the CUDA kernel or its plain version.

:func:`ssd` sends a CUDA tensor to the hand-written kernel
(``kernel.ssd_cuda``), which masks a ragged last chunk, takes an initial
state and reads shared B/C by index, so it runs every shape it accepts and
never gives way to the plain version.  A CPU tensor goes to the plain
version (``ref.py``), because the CPU has no kernel to launch.  Any other
device raises.  Both return the final state in ``X.dtype``, as
``ssd_reference`` does (the reference's Pallas kernel emitted fp32).

Models call :func:`ssd` when ``cfg.use_pallas`` is set and
``ref.ssd_reference`` otherwise; :func:`ssd_decode_step` is plain torch on
every device, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .kernel import check_operands, ssd_cuda
from .ref import ssd_decode_step, ssd_reference


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
