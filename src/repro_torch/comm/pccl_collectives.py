"""Int8-compressed all-reduce with error feedback, rank-stacked.

The counterpart of the compressed half of ``repro.comm.pccl_collectives``:
a ring reduce-scatter with per-hop requantization and a ring all-gather of
the reduced int8 chunks.  Wire bytes drop 4× against fp32 at a
quantization error bounded by each payload's ``max|x| / 127`` per hop,
which the error-feedback residual compensates across steps.

Every operand is the global ``(n, …)`` tensor, row ``r`` being rank
``r``'s buffer.  The quantization scale belongs to one rank's payload (the
reference takes one max over the hop a rank sends), so :func:`_quantize`
reduces over every dim but the rank axis, never over the stacked tensor.

The deprecated ``PcclComm`` shim is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .errors import ScheduleExecutionError

_INV_127 = 1.0 / 127.0  # equals float32(1) / float32(127) once cast to fp32


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank symmetric int8 quantization of a ``(n, …)`` payload.

    ``scale = max|x| / 127 + 1e-30`` over each rank's row, and
    ``round(x / scale)`` rounds half to even as ``jnp.round`` does.  The
    reference's ``/ 127.0`` is compiled by XLA into a multiply by the fp32
    reciprocal of 127 (a division by a constant is folded so), so the scale
    is computed that way here to give the same bits; ``x / scale`` stays a
    division, as it does there.
    """
    dims = tuple(range(1, x.ndim))
    amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs()
    scale = amax * _INV_127 + 1e-30
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_all_reduce(x: torch.Tensor, n: int) -> torch.Tensor:
    """Ring all-reduce over int8 payloads with local accumulation.

    x: rank-stacked ``(n, size)`` flat buffers, ``size`` divisible by n.
    """
    if x.shape[0] != n:
        raise ScheduleExecutionError(
            f"expected a rank-stacked ({n}, size) operand, got {tuple(x.shape)}"
        )
    chunks = x.reshape(n, n, -1)
    me = torch.arange(n, device=x.device)

    # --- reduce-scatter phase: n-1 hops, chunk (me - t - 1) sent onward
    acc = chunks.clone()  # accumulation buffer, updated in place
    send_idx = (me - 1) % n
    src = (me - 1) % n  # the ring's predecessor sends to me
    for _ in range(n - 1):
        q, s = _quantize(acc[me, send_idx])
        q, s = q[src], s[src]
        recv_idx = (send_idx - 1) % n
        acc[me, recv_idx] = acc[me, recv_idx] + _dequantize(q, s).to(acc.dtype)
        send_idx = recv_idx
    # now chunk `me` is fully reduced on rank `me`

    # --- all-gather phase: forward the reduced chunk around the ring in int8
    out = acc
    send_idx = me
    q, s = _quantize(out[me, send_idx])
    for _ in range(n - 1):
        q, s = q[src], s[src]
        recv_idx = (send_idx - 1) % n
        out[me, recv_idx] = _dequantize(q, s).to(out.dtype)
        send_idx = recv_idx
    return out.reshape(x.shape)


@dataclass
class ErrorFeedbackState:
    """Residual carried across steps so quantization error doesn't bias SGD."""

    residual: torch.Tensor

    @staticmethod
    def init(shape, dtype=torch.float32, *, device) -> "ErrorFeedbackState":
        return ErrorFeedbackState(torch.zeros(shape, dtype=dtype, device=device))


def compressed_all_reduce_ef(
    x: torch.Tensor, ef: ErrorFeedbackState, n: int
) -> Tuple[torch.Tensor, ErrorFeedbackState]:
    """Error-feedback wrapper: reduce (x + residual), keep the new residual."""
    target = x + ef.residual
    reduced = compressed_all_reduce(target, n)
    # residual = what we *meant* to send minus what the wire format conveyed.
    # Approximate the conveyed value by re-quantizing locally (unbiased proxy).
    q, s = _quantize(target)
    conveyed = _dequantize(q, s)
    return reduced, ErrorFeedbackState(target - conveyed)
