"""Legacy PCCL collective API (deprecation shim) + compressed all-reduce,
rank-stacked.

.. deprecated::
    ``PcclComm`` is a thin shim over the session API — use
    :class:`repro_torch.api.PcclSession` and ``session.communicator(...)``
    instead, which add a shared plan cache, fabric-state threading across
    collectives, ``split()`` sub-groups, and pluggable backends.  The
    reference's ``algorithm="xla"`` string hack maps to ``backend="native"``
    (the port's name for the plain-collective baseline).

Migration::

    # before
    comm = PcclComm(axis_name="data", n=8, hw=cost_model.TPU_V5E_PHOTONIC)
    # after
    session = PcclSession(cost_model.TPU_V5E_PHOTONIC)
    comm = session.communicator("data", 8, backend="interp")

The int8-compressed gradient all-reduce with error feedback lives here too
(not deprecated; it is schedule-independent): a ring reduce-scatter with
per-hop requantization and a ring all-gather of the reduced int8 chunks.
Wire bytes drop 4× against fp32 at a quantization error bounded by each
payload's ``max|x| / 127`` per hop, which the error-feedback residual
compensates across steps.

Every operand is the global ``(n, …)`` tensor, row ``r`` being rank
``r``'s buffer.  The quantization scale belongs to one rank's payload (the
reference takes one max over the hop a rank sends), so :func:`_quantize`
reduces over every dim but the rank axis, never over the stacked tensor.
Given a process group (the reference's ``axis_name``), the compressed
all-reduce takes this rank's local buffer instead and each hop's int8
payload and fp32 scale cross the wire as one message (:func:`pack_int8`).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import cost_model as cm
from repro_torch.core import schedules as S
from repro_torch.core.topology import Topology, ring

from .errors import ScheduleExecutionError


@dataclass
class PcclComm:
    """Deprecated: session-less communicator (see module docstring).

    ``device`` is where its collectives run: CUDA unless the caller asks
    for the CPU, as for every entry point of the port."""

    axis_name: str
    n: int
    hw: cm.HardwareParams = cm.TPU_V5E_PHOTONIC
    g0: Optional[Topology] = None
    algorithm: str = "auto"  # auto | xla | ring | rhd | dex | direct
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self) -> None:
        from repro_torch.core.pccl import SHIM_REMOVAL_VERSION

        warnings.warn(
            f"PcclComm is deprecated and will be removed in repro "
            f"{SHIM_REMOVAL_VERSION}; use repro_torch.api.PcclSession.communicator()"
            f" for execution and PcclSession.submit(PlanRequest(...)) for "
            f"planning (it delegates bit-identically until then)",
            DeprecationWarning,
            stacklevel=2,
        )
        if self.g0 is None:
            self.g0 = ring(self.n)
        from repro_torch.api import PcclSession

        # Legacy behavior: plan every collective cold from g0 (no threading).
        self._session = PcclSession(self.hw, g0=self.g0, thread_fabric=False,
                                    device=self.device)
        self._comm = self._session.communicator(
            self.axis_name,
            self.n,
            backend="native" if self.algorithm == "xla" else "interp",
            algorithm="auto" if self.algorithm == "xla" else self.algorithm,
        )

    # ------------------------------------------------------------- planning
    def _schedule(self, collective: str, nbytes: float) -> S.Schedule:
        return self._comm._schedule(collective, nbytes)

    def chosen_algorithm(self, collective: str, nbytes: float) -> str:
        return self._comm.chosen_algorithm(collective, nbytes)

    # ----------------------------------------------------------- primitives
    # Every operand is rank-stacked: (n, *local), row r = rank r.
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self._comm.all_reduce(x)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, n·k, …) per-rank addends → (n, k, …) reduced shards."""
        return self._comm.reduce_scatter(x)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, k, …) shards → (n, n·k, …) gathered."""
        return self._comm.all_gather(x)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, n·b, …) destination-major blocks → (n, n·b, …) origin-major."""
        return self._comm.all_to_all(x)


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


def pack_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One int8 message: ``q``'s bytes, then the fp32 scale's four bytes."""
    return torch.cat([q.reshape(-1), scale.reshape(1).to(torch.float32).view(torch.int8)])


def unpack_int8(packed: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack_int8`'s inverse: ``(q of shape, the fp32 scale)``, bit for bit."""
    q = packed[:-4].reshape(shape)
    return q, packed[-4:].clone().view(torch.float32).reshape(())


def _compressed_all_reduce_local(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The ring over ``group``: this rank's flat buffer, one message a hop
    to its successor and one from its predecessor."""
    from .exec_engine import Wire

    wire = Wire(group, x)
    me = wire.me
    dst, src = (me + 1) % n, (me - 1) % n
    chunk = x.shape[0] // n
    acc = x.reshape(n, chunk).clone()

    def hop(q, s):
        got = wire.exchange(pack_int8(q, s), dst, src)
        return unpack_int8(got, (chunk,))

    send_idx = (me - 1) % n
    for _ in range(n - 1):
        q, s = _quantize(acc[send_idx][None])
        q, s = hop(q[0], s)
        recv_idx = (send_idx - 1) % n
        acc[recv_idx] = acc[recv_idx] + _dequantize(q, s).to(acc.dtype)
        send_idx = recv_idx
    send_idx = me
    q, s = _quantize(acc[send_idx][None])
    q = q[0]
    for _ in range(n - 1):
        q, s = hop(q, s)
        recv_idx = (send_idx - 1) % n
        acc[recv_idx] = _dequantize(q, s).to(acc.dtype)
        send_idx = recv_idx
    wire.close()
    return acc.reshape(x.shape)


def compressed_all_reduce(x: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """Ring all-reduce over int8 payloads with local accumulation.

    x: rank-stacked ``(n, size)`` flat buffers, ``size`` divisible by n;
    with ``group``, this rank's flat ``(size,)`` buffer.
    """
    if group is not None:
        if x.ndim != 1 or x.shape[0] % n or group.size() != n:
            raise ScheduleExecutionError(
                f"expected this rank's flat buffer divisible by {n} on a group of "
                f"{n}, got {tuple(x.shape)} on {group.size()}"
            )
        return _compressed_all_reduce_local(x, n, group)
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
    x: torch.Tensor, ef: ErrorFeedbackState, n: int, group=None
) -> Tuple[torch.Tensor, ErrorFeedbackState]:
    """Error-feedback wrapper: reduce (x + residual), keep the new residual."""
    target = x + ef.residual
    reduced = compressed_all_reduce(target, n, group)
    # residual = what we *meant* to send minus what the wire format conveyed.
    # Approximate the conveyed value by re-quantizing locally (unbiased proxy).
    q, s = _quantize(target[None] if group is not None else target)
    if group is not None:
        q, s = q[0], s[0]
    conveyed = _dequantize(q, s)
    return reduced, ErrorFeedbackState(target - conveyed)
