"""Entry point of the round kernel: a rank-stacked round, or a table-driven
row copy, on the CUDA kernel or as PyTorch's indexing.

A CUDA buffer goes to the kernel (``kernel.stacked_round_cuda``); a CPU
buffer, and a round whose wire transforms its payload (the ``ring_ef8``
wire's int8 round trip), to the plain version (``ref.py`` and the index
copies below), which is how the engine ran every move before the kernel.
What decides is what the input shows (its device, a transform) and the
round's compile-time ``staged`` flag; nothing else.  The kernel takes a
contiguous buffer and raises on any other: the engine allocates or clones
its buffers contiguous.

A round in place is one launch.  A *staged* round, where some rank's send
and receive slots meet within the round, is two: the payload rows are
gathered into a scratch buffer of the size the indexing path's own gather
allocates, then added or stored from it, so no row is written before every
block has read it.
"""

from __future__ import annotations

import math

import torch

from .kernel import stacked_round_cuda
from .ref import round_reference


def on_card(buf: torch.Tensor) -> bool:
    """Whether the engine's moves on ``buf`` go to the kernel: a CUDA tensor."""
    return buf.device.type == "cuda"


def _slots(t: torch.Tensor) -> torch.Tensor:
    """A view of the contiguous ``t`` as ``(ranks, slots, elements)``."""
    if not t.is_contiguous():
        raise ValueError(f"the round kernel takes a contiguous buffer, got {tuple(t.shape)} "
                         f"of strides {t.stride()}")
    return t.view(t.shape[0], t.shape[1], math.prod(t.shape[2:]))


def stacked_round(buf: torch.Tensor, rows: torch.Tensor, rnd, transform=None) -> str:
    """One round on the rank-stacked ``(n, n_chunks, …)`` buffer, in place;
    returns its route: ``inplace`` or ``staged`` on the kernel, ``torch``
    on the plain version.  ``rnd`` is the engine's ``DeviceRound``."""
    if transform is not None or not on_card(buf):
        round_reference(buf, rows, rnd, transform)
        return "torch"
    n, k = rnd.src_ids.shape
    flat = _slots(buf)
    if not rnd.staged:
        stacked_round_cuda(flat, rnd.src_rows, rnd.src_ids, rnd.recv_ids, n, k, out=flat,
                           reduce=rnd.reduce, route="inplace")
        return "inplace"
    got = torch.empty((n, k, flat.shape[2]), dtype=buf.dtype, device=buf.device)
    stacked_round_cuda(flat, rnd.src_rows, rnd.src_ids, None, n, k, out=got, route="staged")
    stacked_round_cuda(got, None, None, rnd.recv_ids, n, k, out=flat, reduce=rnd.reduce,
                       route="staged")
    return "staged"


def take_rows(buf: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``buf[d, ids[d, j]]`` for every rank ``d`` of the ``(n, n_chunks, …)``
    buffer, as a new ``(n, m, …)`` tensor; ``ids`` is ``(n, m)`` int64."""
    if not on_card(buf):
        ranks = torch.arange(buf.shape[0], device=buf.device)[:, None]
        return buf[ranks, ids]
    n, m = ids.shape
    out = torch.empty((n, m) + tuple(buf.shape[2:]), dtype=buf.dtype, device=buf.device)
    stacked_round_cuda(_slots(buf), None, ids, None, n, m, out=_slots(out), route="copy")
    return out


def put_rows(buf: torch.Tensor, ids: torch.Tensor, values: torch.Tensor) -> None:
    """``buf[d, ids[d, j]] = values[d, j]`` for every rank ``d`` of the
    ``(n, n_chunks, …)`` buffer, in place; ``ids`` is ``(n, m)`` int64 and
    ``values`` ``(n, m, …)``."""
    if not on_card(buf):
        ranks = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[ranks, ids] = values
        return
    n, m = ids.shape
    stacked_round_cuda(_slots(values.contiguous()), None, None, ids, n, m, out=_slots(buf),
                       route="copy")
