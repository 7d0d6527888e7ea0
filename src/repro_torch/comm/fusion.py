"""Comm/compute fusion seams on rank-stacked tensors.

The counterpart of ``repro.comm.fusion``, with the same three seams:

**Producer side: tile-streaming matmul + reduce-scatter**
  (:func:`fused_matmul_reduce_scatter`).  :func:`stream_program` (numpy,
  copied) turns a ring reduce-scatter's compiled tables into a per-rank
  chunk compute order and proves it feasible; the fused loop then computes
  tile ``order[:, s]`` of every rank and runs round ``s - 1``, so a round
  starts as soon as the tiles it touches are stored.  Each step computes
  all ranks' tiles in **one** K1 launch on the gathered ``(n·Mc, K)`` rows;
  rows are independent in K1, so this is bit-identical to per-rank calls,
  and the whole loop is bit-identical to the unfused whole-``M`` kernel
  followed by the collective.  Rounds run on the current stream, in order.

**Consumer side: RMSNorm at all-reduce arrival**
  (:func:`fused_all_reduce_rmsnorm`).  K2 runs on the all-reduce's own
  output buffer, in place, so the normalization needs no second
  activation-sized buffer.  Row-wise RMSNorm commutes with how the buffer
  is chunked, so this is bit-identical to all_reduce → K2.

**Wire-compressed collectives** (:func:`execute_compiled_quantized`,
  :func:`all_reduce_quantized`): the ``ring_ef8`` algorithm, every hop's
  payload quantized to int8 plus one fp32 scale per sending rank.

Both fused entry points keep the reference's routing: a grouped
communicator, chunk rows that do not divide, blocks that do not tile, or
a schedule with no stream program take the unfused kernel-then-collective
path; every dispatch is counted (``exec_engine.note_fused_dispatch`` /
``note_fallback_dispatch``).  Both paths launch the kernels on CUDA.

On a communicator bound to a process group every entry point takes this
process's local operand, as the reference's does inside ``shard_map``:
the stream program computes one tile of K1 a step and runs its round
over the group; K2 normalizes the all-reduce's arrival in place; the
int8 wire quantizes a payload before its send and dequantizes it after
the receive, with the bits of the rank-stacked transform.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.comm.errors import ScheduleExecutionError
from repro_torch.spans import span

from . import exec_engine
from .exec_engine import CompiledSchedule

__all__ = [
    "StreamProgram",
    "all_reduce_quantized",
    "execute_compiled_quantized",
    "fused_all_reduce_rmsnorm",
    "fused_matmul_reduce_scatter",
    "stream_program",
]


# ------------------------------------------------------- stream programs


@dataclass(frozen=True)
class StreamProgram:
    """Joint (tile, round) program for a streamable reduce-scatter.

    ``order[r]`` is rank ``r``'s chunk *compute order*: tile ``order[r, 0]``
    is computed in the prologue, then step ``s`` computes tile
    ``order[r, s]`` and runs round ``s-1``.  ``send``/``recv`` are the
    compiled tables with the (always 1 here) chunk axis squeezed.
    """

    perm: Tuple[Tuple[int, int], ...]
    order: np.ndarray  # (n, n_chunks) int32 — per-rank compute order
    send: np.ndarray   # (rounds, n) int32
    recv: np.ndarray   # (rounds, n) int32

    @property
    def rounds(self) -> int:
        return self.send.shape[0]


_STREAM_LOCK = threading.Lock()
_STREAM_PROGRAMS: dict = {}  # fingerprint -> StreamProgram | None
_STREAM_MAX = 64


def stream_program(compiled: CompiledSchedule) -> Optional[StreamProgram]:
    """Derive the per-rank tile order that lets rounds start early.

    A schedule is *streamable* when tiles can be produced one per step and
    every round still only touches chunk slots whose tile is already
    stored.  Requirements (ring reduce-scatter satisfies all of them;
    anything else returns ``None`` and callers run unfused):

    * one reducing :class:`~repro_torch.comm.exec_engine.RoundGroup` with
      one chunk per rank per round (``k == 1``) over ``n`` chunks in
      ``n - 1`` rounds (the loop pairs one fresh tile with one round);
    * per rank, sorting chunks by *deadline* — the first round that sends
      the chunk or accumulates into it (``n - 1`` for untouched chunks) —
      yields an order in which at most ``t + 2`` chunks are needed by the
      end of round ``t`` (prologue tile + one tile per step).

    The deadline check is exact, not heuristic: it is precisely the
    condition under which the fused loop is bit-identical to unfused
    execution (no round observes an unset slot).  Memoized by schedule
    fingerprint, including the ``None`` verdict.
    """
    with span("plan"):
        fp = compiled.fingerprint
        with _STREAM_LOCK:
            if fp in _STREAM_PROGRAMS:
                return _STREAM_PROGRAMS[fp]
        prog = _stream_program(compiled)
        with _STREAM_LOCK:
            if len(_STREAM_PROGRAMS) >= _STREAM_MAX:
                _STREAM_PROGRAMS.clear()
            _STREAM_PROGRAMS[fp] = prog
        return prog


def _stream_program(compiled: CompiledSchedule) -> Optional[StreamProgram]:
    if len(compiled.groups) != 1:
        return None
    grp = compiled.groups[0]
    rounds, n, k = grp.send_ids.shape
    if not grp.reduce or k != 1:
        return None
    n_chunks = int(max(grp.send_ids.max(), grp.recv_ids.max())) + 1
    if n_chunks != n or rounds != n_chunks - 1:
        return None
    send = grp.send_ids[:, :, 0]  # (rounds, n)
    recv = grp.recv_ids[:, :, 0]
    order = np.zeros((n, n_chunks), dtype=np.int32)
    for r in range(n):
        deadline = np.full(n_chunks, rounds, dtype=np.int64)
        for t in range(rounds - 1, -1, -1):
            deadline[send[t, r]] = t
            deadline[recv[t, r]] = t
        rank_order = np.argsort(deadline, kind="stable")
        # feasibility: by the time round t runs, t + 2 tiles are stored
        need = np.zeros(rounds, dtype=np.int64)
        for c in range(n_chunks):
            if deadline[c] < rounds:
                need[deadline[c]] += 1
        if (np.cumsum(need) > np.arange(rounds) + 2).any():
            return None
        order[r] = rank_order.astype(np.int32)
    return StreamProgram(
        perm=grp.perm,
        order=order,
        send=np.ascontiguousarray(send),
        recv=np.ascontiguousarray(recv),
    )


# -------------------------------------- producer fusion: matmul → reduce-scatter


def fused_matmul_reduce_scatter(
    comm,
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    block_m: int = 128,
    block_n: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """``reduce_scatter(x_r @ w)`` with rounds streamed between the tiles.

    Args:
      comm: interp-backend :class:`~repro_torch.api.Communicator`.
      x: ``(axis_size, M, K)`` — row ``r`` is rank ``r``'s local activation.
      w: ``(K, N)`` replicated weight.

    Returns ``(axis_size, M // n, N)``: row ``r`` is rank ``r``'s fully
    reduced output shard ``sum_q (x_q @ w)[r·Mc : (r+1)·Mc]``.

    Takes the fused tile-streaming path when the communicator is
    ungrouped, ``M`` divides into ``n`` chunk rows, the (clipped) blocks
    tile each ``(Mc, K, N)`` chunk exactly, and the planned schedule
    admits a :func:`stream_program`; otherwise falls back to the unfused
    kernel-then-collective composition (identical result).
    """
    from repro_torch.kernels.matmul.ops import tiles_exactly

    comm.check_operand(x)
    comm.check_operand(w)
    local = comm.process_group is not None
    if local and x.ndim != 2:
        raise ScheduleExecutionError(
            f"expected this rank's (M, K) operand, got shape {tuple(x.shape)}"
        )
    if not local and (x.ndim != 3 or x.shape[0] != comm.axis_size):
        raise ScheduleExecutionError(
            f"expected global (axis_size={comm.axis_size}, M, K) operand, "
            f"got shape {tuple(x.shape)}"
        )
    if w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ScheduleExecutionError(
            f"weight shape {tuple(w.shape)} does not match x {tuple(x.shape)}"
        )
    n = comm.n
    M, K = x.shape[-2:]
    N = w.shape[1]
    blocks = (block_m, block_n, block_k)

    # bytes: the product x @ w that the reduce-scatter reduces
    with span("collective", op="mm_rs", n=n, bytes=x.numel() // K * N * x.element_size()) as sp:
        prog = None
        if comm.groups is None and M % n == 0 and tiles_exactly(
            M // n, K, N, block_m=block_m, block_n=block_n, block_k=block_k
        ):
            sched = comm.axis_schedule(
                "reduce_scatter", float(M) * N * x.element_size()
            )
            sp.set(algorithm=sched.algorithm)
            prog = stream_program(exec_engine.compile_schedule(sched))
        if prog is None:
            return _unfused_matmul_reduce_scatter(comm, x, w, blocks=blocks)

        if local:
            out = _fused_mm_rs_local(prog, x, w, blocks, comm.process_group)
        else:
            out = _fused_mm_rs(prog, x, w, blocks)
        Mc = M // n
        # every round but the last runs with later tiles still pending
        exec_engine.note_fused_dispatch(
            chunks_streamed=n,
            bytes_hidden=comm.axis_size * max(0, prog.rounds - 1) * Mc * N
            * x.element_size(),
        )
        return out


def _unfused_matmul_reduce_scatter(comm, x, w, *, blocks):
    """Sequential fallback: whole-M kernel dispatch, then the collective."""
    from repro_torch.kernels.matmul.ops import matmul

    M, K = x.shape[-2:]
    y = matmul(x.reshape(-1, K), w, block_k=blocks[2])
    y = y.reshape(tuple(x.shape[:-1]) + (w.shape[1],))
    exec_engine.note_fallback_dispatch()
    return comm.reduce_scatter(y)


def _fused_mm_rs(prog: StreamProgram, x, w, blocks):
    """The joint (tile, round) loop of the stream program, all ranks at once."""
    from repro_torch.kernels.matmul.ops import matmul

    S, M, K = x.shape
    n = prog.order.shape[1]
    Mc = M // n
    N = w.shape[1]
    dev = x.device
    xc = x.reshape(S, n, Mc, K)

    def dev_table(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.int64), device=dev)

    with span("plan"):
        ranks = torch.arange(S, device=dev)
        src_of = np.zeros(S, dtype=np.int64)
        for src, dst in prog.perm:
            src_of[dst] = src
        order = dev_table(prog.order)  # (S, n)
        src_rows = dev_table(src_of)   # (S,)
        send = dev_table(prog.send)    # (rounds, S)
        recv = dev_table(prog.recv)

    def tiles(s: int) -> torch.Tensor:
        """Every rank's tile ``order[r, s]`` in one kernel launch."""
        rows = xc[ranks, order[:, s]].reshape(S * Mc, K)  # (S·Mc, K) gathered
        return matmul(rows, w, block_k=blocks[2]).reshape(S, Mc, N)

    buf = torch.empty((S, n, Mc, N), dtype=x.dtype, device=dev)
    row = S * exec_engine.chunk_bytes(buf)
    with span("tile", x, step=0):
        buf[ranks, order[:, 0]] = tiles(0)
    for s in range(1, n):
        with span("tile", x, step=s):
            buf[ranks, order[:, s]] = tiles(s)  # tile order[:, s] is done …
        t = s - 1  # … so round t, which only touches stored tiles, runs now
        with span("round", x, index=t, reduce=True, bytes=row, route="torch"):
            got = buf[src_rows, send[t, src_rows]]
            buf[ranks, recv[t]] = buf[ranks, recv[t]] + got
    return buf[ranks, ranks]


def _fused_mm_rs_local(prog: StreamProgram, x, w, blocks, group):
    """The stream program as one process runs it: K1 on one ``(Mc, K)``
    tile a step, then the round that tile completes, over ``group``."""
    from repro_torch.kernels.matmul.ops import matmul

    M, K = x.shape
    n = prog.order.shape[1]
    Mc = M // n
    wire = exec_engine.Wire(group, x)
    me = wire.me
    dst, src = exec_engine.partners(prog.perm, me)
    order = prog.order[me].tolist()
    xc = x.reshape(n, Mc, K)
    buf = torch.empty((n, Mc, w.shape[1]), dtype=x.dtype, device=x.device)
    buf[order[0]] = matmul(xc[order[0]], w, block_k=blocks[2])
    for s in range(1, n):
        buf[order[s]] = matmul(xc[order[s]], w, block_k=blocks[2])
        t = s - 1
        got = wire.exchange(buf[int(prog.send[t, me])], dst, src)
        r = int(prog.recv[t, me])
        buf[r] = buf[r] + got
    wire.close()
    return buf[me]


# -------------------------------- consumer fusion: all-reduce → rmsnorm


def fused_all_reduce_rmsnorm(
    comm,
    x: torch.Tensor,
    gamma: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """``rmsnorm(all_reduce(x), gamma)`` with K2 on the all-reduce's buffer.

    ``x`` is the global ``(axis_size, *local)`` operand (``local[-1] ==
    gamma.shape[0]``); the return keeps the leading axis.  Bit-identical to
    ``comm.all_reduce(x)`` followed by K2.

    Falls back to the two-step composition when the communicator is
    grouped or the flattened local size is not divisible by ``n`` (the
    unfused all_reduce pads).
    """
    from repro_torch.comm import primitives as prims
    from repro_torch.kernels.rmsnorm.ops import rmsnorm

    comm.check_operand(x)
    comm.check_operand(gamma)
    group = comm.process_group
    if group is None and (x.ndim < 2 or x.shape[0] != comm.axis_size):
        raise ScheduleExecutionError(
            f"expected global (axis_size={comm.axis_size}, *local) operand "
            f"with a feature axis, got shape {tuple(x.shape)}"
        )
    if gamma.ndim != 1 or x.ndim < 1 or x.shape[-1] != gamma.shape[0]:
        raise ScheduleExecutionError(
            f"gamma shape {tuple(gamma.shape)} does not match x feature axis "
            f"{tuple(x.shape)}"
        )
    local_size = math.prod(x.shape if group is not None else x.shape[1:])
    with span("collective", op="ar_rmsnorm", n=comm.n, bytes=x.numel() * x.element_size()) as sp:
        if comm.groups is not None or local_size % comm.n:
            exec_engine.note_fallback_dispatch()
            return rmsnorm(comm.all_reduce(x), gamma, eps=eps)

        sched = comm.axis_schedule("all_reduce", float(local_size) * x.element_size())
        sp.set(algorithm=sched.algorithm)
        if group is not None:
            red = prims.all_reduce(x.reshape(-1), sched, group).reshape(x.shape)
        else:
            red = prims.all_reduce(x.reshape(x.shape[0], -1), sched).reshape(x.shape)
        # in place: the normalization writes over the all-reduce's own buffer
        out = rmsnorm(red, gamma, eps=eps, out=red)
        # consumer-side fusion: no producer tiles streamed
        exec_engine.note_fused_dispatch(chunks_streamed=0, bytes_hidden=0)
        return out


# -------------------------------------- wire-compressed (int8) execution


def execute_compiled_quantized(chunks: torch.Tensor, compiled: CompiledSchedule,
                               group=None) -> torch.Tensor:
    """:func:`~repro_torch.comm.exec_engine.execute_compiled` with int8 wire.

    Identical gather/permute/scatter structure, but every hop's payload is
    quantized to int8 with one fp32 scale per sending rank
    (``max|payload| / 127``) and dequantized on arrival — 4x less wire
    traffic, which is what the ``ring_ef8`` schedule's ``Round.size * 0.25``
    prices.  Lossy: per hop the round-trip error is at most ``scale / 2``;
    the accumulated bound is
    ``repro_torch.core.cost_model.compressed_ef_error_bound``.  Updates
    ``chunks`` in place and returns it.  With ``group``, ``chunks`` is this
    rank's local buffer and the int8 payload and its scale cross the wire
    as one message (:func:`~repro_torch.comm.pccl_collectives.pack_int8`).
    """
    from .pccl_collectives import _dequantize, _quantize, pack_int8, unpack_int8

    if group is not None:
        def encode(payload: torch.Tensor) -> torch.Tensor:
            q, scale = _quantize(payload[None])  # one scale for the payload
            return pack_int8(q[0], scale)

        def decode(packed: torch.Tensor) -> torch.Tensor:
            q, scale = unpack_int8(packed, tuple(chunks.shape[1:]))
            return _dequantize(q, scale).to(chunks.dtype)

        return exec_engine._execute_local(chunks, compiled, group, encode, decode)

    def wire(payload: torch.Tensor) -> torch.Tensor:
        # rows are already in receiver order; each row's scale is its
        # sender's, as in quantize-then-permute
        q, scale = _quantize(payload)
        return _dequantize(q, scale).to(chunks.dtype)

    tables = exec_engine.device_tables(compiled, chunks.device)
    row = exec_engine.chunk_bytes(chunks)
    for i, rnd in enumerate(tables.rounds):
        with span("round", chunks, index=i, reduce=rnd.reduce, bytes=rnd.src_ids.numel() * row,
                  wire="int8") as sp:
            sp.set(route=exec_engine.apply_round(chunks, tables.rows, rnd, transform=wire))
    return chunks


def all_reduce_quantized(x: torch.Tensor, schedule, group=None) -> torch.Tensor:
    """int8-on-the-wire all_reduce — the executable form of ``ring_ef8``.

    Same contract as :func:`repro_torch.comm.primitives.all_reduce` (``x``
    is the rank-stacked ``(n, L, …)`` addend, or with ``group`` this rank's
    ``(L, …)`` one), with rounds run through :func:`execute_compiled_quantized`.
    """
    from .primitives import _split_chunks, split_local

    compiled = exec_engine.compile_schedule(schedule)
    if group is not None:
        chunks = split_local(x, schedule.n).clone()
    else:
        chunks = _split_chunks(x, schedule.n).clone()
    return execute_compiled_quantized(chunks, compiled, group).reshape(x.shape)
