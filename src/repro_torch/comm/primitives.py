"""Executable PCCL collectives on rank-stacked tensors.

The counterpart of ``repro.comm.primitives``.  There every rank holds its
local operand on its own device and a round is one ``ppermute``; here the
operand of every collective is the global ``(n, *local)`` tensor — row
``r`` is rank ``r``'s local operand, as in the reference's eager path — and
the result is ``(n, *local_out)``, row ``r`` being rank ``r``'s result.

``execute_schedule`` is the hot path: it hands the schedule to the compiled
engine (:mod:`repro_torch.comm.exec_engine`), which derives all static
per-round tables once.  ``execute_schedule_reference`` and
:func:`run_reference` keep the per-round interpreter, with tables derived
anew per round and an explicit permutation of the gathered payloads, as
the engine's bit-identity oracle.

``all_to_all`` uses the engine's slot-addressed compile — one
``(n, m, blk)`` state instead of the dense origin×target grid — and falls
back to :func:`all_to_all_dense` exactly where the reference does: when
the chunk metadata cannot be slot-addressed.

Every function also takes a ``torch.distributed`` process group as its
last argument, where the reference takes its axis name: the operand is
then this process's local tensor, as inside the reference's
``shard_map``, and the result its local result; each round is one
``dist.batch_isend_irecv`` (:func:`~repro_torch.comm.exec_engine.execute_compiled`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.schedules import Schedule

from .errors import ScheduleExecutionError
from .exec_engine import (
    Wire,
    _ctx,
    compile_all_to_all,
    compile_schedule,
    execute_all_to_all_compact,
    execute_compiled,
    group_rank,
    partners,
    put_diagonal,
    round_tables,
    take_diagonal,
)

Group = Optional[dist.ProcessGroup]


def execute_schedule(chunks: torch.Tensor, schedule: Schedule,
                     group: Group = None) -> torch.Tensor:
    """Run a schedule's rounds on a rank-stacked ``(n, n_chunks, …)`` buffer
    (or, with ``group``, on this process's ``(n_chunks, …)`` buffer).

    Updates ``chunks`` in place and returns it.  Compiles the schedule once
    (process-wide memo) — bit-identical to
    :func:`execute_schedule_reference`.
    """
    return execute_compiled(chunks, compile_schedule(schedule), group)


def execute_schedule_reference(chunks: torch.Tensor, schedule: Schedule,
                               group: Group = None) -> torch.Tensor:
    """Per-round interpreter — the engine's bit-identity oracle.

    Re-derives the static tables every round, gathers each rank's payload,
    permutes the payloads between ranks and scatters (adds) them, with no
    caching or folding.  Returns a new buffer.
    """
    if group is not None:
        return _reference_local(chunks, schedule, group)
    n = schedule.n
    rows = torch.arange(n, device=chunks.device)[:, None]
    chunks = chunks.clone()  # rounds update this copy in place
    for i, rnd in enumerate(schedule.rounds):
        perm, send_ids, recv_ids, reduce = round_tables(rnd, n, ctx=_ctx(schedule, i))
        send = torch.as_tensor(send_ids, dtype=torch.int64, device=chunks.device)
        recv = torch.as_tensor(recv_ids, dtype=torch.int64, device=chunks.device)
        payload = chunks[rows, send]  # (n, k, …): every rank's send
        src_of = [0] * n
        for src, dst in perm:
            src_of[dst] = src
        got = payload[torch.as_tensor(src_of, device=chunks.device)]
        if reduce:
            chunks[rows, recv] = chunks[rows, recv] + got
        else:
            chunks[rows, recv] = got
    return chunks


def _reference_local(chunks: torch.Tensor, schedule: Schedule, group) -> torch.Tensor:
    """The per-round interpreter on this process's local buffer: one
    exchange with the round's partners, then the add or store."""
    chunks = chunks.clone()
    wire = Wire(group, chunks)
    me = wire.me
    for i, rnd in enumerate(schedule.rounds):
        perm, send_ids, recv_ids, reduce = round_tables(rnd, schedule.n, ctx=_ctx(schedule, i))
        dst, src = partners(perm, me)
        send = torch.as_tensor(send_ids[me], dtype=torch.int64, device=chunks.device)
        recv = torch.as_tensor(recv_ids[me], dtype=torch.int64, device=chunks.device)
        got = wire.exchange(chunks[send], dst, src)
        chunks[recv] = chunks[recv] + got if reduce else got
    wire.close()
    return chunks


# --------------------------------------------------------------------------
# Collective wrappers: x is the rank-stacked (n, *local) operand, or with a
# group this process's local operand.
# --------------------------------------------------------------------------


def _split_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rank-stacked ``(S, L, …)`` → ``(S, n, L // n, …)`` (a view)."""
    if x.shape[1] % n:
        raise ScheduleExecutionError(
            f"leading dim {x.shape[1]} not divisible by {n} ranks"
        )
    return x.reshape((x.shape[0], n, x.shape[1] // n) + tuple(x.shape[2:]))


def split_local(x: torch.Tensor, n: int) -> torch.Tensor:
    """A local ``(L, …)`` operand → ``(n, L // n, …)`` (a view)."""
    if x.shape[0] % n:
        raise ScheduleExecutionError(
            f"leading dim {x.shape[0]} not divisible by {n} ranks"
        )
    return x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:]))


def _own(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x``, the buffer the engine updates in place."""
    return x.clone(memory_format=torch.contiguous_format)


def _ranks(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def reduce_scatter(x: torch.Tensor, schedule: Schedule, group: Group = None) -> torch.Tensor:
    """x: ``(n, L, …)``, each rank's full addend.  Returns ``(n, L/n, …)``:
    row ``r`` is rank ``r``'s fully reduced chunk.  With ``group``: x is
    this rank's ``(L, …)`` addend, the return its ``(L/n, …)`` chunk."""
    if group is not None:
        chunks = execute_schedule(split_local(x, schedule.n).clone(), schedule, group)
        return chunks[group_rank(group)]
    # the engine updates its buffer in place: give it a contiguous copy, not x
    compiled = compile_schedule(schedule)
    chunks = execute_compiled(_own(_split_chunks(x, schedule.n)), compiled)
    return take_diagonal(chunks, compiled)


def all_gather(x: torch.Tensor, schedule: Schedule, group: Group = None) -> torch.Tensor:
    """x: ``(n, L, …)``, each rank's shard.  Returns ``(n, n·L, …)``.
    With ``group``: this rank's ``(L, …)`` shard → ``(n·L, …)``."""
    n = schedule.n
    if group is not None:
        chunks = x.new_zeros((n,) + tuple(x.shape))
        chunks[group_rank(group)] = x
        chunks = execute_schedule(chunks, schedule, group)
        return chunks.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    compiled = compile_schedule(schedule)
    chunks = x.new_zeros((x.shape[0], n) + tuple(x.shape[1:]))
    put_diagonal(chunks, compiled, x)
    chunks = execute_compiled(chunks, compiled)
    return chunks.reshape((x.shape[0], n * x.shape[1]) + tuple(x.shape[2:]))


def all_reduce(x: torch.Tensor, schedule: Schedule, group: Group = None) -> torch.Tensor:
    """x: ``(n, L, …)``, each rank's full addend.  Returns the sum over
    ranks in every row.  The schedule must be an all_reduce composition
    (RS rounds + AG rounds).  With ``group``: this rank's ``(L, …)``
    addend → the sum."""
    if group is not None:
        chunks = execute_schedule(split_local(x, schedule.n).clone(), schedule, group)
        return chunks.reshape(x.shape)
    chunks = execute_schedule(_own(_split_chunks(x, schedule.n)), schedule)
    return chunks.reshape(x.shape)


def all_to_all(x: torch.Tensor, schedule: Schedule, group: Group = None) -> torch.Tensor:
    """x: ``(n, n·blk, …)`` where block ``j`` of row ``r`` is rank ``r``'s
    payload for rank ``j``.  Returns ``(n, n·blk, …)`` where block ``j`` of
    row ``r`` is the payload rank ``r`` received from rank ``j``.  With
    ``group``: this rank's ``(n·blk, …)`` blocks → what it received."""
    n = schedule.n
    compact = compile_all_to_all(schedule, n, tuple(range(n)))
    if compact is None:
        return all_to_all_dense(x, schedule, group)
    if group is not None:
        blocks = split_local(x, n).clone()  # (n, blk, …) dest-major
        return execute_all_to_all_compact(blocks, compact, group).reshape(x.shape)
    blocks = _own(_split_chunks(x, n))  # (S, n, blk, …) dest-major
    return execute_all_to_all_compact(blocks, compact).reshape(x.shape)


def run_reference(collective: str, x: torch.Tensor, schedule: Schedule,
                  group: Group = None) -> torch.Tensor:
    """Whole-collective per-round interpreter — the bit-identity oracle.

    The wrappers above over :func:`execute_schedule_reference`, with the
    dense all-to-all state.
    """
    if group is not None:
        return _run_reference_local(collective, x, schedule, group)
    n = schedule.n
    me = _ranks(x)
    if collective == "reduce_scatter":
        chunks = execute_schedule_reference(_split_chunks(x, n), schedule)
        return chunks[me, me]
    if collective == "all_gather":
        chunks = x.new_zeros((x.shape[0], n) + tuple(x.shape[1:]))
        chunks[me, me] = x
        chunks = execute_schedule_reference(chunks, schedule)
        return chunks.reshape((x.shape[0], n * x.shape[1]) + tuple(x.shape[2:]))
    if collective == "all_reduce":
        chunks = execute_schedule_reference(_split_chunks(x, n), schedule)
        return chunks.reshape(x.shape)
    if collective == "all_to_all":
        blocks = _split_chunks(x, n)
        S = x.shape[0]
        state = blocks.new_zeros((S, n, n) + tuple(blocks.shape[2:]))
        state[me, me] = blocks
        flat = state.reshape((S, n * n) + tuple(blocks.shape[2:]))
        flat = execute_schedule_reference(flat, schedule)
        state = flat.reshape((S, n, n) + tuple(blocks.shape[2:]))
        return state[me, :, me].reshape(x.shape)
    raise ScheduleExecutionError(f"unknown collective {collective!r}")


def _run_reference_local(collective: str, x: torch.Tensor, schedule: Schedule,
                         group) -> torch.Tensor:
    n = schedule.n
    me = group_rank(group)
    if collective == "reduce_scatter":
        return execute_schedule_reference(split_local(x, n), schedule, group)[me]
    if collective == "all_gather":
        chunks = x.new_zeros((n,) + tuple(x.shape))
        chunks[me] = x
        chunks = execute_schedule_reference(chunks, schedule, group)
        return chunks.reshape((n * x.shape[0],) + tuple(x.shape[1:]))
    if collective == "all_reduce":
        return execute_schedule_reference(split_local(x, n), schedule, group).reshape(x.shape)
    if collective == "all_to_all":
        return _dense_local(x, schedule, group, execute_schedule_reference)
    raise ScheduleExecutionError(f"unknown collective {collective!r}")


def _dense_local(x: torch.Tensor, schedule: Schedule, group, execute) -> torch.Tensor:
    """This rank's dense all-to-all: ``state[o, t]`` is the block from
    origin ``o`` to target ``t`` it holds (zeros where it holds none)."""
    n = schedule.n
    me = group_rank(group)
    blocks = split_local(x, n)  # (n, blk, …) dest-major
    rest = tuple(blocks.shape[1:])
    state = blocks.new_zeros((n, n) + rest)
    state[me] = blocks
    flat = execute(state.reshape((n * n,) + rest), schedule, group)
    # post-condition: this rank holds (o -> me) for every origin o
    return flat.reshape((n, n) + rest)[:, me].reshape(x.shape)


def all_to_all_dense(x: torch.Tensor, schedule: Schedule, group: Group = None) -> torch.Tensor:
    """Dense-state all-to-all: the fallback and cross-check path.

    Keeps a full n×n-addressable buffer per rank indexed by origin —
    O(n²·blk) memory per rank, but exact for *any* schedule semantics."""
    if group is not None:
        return _dense_local(x, schedule, group, execute_schedule)
    n = schedule.n
    blocks = _split_chunks(x, n)  # (S, n, blk, …) dest-major
    S = x.shape[0]
    me = _ranks(x)
    # state[r, o, t] = block from origin o to target t held by rank r
    # (zeros if not present); initially rank r holds row o = r
    state = blocks.new_zeros((S, n, n) + tuple(blocks.shape[2:]))
    state[me, me] = blocks
    flat = state.reshape((S, n * n) + tuple(blocks.shape[2:]))
    flat = execute_schedule(flat, schedule)
    state = flat.reshape((S, n, n) + tuple(blocks.shape[2:]))
    # post-condition: rank r holds (o -> r) for every origin o
    return state[me, :, me].reshape(x.shape)
