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
"""

from __future__ import annotations

import torch

from repro_torch.core.schedules import Schedule

from .errors import ScheduleExecutionError
from .exec_engine import (
    compile_all_to_all,
    compile_schedule,
    execute_all_to_all_compact,
    execute_compiled,
    round_tables,
)


def execute_schedule(chunks: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """Run a schedule's rounds on a rank-stacked ``(n, n_chunks, …)`` buffer.

    Updates ``chunks`` in place and returns it.  Compiles the schedule once
    (process-wide memo) — bit-identical to
    :func:`execute_schedule_reference`.
    """
    return execute_compiled(chunks, compile_schedule(schedule))


def execute_schedule_reference(chunks: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """Per-round interpreter — the engine's bit-identity oracle.

    Re-derives the static tables every round, gathers each rank's payload,
    permutes the payloads between ranks and scatters (adds) them, with no
    caching or folding.  Returns a new buffer.
    """
    n = schedule.n
    rows = torch.arange(n, device=chunks.device)[:, None]
    chunks = chunks.clone()  # rounds update this copy in place
    for i, rnd in enumerate(schedule.rounds):
        ctx = f"{schedule.collective}/{schedule.algorithm} round {i}/{schedule.num_rounds}: "
        perm, send_ids, recv_ids, reduce = round_tables(rnd, n, ctx=ctx)
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


# --------------------------------------------------------------------------
# Collective wrappers: x is the rank-stacked (n, *local) operand.
# --------------------------------------------------------------------------


def _split_chunks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Rank-stacked ``(S, L, …)`` → ``(S, n, L // n, …)`` (a view)."""
    if x.shape[1] % n:
        raise ScheduleExecutionError(
            f"leading dim {x.shape[1]} not divisible by {n} ranks"
        )
    return x.reshape((x.shape[0], n, x.shape[1] // n) + tuple(x.shape[2:]))


def _ranks(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def reduce_scatter(x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """x: ``(n, L, …)``, each rank's full addend.  Returns ``(n, L/n, …)``:
    row ``r`` is rank ``r``'s fully reduced chunk."""
    # the engine updates its buffer in place: give it a copy, not x
    chunks = execute_schedule(_split_chunks(x, schedule.n).clone(), schedule)
    return chunks[_ranks(x), _ranks(x)]


def all_gather(x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """x: ``(n, L, …)``, each rank's shard.  Returns ``(n, n·L, …)``."""
    n = schedule.n
    chunks = x.new_zeros((x.shape[0], n) + tuple(x.shape[1:]))
    chunks[_ranks(x), _ranks(x)] = x
    chunks = execute_schedule(chunks, schedule)
    return chunks.reshape((x.shape[0], n * x.shape[1]) + tuple(x.shape[2:]))


def all_reduce(x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """x: ``(n, L, …)``, each rank's full addend.  Returns the sum over
    ranks in every row.  The schedule must be an all_reduce composition
    (RS rounds + AG rounds)."""
    chunks = execute_schedule(_split_chunks(x, schedule.n).clone(), schedule)
    return chunks.reshape(x.shape)


def all_to_all(x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """x: ``(n, n·blk, …)`` where block ``j`` of row ``r`` is rank ``r``'s
    payload for rank ``j``.  Returns ``(n, n·blk, …)`` where block ``j`` of
    row ``r`` is the payload rank ``r`` received from rank ``j``."""
    n = schedule.n
    compact = compile_all_to_all(schedule, n, tuple(range(n)))
    if compact is None:
        return all_to_all_dense(x, schedule)
    blocks = _split_chunks(x, n).clone()  # (S, n, blk, …) dest-major
    return execute_all_to_all_compact(blocks, compact).reshape(x.shape)


def run_reference(collective: str, x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """Whole-collective per-round interpreter — the bit-identity oracle.

    The wrappers above over :func:`execute_schedule_reference`, with the
    dense all-to-all state.
    """
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


def all_to_all_dense(x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """Dense-state all-to-all: the fallback and cross-check path.

    Keeps a full n×n-addressable buffer per rank indexed by origin —
    O(n²·blk) memory per rank, but exact for *any* schedule semantics."""
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
