"""Compiled schedule execution engine, rank-stacked on one device.

The numpy half is a copy of ``repro.comm.exec_engine``: one compile pass
derives every round's ``(perm, send_ids, recv_ids, reduce)`` table, folds
consecutive rounds that share a permutation, reduce-flag and chunk count
into one :class:`RoundGroup`, and memoizes the result process-wide by
:meth:`Schedule.fingerprint`; :func:`compile_all_to_all` is the O(n·blk)
slot-addressed all-to-all compile.  Compiling additionally asserts that a
rank's ``recv_ids`` within one round are distinct, which the rank-stacked
scatter below relies on.

Execution is the torch half.  The reference runs one rank per device and
lowers each round to a ``ppermute``; here all ``n`` ranks live on one
device as the leading axis of a global ``(n, n_chunks, *chunk)`` buffer,
and each round is

* a gather of every rank's ``send_ids`` rows, read straight from the
  sending rank (the round's permutation is folded into that gather's row
  index, since ``got[dst] = payload[src]``), then
* a gather–add–scatter (reduce) or a scatter (store) into ``recv_ids``.

Advanced-index gathers and ``index_put_`` without accumulation are used
instead of ``index_add_`` (atomics on CUDA): with distinct ``recv_ids`` per
rank every receiver sees the same adds in the same order as the reference,
so fp32 results are bit-identical to it.  A :class:`RoundGroup` is a Python
loop over its rounds; the per-round index tensors are uploaded to the
device once per ``(CompiledSchedule, device)`` and cached.

**One process per rank.**  Given a ``torch.distributed`` process group,
:func:`execute_compiled` runs the same tables on the rank's *local*
``(n_chunks, …)`` buffer, as the reference's does inside ``shard_map``:
each round gathers ``send_ids[i, me]``, sends it to the rank the round's
permutation names and receives from the rank that sends to ``me``, in one
``dist.batch_isend_irecv``, then adds or stores into ``recv_ids[i, me]``
in the rank-stacked order.  The tables stay row-indexed by the group's
rank (a split communicator's groups are composed into full-group rounds,
never one process group per subgroup).  An identity pair ``(me, me)`` is
a local copy.  Every rank sends and receives exactly once a round:
:func:`round_tables` refuses a round unless all ``n`` ranks send, and ``n``
senders of a permutation have ``n`` distinct receivers, so no rank is ever
left to the zeros ``ppermute`` gives a rank nobody sends to.

The wire is the group's backend's, and :func:`transport_route` names it:
``nccl`` takes device tensors as they are; ``gloo`` takes a CPU tensor as
it is (route ``gloo``) and a CUDA payload through a pinned host buffer
reused across the collective's rounds (route ``gloo-staged``: its
point-to-point calls carry host memory only).  Any other backend, or an
operand the backend cannot carry, raises.  :func:`exec_stats` counts the
rounds by route and the bytes staged through the host.

DTensor's own collectives (the sharded ``Trainer``'s) take the same
``gloo-staged`` route on CUDA tensors inside
:func:`staged_functional_collectives`, which routes the functional
collectives' CUDA kernels through host copies; each call counts as one
round.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.schedules import Round, Schedule
from repro_torch.spans import span

from .errors import ScheduleExecutionError

__all__ = [
    "CompiledSchedule",
    "ExecStats",
    "RoundGroup",
    "clear_exec_caches",
    "compile_all_to_all",
    "compile_schedule",
    "device_tables",
    "exec_stats",
    "execute_all_to_all_compact",
    "execute_compiled",
    "note_fallback_dispatch",
    "note_fused_dispatch",
    "round_tables",
    "transport_route",
]


# ----------------------------------------------------------- round tables


def round_tables(
    rnd: Round, n: int, *, ctx: str = ""
) -> Tuple[List[Tuple[int, int]], np.ndarray, np.ndarray, bool]:
    """Static per-round tables: ``(perm, send_ids[n,k], recv_ids[n,k], reduce)``.

    ``ctx`` prefixes every :class:`ScheduleExecutionError` so compile-time
    failures name the round and schedule they came from.
    """

    def err(msg: str) -> ScheduleExecutionError:
        return ScheduleExecutionError(f"{ctx}{msg}" if ctx else msg)

    if not rnd.is_permutation():
        raise err("round is not a permutation (Tx/Rx > 1)")
    senders = {t.src for t in rnd.transfers}
    if len(senders) != n:
        raise err(f"round must have all {n} ranks sending, got {len(senders)}")
    ks = {len(t.chunks) for t in rnd.transfers}
    if len(ks) != 1:
        raise err(f"non-uniform chunk counts per rank: {ks}")
    k = ks.pop()
    if k == 0:
        raise err("schedule has no chunk metadata (e.g. swing)")
    reduces = {t.reduce for t in rnd.transfers}
    if len(reduces) != 1:
        raise err("mixed reduce/store within one round")
    perm = sorted((t.src, t.dst) for t in rnd.transfers)
    send_ids = np.zeros((n, k), dtype=np.int32)
    recv_ids = np.zeros((n, k), dtype=np.int32)
    for t in rnd.transfers:
        send_ids[t.src] = np.asarray(t.chunks, dtype=np.int32)
        recv_ids[t.dst] = np.asarray(t.chunks, dtype=np.int32)
    for r in range(n):
        if len(set(recv_ids[r].tolist())) != k:
            # the rank-stacked scatter writes each receive slot once; a
            # repeated slot would make the result depend on write order
            raise err(f"rank {r} receives chunk ids {recv_ids[r].tolist()} "
                      "with repeats")
    return perm, send_ids, recv_ids, reduces.pop()


def _ctx(schedule: Schedule, i: int) -> str:
    return (
        f"{schedule.collective}/{schedule.algorithm} "
        f"round {i}/{schedule.num_rounds}: "
    )


# ------------------------------------------------------- compiled schedule


@dataclass(frozen=True)
class RoundGroup:
    """Consecutive rounds sharing ``(perm, reduce, k)``, tables stacked."""

    perm: Tuple[Tuple[int, int], ...]
    reduce: bool
    send_ids: np.ndarray  # (rounds, n, k) int32, read-only
    recv_ids: np.ndarray  # (rounds, n, k) int32, read-only

    @property
    def rounds(self) -> int:
        return self.send_ids.shape[0]


@dataclass(frozen=True)
class CompiledSchedule:
    """A schedule lowered once: validated, stacked, group-folded tables.

    ``final_slots`` is only set by :func:`compile_all_to_all`: row ``r`` maps
    origin (group-local) rank ``o`` to the slot of rank ``r``'s buffer that
    holds the block ``o → r`` after the last round.
    """

    fingerprint: str
    collective: str
    algorithm: str
    n: int  # table rows == schedule.n (the axis span)
    num_rounds: int
    groups: Tuple[RoundGroup, ...]
    final_slots: Optional[np.ndarray] = None  # (n, m) int32 — compact a2a


def _freeze(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


def _fold_groups(
    tables: List[Tuple[List[Tuple[int, int]], np.ndarray, np.ndarray, bool]]
) -> Tuple[RoundGroup, ...]:
    """Stack consecutive rounds with equal (perm, reduce, k) into groups."""
    groups: List[RoundGroup] = []
    i = 0
    while i < len(tables):
        perm, send, recv, reduce = tables[i]
        j = i + 1
        while j < len(tables):
            p2, s2, _, r2 = tables[j]
            if p2 != perm or r2 != reduce or s2.shape != send.shape:
                break
            j += 1
        groups.append(
            RoundGroup(
                perm=tuple(perm),
                reduce=reduce,
                send_ids=_freeze(np.stack([t[1] for t in tables[i:j]])),
                recv_ids=_freeze(np.stack([t[2] for t in tables[i:j]])),
            )
        )
        i = j
    return tuple(groups)


def compile_schedule(schedule: Schedule) -> CompiledSchedule:
    """Lower ``schedule`` to stacked round-group tables (memoized by
    :meth:`Schedule.fingerprint`).

    With ``PCCL_VERIFY=1`` in the environment, every schedule is first run
    through the static chunk-dataflow verifier
    (:func:`repro_torch.analysis.verify.assert_verified`) — a compile-time
    proof of the collective's postcondition — before any table is built, so
    a schedule that fails reaches neither this cache nor the device tables.
    The check runs only on a cache miss (compiles are fingerprint-memoized)
    and the variable is read only on that miss, so the disabled path costs
    nothing.
    """
    with span("plan"):
        fp = schedule.fingerprint()
        cached = _COMPILED.get(fp)
        if cached is not None:
            return cached
        if os.environ.get("PCCL_VERIFY", "0") not in ("", "0"):
            from repro_torch.analysis.verify import assert_verified  # lazy: avoids a cycle

            assert_verified(schedule)
        tables = [
            round_tables(rnd, schedule.n, ctx=_ctx(schedule, i))
            for i, rnd in enumerate(schedule.rounds)
        ]
        compiled = CompiledSchedule(
            fingerprint=fp,
            collective=schedule.collective,
            algorithm=schedule.algorithm,
            n=schedule.n,
            num_rounds=schedule.num_rounds,
            groups=_fold_groups(tables),
        )
        _COMPILED.put(fp, compiled)
        return compiled


# ------------------------------------------------ compact (O(n)) all-to-all


def compile_all_to_all(
    schedule: Schedule, m: int, local_of: Tuple[int, ...]
) -> Optional[CompiledSchedule]:
    """Slot-addressed all-to-all: O(m·blk) state instead of O(m²·blk).

    The dense path keeps an origin×target grid so any set of in-flight
    blocks can coexist; but every generated all-to-all schedule keeps at
    most ``m`` live blocks per rank, so ``m`` slots suffice.  This compile
    statically simulates the chunk metadata: each rank starts holding its
    ``m`` outgoing blocks dest-major (slot ``t`` = block for group-local
    rank ``t``, matching ``x.reshape(m, …)``), each round's sends vacate
    slots and its receives land on free ones (gather-before-scatter, so a
    slot sent from this round can be reused this round), and a final
    ``(len(local_of), m)`` table maps origins to slots for the post-pass
    gather.

    Args:
      schedule: an all_to_all schedule over ``len(local_of)`` ranks with
        group-local chunk ids ``o*m + t`` (full-axis: ``local_of`` is the
        identity and ``m == schedule.n``).
      m: group size (blocks per rank).
      local_of: global rank → group-local index.

    Returns ``None`` whenever the metadata cannot be slot-addressed — a
    sender not holding a chunk it sends, a duplicated live block, a reduce
    round, or an unmet post-condition — in which case callers use the
    dense path.  Memoized by ``(fingerprint, local_of)``; the sentinel for
    "checked, infeasible" is cached too so the simulation runs once.
    """
    with span("plan"):
        n_rows = schedule.n
        if len(local_of) != n_rows:
            raise ScheduleExecutionError(
                f"local_of covers {len(local_of)} ranks, schedule has {n_rows}"
            )
        key = (schedule.fingerprint(), m, tuple(local_of))
        cached = _COMPILED.get(key)
        if cached is not None:
            return None if cached is _INFEASIBLE else cached

        compiled = _compile_all_to_all(schedule, m, tuple(local_of))
        _COMPILED.put(key, _INFEASIBLE if compiled is None else compiled)
        return compiled


def _compile_all_to_all(
    schedule: Schedule, m: int, local_of: Tuple[int, ...]
) -> Optional[CompiledSchedule]:
    n_rows = schedule.n
    # pos[r]: chunk id -> slot, for the blocks rank r currently holds
    pos: List[Dict[int, int]] = [
        {local_of[r] * m + t: t for t in range(m)} for r in range(n_rows)
    ]
    tables = []
    for i, rnd in enumerate(schedule.rounds):
        perm, send_ids, recv_ids, reduce = round_tables(
            rnd, n_rows, ctx=_ctx(schedule, i)
        )
        if reduce:
            return None  # all-to-all never reduces; metadata says otherwise
        k = send_ids.shape[1]
        send_slots = np.zeros((n_rows, k), dtype=np.int32)
        recv_slots = np.zeros((n_rows, k), dtype=np.int32)
        # gather phase: every send leaves its slot (frees it for this
        # round's receive — the executor gathers payloads before scattering)
        for t in rnd.transfers:
            for j, c in enumerate(t.chunks):
                slot = pos[t.src].pop(c, None)
                if slot is None:
                    return None  # sender does not hold this chunk
                send_slots[t.src, j] = slot
        # scatter phase: receives land on free slots, ascending order
        for t in rnd.transfers:
            held = set(pos[t.dst].values())
            free = [s for s in range(m) if s not in held]
            if len(t.chunks) > len(free):
                return None  # more live blocks than slots
            for j, c in enumerate(t.chunks):
                if c in pos[t.dst]:
                    return None  # duplicated live block
                pos[t.dst][c] = free[j]
                recv_slots[t.dst, j] = free[j]
        tables.append((perm, send_slots, recv_slots, False))

    final_slots = np.zeros((n_rows, m), dtype=np.int32)
    for r in range(n_rows):
        for o in range(m):
            slot = pos[r].get(o * m + local_of[r])
            if slot is None:
                return None  # post-condition unmet: block (o -> r) missing
            final_slots[r, o] = slot
    return CompiledSchedule(
        fingerprint=schedule.fingerprint(),
        collective=schedule.collective,
        algorithm=schedule.algorithm,
        n=n_rows,
        num_rounds=schedule.num_rounds,
        groups=_fold_groups(tables),
        final_slots=_freeze(final_slots),
    )


# --------------------------------------------------------------- execution


@dataclass(frozen=True)
class DeviceRound:
    """One round's index tensors on the executing device.

    ``src_rows[d]`` is the rank that sends to rank ``d`` and ``src_ids[d]``
    the chunk ids it sends, so ``buf[src_rows, src_ids]`` is the permuted
    payload every receiver gets; ``recv_ids[d]`` are its receive slots.
    """

    reduce: bool
    src_rows: torch.Tensor  # (n, 1) int64
    src_ids: torch.Tensor   # (n, k) int64
    recv_ids: torch.Tensor  # (n, k) int64


@dataclass(frozen=True)
class DeviceTables:
    rows: torch.Tensor                  # (n, 1) int64: arange(n)
    rounds: Tuple[DeviceRound, ...]
    final_slots: Optional[torch.Tensor]  # (n, m) int64 — compact a2a


def _upload(compiled: CompiledSchedule, device: torch.device) -> DeviceTables:
    n = compiled.n

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    rounds = []
    for grp in compiled.groups:
        src_of = np.zeros(n, dtype=np.int64)
        for src, dst in grp.perm:
            src_of[dst] = src
        for i in range(grp.rounds):
            rounds.append(
                DeviceRound(
                    reduce=grp.reduce,
                    src_rows=dev(src_of[:, None]),
                    src_ids=dev(grp.send_ids[i][src_of]),
                    recv_ids=dev(grp.recv_ids[i]),
                )
            )
    final = None if compiled.final_slots is None else dev(compiled.final_slots)
    return DeviceTables(
        rows=dev(np.arange(n)[:, None]), rounds=tuple(rounds), final_slots=final
    )


def device_tables(compiled: CompiledSchedule, device: torch.device) -> DeviceTables:
    """``compiled``'s round tables on ``device``, uploaded once and cached.

    The rank-stacked counterpart of the reference's per-communicator device
    table upload: a steady-state loop copies no index table to the device.
    """
    with span("plan"):
        key = (id(compiled), str(device))
        hit = _DEVICE_TABLES.get(key)
        # the entry pins its CompiledSchedule, so an id is never reused while
        # its entry lives; the identity check guards against a stale entry
        if hit is not None and hit[0] is compiled:
            return hit[1]
        tables = _upload(compiled, device)
        _DEVICE_TABLES.put(key, (compiled, tables))
        return tables


def apply_round(buf: torch.Tensor, rows: torch.Tensor, rnd: DeviceRound,
                transform=None) -> None:
    """Run one round on the rank-stacked ``(n, n_chunks, …)`` buffer, in place.

    ``transform`` (``None`` or a function of the payload) models the wire,
    e.g. int8 quantization; it sees the sending ranks' payloads in receiver
    order.
    """
    got = buf[rnd.src_rows, rnd.src_ids]  # (n, k, …): gather + permutation
    if transform is not None:
        got = transform(got)
    if rnd.reduce:
        got = buf[rows, rnd.recv_ids] + got
    buf[rows, rnd.recv_ids] = got


def execute_compiled(chunks: torch.Tensor, compiled: CompiledSchedule,
                     group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Run a compiled schedule on a rank-stacked ``(n, n_chunks, …)`` buffer,
    or, given ``group``, on this process's local ``(n_chunks, …)`` buffer.

    Updates ``chunks`` in place (callers hand in a buffer they own, so no
    second copy of the state is made) and returns it.  Bit-identical to the
    per-round reference interpreter: same gathers, same permutation per
    round, same add/store order per receiver.
    """
    if group is not None:
        return _execute_local(chunks, compiled, group)
    if chunks.shape[0] != compiled.n:
        raise ScheduleExecutionError(
            f"buffer has {chunks.shape[0]} ranks, schedule spans {compiled.n}"
        )
    tables = device_tables(compiled, chunks.device)
    row = chunk_bytes(chunks)
    for i, rnd in enumerate(tables.rounds):
        with span("round", chunks, index=i, reduce=rnd.reduce, bytes=rnd.src_ids.numel() * row):
            apply_round(chunks, tables.rows, rnd)
    return chunks


def chunk_bytes(chunks: torch.Tensor) -> int:
    """Bytes of one chunk of a rank-stacked ``(n, n_chunks, …)`` buffer."""
    return math.prod(chunks.shape[2:]) * chunks.element_size()


def execute_all_to_all_compact(
    blocks: torch.Tensor, compiled: CompiledSchedule,
    group: Optional[dist.ProcessGroup] = None,
) -> torch.Tensor:
    """Slot-compiled all-to-all: run the rounds, then gather origin-major.

    ``blocks`` is the rank-stacked ``(n, m, blk, …)`` dest-major buffer, or
    with ``group`` the local ``(m, blk, …)`` one, updated in place; the
    return has the same shape, origin-major.  A process gathers with its
    own row of ``final_slots``.
    """
    out = execute_compiled(blocks, compiled, group)
    if group is not None:
        me = group_rank(group)
        return out[rank_tables(compiled, blocks.device, me).final_slots]
    tables = device_tables(compiled, blocks.device)
    return out[tables.rows, tables.final_slots]


def expected_eager_result_shape(
    collective: str, global_shape: Tuple[int, ...]
) -> Tuple[int, ...]:
    """Result shape of a collective on a rank-stacked ``(n, *local)`` operand.

    Purely structural.  Row ``r`` of the result is rank ``r``'s local
    output, so the leading axis is preserved and only the first local dim
    scales: reduce-scatter splits it ``n`` ways, all-gather concatenates
    ``n`` shards, all-reduce and all-to-all preserve it.
    """
    global_shape = tuple(int(d) for d in global_shape)
    n = global_shape[0]
    if collective in ("all_reduce", "all_to_all"):
        return global_shape
    if collective == "reduce_scatter":
        if len(global_shape) < 2 or n <= 0 or global_shape[1] % n:
            raise ScheduleExecutionError(
                f"reduce_scatter: local leading dim of {global_shape} not "
                f"divisible by axis size {n}"
            )
        return (n, global_shape[1] // n) + global_shape[2:]
    if collective == "all_gather":
        if len(global_shape) < 2:
            raise ScheduleExecutionError(
                f"all_gather: operand {global_shape} has no local dims"
            )
        return (n, global_shape[1] * n) + global_shape[2:]
    raise ScheduleExecutionError(f"unknown collective {collective!r}")


def donation_compatible(collective: str, global_shape: Tuple[int, ...]) -> bool:
    """Could a collective write its result over its operand in place?

    Only when their whole-array footprints coincide: the same
    :class:`~repro_torch.analysis.launch_model.Box` model the kernel lint
    uses, applied at the collective's boundary (the reference's verdicts).
    The engine still copies its operand (``comm/primitives.py``); this is
    the predicate an in-place path would consult.
    """
    from repro_torch.analysis.launch_model import whole_array_box  # lazy: no cycle

    try:
        out_shape = expected_eager_result_shape(collective, global_shape)
    except ScheduleExecutionError:
        return False
    return whole_array_box(tuple(global_shape)) == whole_array_box(out_shape)


# ------------------------------------------------- one process per rank


def group_rank(group: dist.ProcessGroup) -> int:
    """This process's rank in ``group``: the row of every table it reads."""
    return dist.get_rank(group)


def transport_route(group: dist.ProcessGroup, x: torch.Tensor) -> str:
    """The wire ``group``'s rounds take for tensors like ``x``: ``nccl``
    (device tensors as they are), ``gloo`` (a CPU tensor as it is) or
    ``gloo-staged`` (a CUDA tensor through pinned host memory).  Raises for
    any other backend and for an operand the backend cannot carry."""
    backend = str(dist.get_backend(group))
    kind = x.device.type
    if backend == "nccl" and kind == "cuda":
        return "nccl"
    if backend == "gloo" and kind == "cpu":
        return "gloo"
    if backend == "gloo" and kind == "cuda":
        return "gloo-staged"
    raise ScheduleExecutionError(
        f"process group backend {backend!r} carries no {kind} tensor here: "
        "nccl takes CUDA tensors, gloo CPU tensors and CUDA tensors staged "
        "through host memory"
    )


@dataclass(frozen=True)
class RankRound:
    """One round as one rank runs it: whom it sends to and receives from
    (ranks of the group) and its own send and receive slots."""

    reduce: bool
    dst: int
    src: int
    send: torch.Tensor  # (k,) int64
    recv: torch.Tensor  # (k,) int64


@dataclass(frozen=True)
class RankTables:
    rounds: Tuple[RankRound, ...]
    final_slots: Optional[torch.Tensor]  # (m,) int64 — compact a2a


def partners(perm, me: int) -> Tuple[int, int]:
    """``(the rank me sends to, the rank that sends to me)`` in a round's
    permutation of ``(src, dst)`` pairs."""
    return (next(d for s, d in perm if s == me), next(s for s, d in perm if d == me))


def _upload_rank(compiled: CompiledSchedule, device: torch.device, me: int) -> RankTables:
    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    rounds = []
    for grp in compiled.groups:
        dst, src = partners(grp.perm, me)
        for i in range(grp.rounds):
            rounds.append(RankRound(grp.reduce, dst, src, dev(grp.send_ids[i, me]),
                                    dev(grp.recv_ids[i, me])))
    final = None if compiled.final_slots is None else dev(compiled.final_slots[me])
    return RankTables(tuple(rounds), final)


def rank_tables(compiled: CompiledSchedule, device: torch.device, me: int) -> RankTables:
    """Rank ``me``'s row of ``compiled``'s tables on ``device``, uploaded
    once and cached beside the rank-stacked ones."""
    key = (id(compiled), str(device), me)
    hit = _DEVICE_TABLES.get(key)
    if hit is not None and hit[0] is compiled:
        return hit[1]
    tables = _upload_rank(compiled, device, me)
    _DEVICE_TABLES.put(key, (compiled, tables))
    return tables


class Wire:
    """One collective's point-to-point traffic over a process group.

    :meth:`exchange` sends a tensor to one rank of the group and receives a
    tensor of the same shape and dtype from another, in one
    ``dist.batch_isend_irecv``, on the route :func:`transport_route` names
    for ``like``.  The ``gloo-staged`` route copies the payload into a
    pinned host buffer and the received rows back to the device; both
    buffers are allocated at the first round's size and reused by every
    round that fits them.  :meth:`close` adds the rounds and staged bytes
    to :func:`exec_stats`.
    """

    def __init__(self, group: dist.ProcessGroup, like: torch.Tensor) -> None:
        self.group = group
        self.route = transport_route(group, like)
        self.me = group_rank(group)
        self._peers = [dist.get_global_rank(group, r) for r in range(group.size())]
        self.rounds = 0
        self.staged_bytes = 0
        self._host: Dict[torch.dtype, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _staging(self, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        bufs = self._host.get(t.dtype)
        if bufs is None or bufs[0].numel() < t.numel():
            bufs = tuple(torch.empty(t.numel(), dtype=t.dtype, pin_memory=True)
                         for _ in range(2))
            self._host[t.dtype] = bufs
        send, recv = (b[: t.numel()].view(t.shape) for b in bufs)
        return send, recv

    def exchange(self, out: torch.Tensor, dst: int, src: int) -> torch.Tensor:
        """``out`` to rank ``dst``; returns what rank ``src`` sent (``out``
        itself for the identity pair, which moves nothing)."""
        self.rounds += 1
        if dst == self.me:
            return out
        out = out.contiguous()
        if self.route == "gloo-staged":
            send, recv = self._staging(out)
            send.copy_(out)
            self.staged_bytes += 2 * out.numel() * out.element_size()
        else:
            send, recv = out, torch.empty_like(out)
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, self._peers[dst], self.group),
            dist.P2POp(dist.irecv, recv, self._peers[src], self.group),
        ])
        for w in works:
            w.wait()
        if self.route == "gloo-staged":
            return recv.to(out.device)
        return recv

    def close(self) -> None:
        note_rounds(self.route, self.rounds, self.staged_bytes)


# the functional collectives DTensor issues, (op namespace, op name)
_FUNCTIONAL_OPS = (
    ("_c10d_functional", "all_reduce"),
    ("_c10d_functional", "all_gather_into_tensor"),
    ("_c10d_functional", "reduce_scatter_tensor"),
    ("_c10d_functional", "all_to_all_single"),
    ("_c10d_functional", "broadcast"),
    ("_dtensor", "shard_dim_alltoall"),
)


@contextlib.contextmanager
def staged_functional_collectives():
    """Within the block, the functional collectives DTensor issues take CUDA
    tensors over a gloo group through host memory (route ``gloo-staged``):
    the operand is copied to the host, the op's CPU kernel runs and is
    waited on, and the result is copied back.  The block owns the CUDA
    kernels it installs and removes them on exit.  Use it only where the
    group's backend is gloo: a CPU kernel of an NCCL group has no wire."""
    libs = {ns: torch.library.Library(ns, "IMPL") for ns, _ in _FUNCTIONAL_OPS}

    def through_host(ns: str, name: str):
        op = getattr(getattr(torch.ops, ns), name)
        wait = torch.ops._c10d_functional.wait_tensor

        def impl(x, *args):
            host = x.detach().to("cpu")
            out = wait(op(host, *args))
            note_rounds("gloo-staged", 1, host.numel() * host.element_size()
                        + out.numel() * out.element_size())
            return out.to(x.device)

        return impl

    for ns, name in _FUNCTIONAL_OPS:
        libs[ns].impl(name, through_host(ns, name), "CUDA")
    try:
        yield
    finally:
        for lib in libs.values():
            lib._destroy()


def _execute_local(chunks: torch.Tensor, compiled: CompiledSchedule,
                   group: dist.ProcessGroup, encode=None, decode=None) -> torch.Tensor:
    """The rounds on this rank's local buffer.  ``encode`` / ``decode``
    (both or neither) model the wire, e.g. int8 quantization: the payload
    is encoded before the send and decoded after the receive."""
    if group.size() != compiled.n:
        raise ScheduleExecutionError(
            f"process group has {group.size()} ranks, schedule spans {compiled.n}"
        )
    wire = Wire(group, chunks)
    for rnd in rank_tables(compiled, chunks.device, wire.me).rounds:
        payload = chunks[rnd.send]
        if encode is None:
            got = wire.exchange(payload, rnd.dst, rnd.src)
        else:
            got = decode(wire.exchange(encode(payload), rnd.dst, rnd.src))
        if rnd.reduce:
            got = chunks[rnd.recv] + got
        chunks[rnd.recv] = got
    wire.close()
    return chunks


# ------------------------------------------------------- caches & counters


class _LruCache:
    """Lock-guarded bounded LRU with hit/miss/eviction accounting."""

    def __init__(self, max_entries: int) -> None:
        self._store: "OrderedDict[Any, Any]" = OrderedDict()
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        with self._lock:
            val = self._store.get(key)
            if val is not None:
                self.hits += 1
                self._store.move_to_end(key)
            else:
                self.misses += 1
            return val

    def put(self, key, value) -> None:
        with self._lock:
            self._store[key] = value
            self._store.move_to_end(key)
            while len(self._store) > self.max_entries:
                self._store.popitem(last=False)
                self.evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._store.clear()
            self.hits = self.misses = self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


_INFEASIBLE = object()  # cached "slot compile checked and rejected" sentinel

_COMPILED = _LruCache(max_entries=256)  # fingerprint → CompiledSchedule
_DEVICE_TABLES = _LruCache(max_entries=256)  # (compiled, device) → tables

# Overlap counters, filled by repro_torch.comm.fusion: dispatches that
# streamed producer tiles into collective rounds (vs. took the sequential
# fallback), how many chunks were streamed, and how many payload bytes
# moved while later tiles were still pending.
_OVERLAP_LOCK = threading.Lock()
_FUSED_DISPATCHES = 0
_FALLBACK_DISPATCHES = 0
_CHUNKS_STREAMED = 0
_BYTES_HIDDEN = 0
# one process per rank: rounds by route, bytes staged through host memory
_ROUTE_ROUNDS: Dict[str, int] = {}
_STAGED_BYTES = 0


def note_fused_dispatch(chunks_streamed: int, bytes_hidden: int) -> None:
    """Record one fused dispatch and its overlap volume."""
    global _FUSED_DISPATCHES, _CHUNKS_STREAMED, _BYTES_HIDDEN
    with _OVERLAP_LOCK:
        _FUSED_DISPATCHES += 1
        _CHUNKS_STREAMED += int(chunks_streamed)
        _BYTES_HIDDEN += int(bytes_hidden)


def note_fallback_dispatch() -> None:
    """Record one dispatch where fusion was requested but fell back."""
    global _FALLBACK_DISPATCHES
    with _OVERLAP_LOCK:
        _FALLBACK_DISPATCHES += 1


def note_rounds(route: str, rounds: int, staged_bytes: int) -> None:
    """Record one collective's rounds on ``route`` and its staged bytes."""
    global _STAGED_BYTES
    with _OVERLAP_LOCK:
        _ROUTE_ROUNDS[route] = _ROUTE_ROUNDS.get(route, 0) + int(rounds)
        _STAGED_BYTES += int(staged_bytes)


@dataclass(frozen=True)
class ExecStats:
    """Process-wide execution-engine counters (see ``exec_stats()``)."""

    compiled_hits: int
    compiled_misses: int
    compiled_size: int
    device_table_hits: int
    device_table_misses: int
    device_table_size: int
    fused_dispatches: int = 0
    fallback_dispatches: int = 0
    chunks_streamed: int = 0
    bytes_hidden: int = 0
    route_rounds: Tuple[Tuple[str, int], ...] = ()
    staged_bytes: int = 0


def exec_stats() -> ExecStats:
    """Snapshot of the engine's process-wide caches and counters.

    * ``compiled_*`` — the schedule→stacked-tables compile cache.
    * ``device_table_*`` — the per-(compiled schedule, device) index-table
      uploads; a warm steady state only hits.
    * ``fused_*``/``fallback_*``/``chunks_streamed``/``bytes_hidden`` —
      counters from ``repro_torch.comm.fusion`` (see
      :func:`note_fused_dispatch`).
    * ``route_rounds``/``staged_bytes`` — rounds this process ran over a
      process group, by :func:`transport_route`, and the bytes the
      ``gloo-staged`` route copied between device and host (both ways).
    """
    with _OVERLAP_LOCK:
        fused, fallback = _FUSED_DISPATCHES, _FALLBACK_DISPATCHES
        streamed, hidden = _CHUNKS_STREAMED, _BYTES_HIDDEN
        routes, staged = tuple(sorted(_ROUTE_ROUNDS.items())), _STAGED_BYTES
    return ExecStats(
        compiled_hits=_COMPILED.hits,
        compiled_misses=_COMPILED.misses,
        compiled_size=len(_COMPILED),
        device_table_hits=_DEVICE_TABLES.hits,
        device_table_misses=_DEVICE_TABLES.misses,
        device_table_size=len(_DEVICE_TABLES),
        fused_dispatches=fused,
        fallback_dispatches=fallback,
        chunks_streamed=streamed,
        bytes_hidden=hidden,
        route_rounds=routes,
        staged_bytes=staged,
    )


def clear_exec_caches() -> None:
    """Drop compiled and uploaded tables and zero all counters (tests).

    Also clears the ``PCCL_VERIFY=1`` per-launch kernel-lint memo
    (``repro_torch.analysis.kernel_lint``), so tests that toggle the
    variable see no stale verdict — but only when that module is already
    loaded, as the reference does.
    """
    global _FUSED_DISPATCHES, _FALLBACK_DISPATCHES
    global _CHUNKS_STREAMED, _BYTES_HIDDEN, _STAGED_BYTES
    _COMPILED.clear()
    _DEVICE_TABLES.clear()
    with _OVERLAP_LOCK:
        _FUSED_DISPATCHES = _FALLBACK_DISPATCHES = 0
        _CHUNKS_STREAMED = _BYTES_HIDDEN = 0
        _ROUTE_ROUNDS.clear()
        _STAGED_BYTES = 0
    lint = sys.modules.get("repro_torch.analysis.kernel_lint")
    if lint is not None:
        lint.clear_verified_cache()
