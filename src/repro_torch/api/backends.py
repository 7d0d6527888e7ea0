"""Pluggable execution backends for :class:`repro_torch.api.Communicator`.

Every backend takes the rank-stacked global ``(axis_size, *local)`` tensor
— row ``r`` is rank ``r``'s local operand in the reference's in-``shard_map``
convention — and returns ``(axis_size, *local_out)``.  Three implementations
of one protocol:

* ``interp`` — the compiled-schedule execution engine
  (``repro_torch.comm.exec_engine`` under ``repro_torch.comm.primitives``):
  every planned round is a gather, a permutation between ranks and a
  scatter(-add) on the stacked tensor, from tables compiled once per
  schedule.  Bit-identical to the reference's ``interp`` backend in fp32.
* ``native`` — the port's stand-in for the reference's ``xla`` backend
  (and registered under that name too): a plain tensor sum, scatter or
  gather over the stacked axis, with no PCCL planning involved; the A/B
  baseline.
* ``sim``    — cost-model-only: data passes through with single-copy
  placeholder semantics while the *planned* time of every collective is
  accumulated on ``elapsed_s``.

On a communicator bound to a ``torch.distributed`` process group
(``comm.process_group``) every backend takes this process's local operand
and returns its local result, as the reference's do inside ``shard_map``:
``interp`` runs each planned round as one ``dist.batch_isend_irecv``
(:func:`repro_torch.comm.exec_engine.execute_compiled`), ``native`` calls
the group's own collective (the counterpart of ``lax.psum`` and its kin
in ``shard_map``; a split communicator's on one subgroup per group).
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, List, Protocol, Tuple, runtime_checkable

import torch
import torch.distributed as dist

from repro_torch.comm.errors import ScheduleExecutionError
from repro_torch.spans import span

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.schedules import Schedule

    from .communicator import Communicator


@runtime_checkable
class Backend(Protocol):
    """Executes the four PCCL primitives for one communicator."""

    name: str

    def all_reduce(self, comm: "Communicator", x): ...

    def reduce_scatter(self, comm: "Communicator", x): ...

    def all_gather(self, comm: "Communicator", x): ...

    def all_to_all(self, comm: "Communicator", x): ...


def _check_local(comm: "Communicator", collective: str, x: torch.Tensor) -> None:
    """On a process group the operand is this rank's local tensor, on the
    communicator's device, with a leading dimension."""
    comm.check_operand(x)
    if x.ndim < 1:
        raise ScheduleExecutionError(f"{collective}: a 0-dim operand has no leading dim")


def _check_stacked(comm: "Communicator", collective: str, x: torch.Tensor) -> None:
    """The operand must be the global ``(axis_size, *local)`` tensor on the
    communicator's device."""
    comm.check_operand(x)
    if x.ndim < 2 or x.shape[0] != comm.axis_size:
        raise ScheduleExecutionError(
            f"{collective}: expected global (axis_size={comm.axis_size},"
            f" *local) operand, got shape {tuple(x.shape)}"
        )


def _check(comm: "Communicator", collective: str, x: torch.Tensor) -> None:
    """:func:`_check_local` on a process group, :func:`_check_stacked` otherwise."""
    if comm.process_group is not None:
        _check_local(comm, collective, x)
    else:
        _check_stacked(comm, collective, x)


def _local_shape(comm, x: torch.Tensor) -> Tuple[int, ...]:
    """One rank's operand shape: ``x``'s own on a process group, a row's
    otherwise."""
    return tuple(x.shape) if comm.process_group is not None else tuple(x.shape[1:])


def _check_divisible(comm, x: torch.Tensor, n: int) -> None:
    """Same local leading-dim precondition (and error) as the interpreter."""
    lead = _local_shape(comm, x)[0]
    if lead % n:
        raise ScheduleExecutionError(
            f"leading dim {lead} not divisible by {n} ranks"
        )


def _eager_nbytes(comm, collective, local_shape, itemsize: int) -> float:
    """The nbytes a collective plans for, from the local operand: all_reduce
    pads the flat buffer to a multiple of ``n``, all_gather moves ``n``
    shards."""
    size = math.prod(local_shape) if local_shape else 1
    if collective == "all_reduce":
        return float(size + ((-size) % comm.n)) * itemsize
    if collective == "all_gather":
        return float(size) * itemsize * comm.n
    return float(size) * itemsize


class InterpBackend:
    """Compiled schedule engine: planned rounds on the rank-stacked tensor."""

    name = "interp"

    def all_reduce(self, comm, x):
        return self._collective(comm, "all_reduce", x)

    def reduce_scatter(self, comm, x):
        return self._collective(comm, "reduce_scatter", x)

    def all_gather(self, comm, x):
        return self._collective(comm, "all_gather", x)

    def all_to_all(self, comm, x):
        return self._collective(comm, "all_to_all", x)

    def _collective(self, comm, collective, x):
        _check(comm, collective, x)
        with span("collective", op=collective, n=comm.n, bytes=x.numel() * x.element_size()) as sp:
            sched = comm.axis_schedule(
                collective,
                _eager_nbytes(comm, collective, _local_shape(comm, x), x.element_size()),
            )
            sp.set(algorithm=sched.algorithm)
            return self._planned(comm, collective, x, sched)

    def _planned(self, comm, collective, x, sched: "Schedule"):
        if collective != "all_reduce":
            return self._run(comm, collective, x, sched)
        if comm.process_group is not None:
            # the reference's trace-path rule on the local buffer
            flat = x.reshape(-1)
            pad = (-flat.shape[0]) % comm.n
            if pad:
                flat = torch.cat([flat, flat.new_zeros((pad,))])
            out = self._run(comm, "all_reduce", flat, sched)
            if pad:
                out = out[: out.shape[0] - pad]
            return out.reshape(x.shape)
        # all_reduce runs on each rank's flat buffer, zero-padded to a
        # multiple of n (the reference's trace-path rule)
        S = x.shape[0]
        flat = x.reshape(S, -1)
        pad = (-flat.shape[1]) % comm.n
        if pad:
            flat = torch.cat([flat, flat.new_zeros((S, pad))], dim=1)
        out = self._run(comm, "all_reduce", flat, sched)
        if pad:
            out = out[:, : out.shape[1] - pad]
        return out.reshape(x.shape)

    # -- dispatch: ungrouped → primitives; grouped → local-rank variants --
    def _run(self, comm, collective, x, sched: "Schedule"):
        from repro_torch.comm import primitives as P

        group = comm.process_group
        if comm.groups is None:
            if collective == "all_reduce" and sched.algorithm == "ring_ef8":
                # planner-selected wire compression: int8 payloads per hop
                from repro_torch.comm.fusion import all_reduce_quantized

                return all_reduce_quantized(x, sched, group)
            return getattr(P, collective)(x, sched, group)
        if group is not None:
            return _grouped_local(comm, collective, x, sched)
        return _grouped_collective(comm, collective, x, sched)


def _grouped_collective(comm: "Communicator", collective: str, x, sched):
    """Group-local collectives on a split communicator.

    The composed schedule routes between global ranks while chunk ids (and
    each rank's buffer) stay group-local; ``me_local[r]`` is rank ``r``'s
    index within its group, from the communicator's numpy table.
    """
    from repro_torch.comm.exec_engine import (
        compile_all_to_all,
        compile_schedule,
        execute_all_to_all_compact,
    )
    from repro_torch.comm.primitives import execute_schedule

    m = comm.n
    S = x.shape[0]
    ranks = torch.arange(S, device=x.device)
    me_local = comm.local_index_device_table()
    rest = tuple(x.shape[2:])
    if collective in ("reduce_scatter", "all_reduce", "all_to_all"):
        _check_divisible(comm, x, m)
    if collective == "reduce_scatter":
        chunks = x.reshape((S, m, x.shape[1] // m) + rest).clone()
        chunks = execute_schedule(chunks, sched)
        return chunks[ranks, me_local]
    if collective == "all_reduce":
        chunks = x.reshape((S, m, x.shape[1] // m) + rest).clone()
        if sched.algorithm == "ring_ef8":
            from repro_torch.comm.fusion import execute_compiled_quantized

            chunks = execute_compiled_quantized(chunks, compile_schedule(sched))
        else:
            chunks = execute_schedule(chunks, sched)
        return chunks.reshape(x.shape)
    if collective == "all_gather":
        chunks = x.new_zeros((S, m) + tuple(x.shape[1:]))
        chunks[ranks, me_local] = x
        chunks = execute_schedule(chunks, sched)
        return chunks.reshape((S, m * x.shape[1]) + rest)
    if collective == "all_to_all":
        blocks = x.reshape((S, m, x.shape[1] // m) + rest).clone()
        local_of = tuple(int(v) for v in comm.local_index_table())
        compact = compile_all_to_all(sched, m, local_of)
        if compact is not None:
            return execute_all_to_all_compact(blocks, compact).reshape(x.shape)
        # dense fallback: O(m²·blk) origin×target state per rank
        state = blocks.new_zeros((S, m, m) + tuple(blocks.shape[2:]))
        state[ranks, me_local] = blocks
        flat = state.reshape((S, m * m) + tuple(blocks.shape[2:]))
        flat = execute_schedule(flat, sched)
        state = flat.reshape((S, m, m) + tuple(blocks.shape[2:]))
        return state[ranks, :, me_local].reshape(x.shape)
    raise ScheduleExecutionError(f"unknown collective {collective!r}")


def _grouped_local(comm: "Communicator", collective: str, x, sched):
    """:func:`_grouped_collective` as one process of the axis runs it: the
    reference's in-``shard_map`` body, with this rank's group-local index
    and the composed full-axis schedule over the axis's process group."""
    from repro_torch.comm.exec_engine import (
        compile_all_to_all,
        compile_schedule,
        execute_all_to_all_compact,
        group_rank,
    )
    from repro_torch.comm.primitives import execute_schedule, split_local

    group = comm.process_group
    m = comm.n
    me_local = int(comm.local_index_table()[group_rank(group)])
    if collective in ("reduce_scatter", "all_reduce", "all_to_all"):
        _check_divisible(comm, x, m)
    if collective == "reduce_scatter":
        chunks = execute_schedule(split_local(x, m).clone(), sched, group)
        return chunks[me_local]
    if collective == "all_reduce":
        chunks = split_local(x, m).clone()
        if sched.algorithm == "ring_ef8":
            from repro_torch.comm.fusion import execute_compiled_quantized

            chunks = execute_compiled_quantized(chunks, compile_schedule(sched), group)
        else:
            chunks = execute_schedule(chunks, sched, group)
        return chunks.reshape(x.shape)
    if collective == "all_gather":
        chunks = x.new_zeros((m,) + tuple(x.shape))
        chunks[me_local] = x
        chunks = execute_schedule(chunks, sched, group)
        return chunks.reshape((m * x.shape[0],) + tuple(x.shape[1:]))
    if collective == "all_to_all":
        blocks = split_local(x, m).clone()
        local_of = tuple(int(v) for v in comm.local_index_table())
        compact = compile_all_to_all(sched, m, local_of)
        if compact is not None:
            return execute_all_to_all_compact(blocks, compact, group).reshape(x.shape)
        # dense fallback: O(m²·blk) origin×target state
        rest = tuple(blocks.shape[1:])
        state = blocks.new_zeros((m, m) + rest)
        state[me_local] = blocks
        flat = execute_schedule(state.reshape((m * m,) + rest), sched, group)
        return flat.reshape((m, m) + rest)[:, me_local].reshape(x.shape)
    raise ScheduleExecutionError(f"unknown collective {collective!r}")


class NativeBackend:
    """Plain tensor collectives over the stacked axis (the A/B baseline).

    The stand-in for the reference's ``xla`` backend: a sum, scatter or
    gather over each group's rows, with no PCCL schedule.  Sums run in
    PyTorch's own order (fp32 accumulation for bf16 on CUDA), so results
    agree with ``interp`` within rounding, not bit for bit.
    """

    name = "native"

    @staticmethod
    def _groups(comm) -> List[Tuple[int, ...]]:
        if comm.groups is None:
            return [tuple(range(comm.axis_size))]
        return [tuple(g) for g in comm.groups]

    def all_reduce(self, comm, x):
        _check(comm, "all_reduce", x)
        if comm.process_group is not None:
            out = x.clone()
            dist.all_reduce(out, group=comm.native_group())
            return out
        out = torch.empty_like(x)
        for g in self._groups(comm):
            idx = torch.tensor(g, device=x.device)
            out[idx] = x[idx].sum(dim=0, keepdim=True).to(x.dtype)
        return out

    def reduce_scatter(self, comm, x):
        _check(comm, "reduce_scatter", x)
        _check_divisible(comm, x, comm.n)
        if comm.process_group is not None:
            out = x.new_empty((x.shape[0] // comm.n,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x.contiguous(), group=comm.native_group())
            return out
        blk = x.shape[1] // comm.n
        out = x.new_empty((x.shape[0], blk) + tuple(x.shape[2:]))
        for g in self._groups(comm):
            total = x[torch.tensor(g, device=x.device)].sum(dim=0).to(x.dtype)
            for i, r in enumerate(g):
                out[r] = total[i * blk:(i + 1) * blk]
        return out

    def all_gather(self, comm, x):
        _check(comm, "all_gather", x)
        if comm.process_group is not None:
            out = x.new_empty((comm.n * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x.contiguous(), group=comm.native_group())
            return out
        out = x.new_empty((x.shape[0], comm.n * x.shape[1]) + tuple(x.shape[2:]))
        for g in self._groups(comm):
            idx = torch.tensor(g, device=x.device)
            out[idx] = x[idx].reshape((1, -1) + tuple(x.shape[2:]))
        return out

    def all_to_all(self, comm, x):
        _check(comm, "all_to_all", x)
        _check_divisible(comm, x, comm.n)
        if comm.process_group is not None:
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x.contiguous(), group=comm.native_group())
            return out
        m = comm.n
        blocks = x.reshape((x.shape[0], m, x.shape[1] // m) + tuple(x.shape[2:]))
        out = torch.empty_like(blocks)
        for g in self._groups(comm):
            idx = torch.tensor(g, device=x.device)
            # out[g[t], o] = blocks[g[o], t]: a transpose within the group
            out[idx] = blocks[idx].transpose(0, 1)
        return out.reshape(x.shape)


class SimBackend:
    """Cost-model-only execution: accumulate planned time, pass data through.

    Tensors in, tensors out, with the shapes of the real backends but
    single-copy placeholder values: ``all_reduce``/``all_to_all`` return the
    input, ``reduce_scatter`` returns each rank's first ``L // n`` rows
    (only the shape is meaningful), and ``all_gather`` tiles each rank's
    shard ``n`` times.  The planned time of each collective, priced from
    the local operand, accumulates on ``elapsed_s``.  Shape preconditions
    raise the same :class:`~repro_torch.comm.errors.ScheduleExecutionError`
    as the ``interp`` backend.
    """

    name = "sim"

    def __init__(self) -> None:
        self.elapsed_s = 0.0
        self.events: List[Tuple[str, float, float]] = []  # (coll, nbytes, cost)

    def _charge(self, comm, collective, x) -> None:
        nbytes = _eager_nbytes(comm, collective, _local_shape(comm, x), x.element_size())
        cost = comm.estimate(collective, nbytes)
        self.elapsed_s += cost
        self.events.append((collective, float(nbytes), cost))

    def all_reduce(self, comm, x):
        _check(comm, "all_reduce", x)
        self._charge(comm, "all_reduce", x)
        return x

    def reduce_scatter(self, comm, x):
        _check(comm, "reduce_scatter", x)
        _check_divisible(comm, x, comm.n)
        self._charge(comm, "reduce_scatter", x)
        if comm.process_group is not None:
            return x[: x.shape[0] // comm.n]
        return x[:, : x.shape[1] // comm.n]

    def all_gather(self, comm, x):
        _check(comm, "all_gather", x)
        self._charge(comm, "all_gather", x)
        if comm.process_group is not None:
            return x.repeat((comm.n,) + (1,) * (x.ndim - 1))
        return x.repeat((1, comm.n) + (1,) * (x.ndim - 2))

    def all_to_all(self, comm, x):
        _check(comm, "all_to_all", x)
        _check_divisible(comm, x, comm.n)
        self._charge(comm, "all_to_all", x)
        return x


# "xla", the reference's name for its compiler-collective backend, selects
# the port's stand-in for it
_BACKENDS = {"native": NativeBackend, "xla": NativeBackend, "interp": InterpBackend,
             "sim": SimBackend}


def get_backend(name: str) -> Backend:
    """Fresh backend instance by name (``interp`` | ``native`` | ``xla``,
    the same as ``native`` | ``sim``)."""
    try:
        return _BACKENDS[name]()
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_BACKENDS)}"
        ) from None


def register_backend(name: str, cls) -> None:
    """Extension point: register a custom Backend implementation."""
    _BACKENDS[name] = cls
