"""Communicator — executable collectives bound to an axis, a backend and a device.

A :class:`Communicator` is created by :meth:`repro_torch.api.PcclSession.communicator`
and owns *no* planning state of its own: every schedule comes from the
session's plan cache, so all communicators of a session share plans and
fabric-state threading.  It inherits the session's device and raises on an
operand that lies elsewhere.  Its collectives take the rank-stacked
``(axis_size, *local)`` tensor (see :mod:`repro_torch.api.backends`) —
or, when its axis is a ``torch.distributed`` process group
(:attr:`Communicator.process_group`), this process's local operand, as
inside the reference's ``shard_map``.

Process groups (``split``)
--------------------------
``comm.split(colors)`` partitions the axis into equal-sized sub-groups by
color — the hierarchical-mesh pattern (DP×TP): ranks with the same color
form one group, and the returned communicator runs each collective *within
every group simultaneously* (the ``native`` backend sums within each
group's rows; the ``interp`` backend replicates the group-local schedule
across groups so each round stays one full-axis permutation).
Plans are made for the group size, so the planner prices the sub-collective,
not the full axis.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.errors import ScheduleExecutionError
from repro_torch.comm.exec_engine import _LruCache
from repro_torch.core.schedules import Groups, Schedule
from repro_torch.core.schedules import replicate_groups as subgroup_schedule  # noqa: F401 back-compat re-export
from repro_torch.spans import span

from .backends import Backend, get_backend

if TYPE_CHECKING:  # pragma: no cover
    from .session import PcclSession


class Communicator:
    """Collectives over (a partition of) one mesh axis.

    Not constructed directly — use ``session.communicator(...)`` and
    ``Communicator.split``.
    """

    def __init__(
        self,
        session: "PcclSession",
        axis_name: Union[str, dist.ProcessGroup],
        n: int,
        *,
        backend: Union[str, Backend] = "interp",
        algorithm: str = "auto",
        groups: Optional[Groups] = None,
        axis_size: Optional[int] = None,
        rel_error_tol: Optional[float] = None,
    ) -> None:
        self.session = session
        self.axis_name = axis_name
        # one process per rank: the group is the axis, operands are local
        self.process_group: Optional[dist.ProcessGroup] = (
            axis_name if isinstance(axis_name, dist.ProcessGroup) else None
        )
        self.n = n                      # ranks per group (plans use this)
        self.algorithm = algorithm
        # declared error tolerance: lets auto arbitration consider lossy
        # wire-compressed algorithms (see PcclSession.plan)
        self.rel_error_tol = rel_error_tol
        self.groups = groups            # None → the single full-axis group
        self.axis_size = axis_size if axis_size is not None else n
        self.backend: Backend = (
            get_backend(backend) if isinstance(backend, str) else backend
        )
        self.device: torch.device = session.device
        self._local_table: Optional[np.ndarray] = None
        self._local_table_dev: Optional[torch.Tensor] = None
        self._native_subgroup: Optional[dist.ProcessGroup] = None
        # composed full-axis schedules, keyed (fingerprint, buffer_bytes):
        # subgroup_schedule rebuilds every transfer, so the hot path must
        # not pay it (or the fingerprint hash) per call
        self._axis_sched_cache = _LruCache(max_entries=64)
        if groups is not None:
            sizes = {len(g) for g in groups}
            if sizes != {n}:
                raise ValueError(f"unequal group sizes {sizes} (need all == {n})")
            flat = sorted(r for g in groups for r in g)
            if flat != list(range(self.axis_size)):
                raise ValueError("groups must partition the axis exactly once")
        if self.process_group is not None and self.process_group.size() != self.axis_size:
            raise ValueError(
                f"process group of {self.process_group.size()} ranks for an axis of "
                f"{self.axis_size}"
            )

    # ------------------------------------------------------------- planning
    def _schedule(self, collective: str, nbytes: float) -> Schedule:
        """Group-size schedule from the session's (cached) planner."""
        return self.session.plan(
            collective, nbytes, n=self.n, algorithm=self.algorithm,
            rel_error_tol=self.rel_error_tol,
        ).schedule

    def axis_schedule(self, collective: str, nbytes: float) -> Schedule:
        """The executable full-axis schedule (groups composed in).

        Composed schedules are memoized per communicator — the group-local
        fingerprint covers the transfers, ``buffer_bytes`` the sizes — so
        repeated collectives on a split communicator return one object
        (with its fingerprint already memoized) instead of recomposing.
        """
        with span("plan"):
            sched = self._schedule(collective, nbytes)
            if self.groups is None:
                return sched
            key = (sched.fingerprint(), sched.buffer_bytes)
            composed = self._axis_sched_cache.get(key)
            if composed is None:
                composed = subgroup_schedule(sched, self.groups, self.axis_size)
                self._axis_sched_cache.put(key, composed)
            return composed

    def chosen_algorithm(self, collective: str, nbytes: float) -> str:
        return self._schedule(collective, nbytes).algorithm

    def concurrent_request(
        self, collective: str, nbytes: float, *, algorithm: Optional[str] = None
    ):
        """A :class:`~repro_torch.core.pccl.ConcurrentCollectiveRequest` for this
        communicator's process groups, for
        :meth:`~repro_torch.api.session.PcclSession.plan_concurrent` — a split
        communicator contributes its groups (every group runs the collective
        simultaneously), a full-axis one a single domain-spanning group.
        ``nbytes`` is the per-rank buffer size within a group."""
        from repro_torch.core.pccl import ConcurrentCollectiveRequest

        return ConcurrentCollectiveRequest(
            collective,
            float(nbytes),
            groups=self.groups,
            algorithm=algorithm or self.algorithm,
        )

    def estimate(self, collective: str, nbytes: float) -> float:
        """Planned time (seconds) of one collective from the current fabric."""
        return self.session.plan(
            collective, nbytes, n=self.n, algorithm=self.algorithm,
            rel_error_tol=self.rel_error_tol,
        ).cost

    def replan(
        self,
        collective: str,
        nbytes: float,
        *,
        failed_edges: Sequence[Tuple[int, int]] = (),
        failed_ranks: Sequence[int] = (),
    ):
        """Warm-replan this communicator's collective after fabric faults.

        Forwards to :meth:`PcclSession.replan` at this communicator's group
        size: only planner states the failed links/ranks actually touch are
        re-routed (O(affected)), the result is bit-identical to cold-planning
        the degraded fabric, and the session permanently drops the dead
        links for every later plan on this axis.  Edges/ranks are group-local
        indices (the planner's rank space for this communicator)."""
        return self.session.replan(
            collective,
            nbytes,
            n=self.n,
            algorithm=self.algorithm,
            failed_edges=failed_edges,
            failed_ranks=failed_ranks,
        )

    # ----------------------------------------------------------- primitives
    # Every operand is rank-stacked: (axis_size, *local), row r = rank r —
    # or, on a process group, this rank's local operand (the leading axis
    # dropped from each shape below).
    def all_reduce(self, x):
        """x: (S, L, …) per-rank addends → (S, L, …) group sums."""
        return self.backend.all_reduce(self, x)

    def reduce_scatter(self, x):
        """x: (S, n·k, …) per-rank addends → (S, k, …) reduced shards."""
        return self.backend.reduce_scatter(self, x)

    def all_gather(self, x):
        """x: (S, k, …) shards → (S, n·k, …) gathered."""
        return self.backend.all_gather(self, x)

    def all_to_all(self, x):
        """x: (S, n·b, …) destination-major blocks → (S, n·b, …) origin-major."""
        return self.backend.all_to_all(self, x)

    def check_operand(self, x: torch.Tensor) -> None:
        """Raise unless ``x`` is a tensor on this communicator's device."""
        if not isinstance(x, torch.Tensor):
            raise ScheduleExecutionError(
                f"expected a torch.Tensor, got {type(x).__name__}"
            )
        if x.device.type != self.device.type or (
            self.device.index is not None and x.device.index != self.device.index
        ):
            raise ScheduleExecutionError(
                f"operand lies on {x.device}, communicator runs on {self.device}"
            )

    # --------------------------------------------------------------- groups
    def split(self, colors: Sequence[int], *, backend: Optional[str] = None,
              algorithm: Optional[str] = None) -> "Communicator":
        """Partition the axis into same-color sub-groups (MPI comm_split).

        ``colors[i]`` is the color of axis rank ``i``; ranks sharing a color
        form one group and every group runs the collective independently
        (and concurrently).  All groups must end up the same size.

        The parent's backend *instance* is shared by default so stateful
        backends keep one account (e.g. ``sim_elapsed_s`` covers sub-group
        traffic too); pass ``backend="..."`` to get a fresh one instead.

        Resizing is a warm-path event: the sub-communicator plans at the
        new group size through the same session, so its structure cache
        (keyed without ``nbytes``) and any prior plans at that size are
        reused — only a genuinely new (size, fabric, algorithm) combination
        routes, and later faults go through :meth:`replan` incrementally.
        """
        if self.groups is not None:
            raise ValueError("split() on an already-split communicator")
        if len(colors) != self.axis_size:
            raise ValueError(
                f"need one color per axis rank ({self.axis_size}), got {len(colors)}"
            )
        by_color: dict = {}
        for rank, color in enumerate(colors):
            by_color.setdefault(color, []).append(rank)
        groups = tuple(tuple(g) for _, g in sorted(by_color.items()))
        sizes = {len(g) for g in groups}
        if len(sizes) != 1:
            raise ValueError(f"split produced unequal group sizes: {sizes}")
        m = sizes.pop()
        return Communicator(
            self.session,
            self.axis_name,
            m,
            backend=backend if backend is not None else self.backend,
            algorithm=algorithm or self.algorithm,
            groups=groups,
            axis_size=self.axis_size,
            rel_error_tol=self.rel_error_tol,
        )

    def group_fingerprint(self) -> Tuple:
        """Hashable identity of the axis partition (full axis vs. a
        particular split execute differently even when the group-local
        schedule coincides)."""
        if self.groups is None:
            return ("full", self.axis_size)
        return ("split", self.groups)

    def native_group(self) -> dist.ProcessGroup:
        """The process group this rank's ``native`` collectives run on: the
        axis's, or on a split communicator this rank's subgroup, made once
        by every rank of the axis together (in the same order)."""
        if self.groups is None:
            return self.process_group
        if self._native_subgroup is None:
            pg = self.process_group
            glob = [[dist.get_global_rank(pg, r) for r in g] for g in self.groups]
            self._native_subgroup, _ = dist.new_subgroups_by_enumeration(glob)
        return self._native_subgroup

    def local_index_table(self) -> np.ndarray:
        """rank → group-local index, built once and cached on the
        communicator (identity mapping for the full axis).  Grouped
        collectives index this instead of rebuilding the table."""
        if self._local_table is None:
            if self.groups is None:
                table = np.arange(self.axis_size, dtype=np.int32)
            else:
                table = np.zeros(self.axis_size, dtype=np.int32)
                for g in self.groups:
                    for i, rank in enumerate(g):
                        table[rank] = i
            table.flags.writeable = False
            self._local_table = table
        return self._local_table

    def local_index_device_table(self) -> torch.Tensor:
        """The same table as an int64 tensor on the communicator's device,
        uploaded once per communicator (not once per call)."""
        if self._local_table_dev is None:
            self._local_table_dev = torch.as_tensor(
                self.local_index_table().astype(np.int64), device=self.device
            )
        return self._local_table_dev

    def group_of(self, rank: int) -> Tuple[int, ...]:
        """Axis ranks in ``rank``'s group."""
        if self.groups is None:
            return tuple(range(self.axis_size))
        for g in self.groups:
            if rank in g:
                return g
        raise ValueError(f"rank {rank} not on this axis")

    # ------------------------------------------------------------ sim stats
    @property
    def sim_elapsed_s(self) -> float:
        """Accumulated simulated communication time (``sim`` backend only)."""
        return getattr(self.backend, "elapsed_s", 0.0)
