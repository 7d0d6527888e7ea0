"""Fault tolerance: failure injection, link failures, straggler detection.

A port of ``repro.runtime.fault``.  On a real fleet these hooks attach to
the coordinator's heartbeat service; here the *policies* are implemented
and tested against simulated signals.  The elastic half,
:func:`shrink_mesh` and :func:`reshard_tree`, works on a
``torch.distributed`` :class:`DeviceMesh` of one process per rank: a
smaller mesh without the failed slices, and the live tree re-placed onto
it.  Both are collective over the *old* mesh: every rank, the failed ones
included, calls them in the same order (a mesh's process groups are made
by all ranks together, and the re-shard reads each tensor whole on the
old mesh, which assumes the failed slice is still readable, as the
reference's check does).
"""

from __future__ import annotations

import collections
import math
import statistics
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.api.session import PcclSession
    from repro_torch.core.pccl import PcclPlan


# ----------------------------------------------------------- failure inject
class InjectedFailure(RuntimeError):
    pass


@dataclass(frozen=True)
class LinkFailure:
    """A fabric fault event: physical links (both directions die) and/or
    whole ranks (every incident link dies).  The unit handed to
    :func:`replan_after_failure` by whoever detects the fault — the
    heartbeat service on a real fleet, :class:`FailureInjector` in tests."""

    edges: Tuple[Tuple[int, int], ...] = ()
    ranks: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if not self.edges and not self.ranks:
            raise ValueError("LinkFailure needs at least one edge or rank")


def replan_after_failure(
    session: "PcclSession",
    failure: LinkFailure,
    collective: str,
    nbytes: float,
    *,
    n: int = None,
    algorithm: str = "paper_default",
) -> "PcclPlan":
    """Turn a fault event into a warm replan: the session re-prices only
    the states the failure touched (O(affected), bit-identical to a cold
    plan of the degraded fabric) and permanently drops the dead links from
    its fabric/standard views.  See :meth:`PcclSession.replan`."""
    return session.replan(
        collective,
        nbytes,
        n=n,
        algorithm=algorithm,
        failed_edges=failure.edges,
        failed_ranks=failure.ranks,
    )


def fail_link(target: Any, u: int, v: int, *, n: int = None) -> LinkFailure:
    """Kill the physical link ``u — v`` (both directions) mid-stream.

    ``target`` is either a :class:`~repro_torch.serve.arbiter.FabricArbiter`
    (anything with ``on_fault``) — the serving control plane warm-replans
    and keeps ticking on the degraded fabric — or a bare
    :class:`~repro_torch.api.PcclSession`, which is degraded via
    :func:`replan_after_failure` on a representative all-reduce.  Returns
    the injected :class:`LinkFailure` so tests can assert on it.
    """
    failure = LinkFailure(edges=((u, v),))
    on_fault = getattr(target, "on_fault", None)
    if on_fault is not None:
        on_fault(failure)
    else:
        replan_after_failure(target, failure, "all_reduce", 4096.0, n=n)
    return failure


@dataclass
class FailureInjector:
    """Deterministic failure schedule: raise at the given steps (tests) —
    stands in for hardware events the trainer must survive."""

    fail_at_steps: Sequence[int] = ()
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


# --------------------------------------------------------------- stragglers
@dataclass
class StragglerConfig:
    window: int = 20              # rolling window of step times
    threshold: float = 2.0        # flag hosts slower than τ × median
    min_samples: int = 5


class StragglerDetector:
    """Per-host step-time tracking with τ×median flagging.

    Mitigation is the caller's choice (the trainer supports: rebalance data
    grains toward fast hosts, or evict + elastic re-mesh)."""

    def __init__(self, cfg: StragglerConfig, n_hosts: int):
        self.cfg = cfg
        self.times: Dict[int, collections.deque] = {
            h: collections.deque(maxlen=cfg.window) for h in range(n_hosts)
        }

    def record(self, host: int, step_time: float) -> None:
        self.times[host].append(step_time)

    def host_medians(self) -> Dict[int, float]:
        return {
            h: statistics.median(ts) for h, ts in self.times.items() if len(ts) >= self.cfg.min_samples
        }

    def stragglers(self) -> List[int]:
        med = self.host_medians()
        if len(med) < 2:
            return []
        global_med = statistics.median(med.values())
        return [h for h, m in med.items() if m > self.cfg.threshold * global_med]

    def rebalance_grains(self, total_grains: int) -> Dict[int, int]:
        """Assign data grains inversely proportional to median step time —
        the soft mitigation that keeps stragglers in the job."""
        med = self.host_medians()
        if not med:
            n = len(self.times)
            return {h: total_grains // n for h in range(n)}
        inv = {h: 1.0 / m for h, m in med.items()}
        z = sum(inv.values())
        alloc = {h: max(1, int(round(total_grains * w / z))) for h, w in inv.items()}
        # fix rounding drift
        drift = total_grains - sum(alloc.values())
        for h in sorted(alloc, key=lambda h: -inv[h]):
            if drift == 0:
                break
            alloc[h] += 1 if drift > 0 else -1
            drift += -1 if drift > 0 else 1
        return alloc


# ------------------------------------------------------------------ elastic
def shrink_mesh(mesh: DeviceMesh, failed_ranks: Sequence[int], axes: Tuple[str, ...],
                shrink_axis: str) -> DeviceMesh:
    """Rebuild a smaller mesh without the failed ranks by dropping whole
    slices along ``shrink_axis`` (TPU practice: evict the failed host's
    slice, keep the topology regular).  ``failed_ranks`` are global ranks;
    ``axes`` names the new mesh's dimensions.  Every rank of ``mesh`` calls
    it (the new mesh's groups are made by all of them, in order); a failed
    rank gets the mesh too, with no coordinate in it."""
    ranks = mesh.mesh
    axis = list(mesh.mesh_dim_names).index(shrink_axis)
    failed = set(int(r) for r in failed_ranks)
    keep = [i for i in range(ranks.shape[axis])
            if not failed.intersection(ranks.select(axis, i).flatten().tolist())]
    if not keep:
        raise RuntimeError("all slices contain failed devices")
    new = ranks.index_select(axis, torch.tensor(keep))
    return DeviceMesh(mesh.device_type, new, mesh_dim_names=tuple(axes))


def _map_tree(fn, tree, placed):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, placed[k] if placed is not None else None)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, torch.Tensor):
        return type(tree)(_map_tree(fn, v, placed[i] if placed is not None else None)
                          for i, v in enumerate(tree))
    return fn(tree, placed)


def reshard_tree(tree: Any, old_placements: Any, new_mesh: DeviceMesh) -> Any:
    """Re-shard a live tree onto a shrunk mesh, keeping each sharded
    dimension's mesh axes where they still divide it and replicating it
    otherwise (fit-or-drop).  ``old_placements`` mirrors ``tree`` with a
    :class:`~repro_torch.sharding.partition.Sharding` (the reference's
    ``NamedSharding``) or ``None`` (replicated) per leaf.  Each leaf is read
    whole on the old mesh, a collective every rank of it joins."""
    from repro_torch.sharding.partition import Sharding, placements

    sizes = dict(zip(new_mesh.mesh_dim_names, new_mesh.mesh.shape))

    def move(x, sh):
        spec = sh.spec if isinstance(sh, Sharding) else ()
        parts = []
        for i, p in enumerate(spec):
            ax = tuple(a for a in (p or ()) if a in sizes)
            prod = math.prod(sizes[a] for a in ax)
            parts.append(ax if ax and x.shape[i] % prod == 0 else None)
        whole = (x.full_tensor() if isinstance(x, DTensor) else x).detach()
        place = placements(tuple(parts), whole.ndim, new_mesh)
        return distribute_tensor(whole, new_mesh, place, src_data_rank=None)

    return _map_tree(move, tree, old_placements)
