"""PcclSession — the stateful front door to PCCL planning.

The paper presents PCCL as a *library*: one entry point that, given a
collective request and the current fabric state, synthesizes the cheapest
reconfiguration-aware execution.  :class:`PcclSession` is that entry point.
It improves on the free-function facade (``repro_torch.core.pccl``) in two ways:

* **Two-level plan cache** — plans are memoized by
  ``(collective, n, nbytes, algorithm, dims, fabric-fingerprint)``, so a
  training loop that issues the same gradient all-reduce every step plans
  once.  Underneath, a *structure cache* keyed without ``nbytes`` holds the
  planner's size-independent routing/transition tables, so a plan-cache
  miss at a new buffer size (a sweep, a new gradient bucket) skips all
  routing and pays only the cheap numeric phase.  Hit/miss accounting is
  exposed via :attr:`PcclSession.stats` / :attr:`PcclSession.structure_stats`,
  and :meth:`PcclSession.plan_sweep` prices a whole list of buffer sizes in
  one batched numeric pass.
* **Fabric-state threading** — the final topology of plan *k* becomes the
  initial topology ``G0`` of plan *k+1*.  Back-to-back collectives therefore
  stop paying for reconfigurations the fabric already has: e.g. a repeated
  ring reduce-scatter re-enters its own ideal ring for free, saving one
  reconfiguration delay per iteration versus cold-start planning.

Executable collectives hang off :meth:`PcclSession.communicator`, which
returns :class:`~repro_torch.api.communicator.Communicator` objects bound to a
mesh axis, a pluggable backend (``interp`` / ``native`` / ``sim``) and the
session's device.  The device defaults to CUDA: a session never quietly
runs on the CPU; pass ``device="cpu"`` to ask for it.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import (
    TYPE_CHECKING,
    Any,
    Dict,
    FrozenSet,
    Iterable,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import torch

from repro_torch.core import schedules as S
from repro_torch.core.cost_model import (
    STRUCTURE_TABLE,
    HardwareParams,
    ScheduleCost,
    schedule_cost_fixed,
)
from repro_torch.core.pccl import (
    CollectiveRequest,
    ConcurrentCollectiveRequest,
    ConcurrentPcclPlan,
    PcclPlan,
    default_standard_set,
    plan_collective_hierarchical,
    plan_collective_sweep,
    plan_concurrent_collectives,
    replan_collective,
)
from repro_torch.core.planner import PlanStructure, trans_cache_stats
from repro_torch.core.topology import Edge, Topology, degrade_topology, ring

if TYPE_CHECKING:  # pragma: no cover
    from .communicator import Communicator

# (collective, n, nbytes, algorithm, dims, fabric edge-set fingerprint)
PlanKey = Tuple[str, int, float, str, Optional[Tuple[int, ...]], FrozenSet[Edge]]
# PlanKey minus nbytes: everything a plan's *structure* depends on
StructureKey = Tuple[str, int, str, Optional[Tuple[int, ...]], FrozenSet[Edge]]


# --------------------------------------------------------------------------
# The PlanRequest family — the session's unified planning surface.
#
# Every way to ask the planner for something is a frozen, hashable request
# value handed to :meth:`PcclSession.submit`.  The five named entrypoints
# (``plan`` / ``plan_sweep`` / ``plan_hierarchical`` / ``replan`` /
# ``plan_concurrent``) are thin wrappers that build one of these — callers
# that construct requests directly (queues, arbiters, RPC layers) get the
# exact same cached behavior, and requests can be stored, compared, and
# replayed.  These types are API-stable (see CONTRIBUTING.md): fields are
# only ever *added*, with defaults that preserve old behavior.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PlanRequest:
    """One reconfiguration-aware plan from the current fabric state.

    Equivalent to :meth:`PcclSession.plan` with the same arguments.
    """

    collective: str
    nbytes: float
    n: Optional[int] = None
    algorithm: str = "paper_default"
    dims: Optional[Tuple[int, ...]] = None
    rel_error_tol: Optional[float] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "nbytes", float(self.nbytes))
        if self.dims is not None:
            object.__setattr__(self, "dims", tuple(self.dims))


@dataclass(frozen=True)
class PlanSweepRequest:
    """Price one collective at many buffer sizes in one batched numeric
    phase (:meth:`PcclSession.plan_sweep`); fabric state is not threaded."""

    collective: str
    sizes: Tuple[float, ...]
    n: Optional[int] = None
    algorithm: str = "paper_default"
    dims: Optional[Tuple[int, ...]] = None
    rel_error_tol: Optional[float] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "sizes", tuple(float(d) for d in self.sizes))
        if self.dims is not None:
            object.__setattr__(self, "dims", tuple(self.dims))


@dataclass(frozen=True)
class HierarchicalPlanRequest:
    """Two-level (per-pod exact + coarse inter-pod) plan
    (:meth:`PcclSession.plan_hierarchical`)."""

    collective: str
    nbytes: float
    n: Optional[int] = None
    algorithm: str = "paper_default"
    dims: Optional[Tuple[int, ...]] = None
    pods: Optional[Tuple[Tuple[int, ...], ...]] = None
    pod_size: Optional[int] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "nbytes", float(self.nbytes))
        if self.dims is not None:
            object.__setattr__(self, "dims", tuple(self.dims))
        if self.pods is not None:
            object.__setattr__(
                self, "pods", tuple(tuple(p) for p in self.pods)
            )


@dataclass(frozen=True)
class ReplanRequest:
    """Warm incremental replan after link/rank failures
    (:meth:`PcclSession.replan`); permanently degrades the fabric."""

    collective: str
    nbytes: float
    n: Optional[int] = None
    algorithm: str = "paper_default"
    dims: Optional[Tuple[int, ...]] = None
    failed_edges: Tuple[Edge, ...] = ()
    failed_ranks: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "nbytes", float(self.nbytes))
        if self.dims is not None:
            object.__setattr__(self, "dims", tuple(self.dims))
        object.__setattr__(
            self,
            "failed_edges",
            tuple((int(u), int(v)) for (u, v) in self.failed_edges),
        )
        object.__setattr__(
            self, "failed_ranks", tuple(int(r) for r in self.failed_ranks)
        )


@dataclass(frozen=True)
class ConcurrentPlanRequest:
    """Joint plan for several concurrently-active collectives
    (:meth:`PcclSession.plan_concurrent`).

    ``offsets`` gives each constituent request an arrival-round offset —
    group ``g``'s round ``i`` executes at joint round ``i + offsets[g]`` —
    so staggered admissions (a decode wave joining mid-prefill) don't force
    round-0 alignment; during its idle prefix a group may pre-position into
    any state enterable at its first round.
    """

    requests: Tuple[ConcurrentCollectiveRequest, ...]
    n: Optional[int] = None
    offsets: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "requests", tuple(self.requests))
        if self.offsets is not None:
            object.__setattr__(
                self, "offsets", tuple(int(o) for o in self.offsets)
            )


AnyPlanRequest = (
    PlanRequest,
    PlanSweepRequest,
    HierarchicalPlanRequest,
    ReplanRequest,
    ConcurrentPlanRequest,
)


@dataclass(frozen=True)
class CacheStats:
    hits: int
    misses: int
    size: int
    evictions: int = 0
    bytes: int = 0  # estimated value footprint (0 for unmetered caches)

    @property
    def requests(self) -> int:
        return self.hits + self.misses


@dataclass(frozen=True)
class StructureStatsTotals(CacheStats):
    """:attr:`PcclSession.structure_stats` — the session's structure-bundle
    cache accounting plus the process-wide planner table totals behind it
    (``bytes`` = this session's cached ``PlanStructure`` arrays;
    ``table_bytes``/``trans_bytes`` = the shared routing structure table and
    transition memo, which size-aware eviction keeps bounded at large n)."""

    table_bytes: int = 0
    table_entries: int = 0
    trans_bytes: int = 0
    trans_entries: int = 0


class PlanCache:
    """Bounded LRU plan memo with hit/miss/eviction accounting.

    ``max_entries`` defaults generously — a training loop rarely plans more
    than a handful of distinct keys — but keeps a long-running serving
    session that plans many distinct ``nbytes`` from growing without limit.
    Lookup/store/clear are lock-guarded: ``move_to_end``/``popitem`` are not
    safe under concurrent mutation, and sessions may plan from worker
    threads.
    """

    def __init__(
        self, max_entries: int = 4096, max_bytes: Optional[int] = None
    ) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self._plans: "OrderedDict[PlanKey, PcclPlan]" = OrderedDict()
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._bytes = 0
        self._charges: Dict[PlanKey, int] = {}

    def _charge(self, value: Any) -> int:
        """Estimated byte footprint of a cached value; 0 = unmetered."""
        return 0

    def lookup(self, key: PlanKey) -> Optional[PcclPlan]:
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._hits += 1
                self._plans.move_to_end(key)
            else:
                self._misses += 1
            return plan

    def store(self, key: PlanKey, plan: PcclPlan) -> None:
        charge = self._charge(plan)
        with self._lock:
            # Bundles are mutated in place and re-stored, so an existing
            # key's charge is replaced, not accumulated.
            self._bytes += charge - self._charges.pop(key, 0)
            if charge:
                self._charges[key] = charge
            self._plans[key] = plan
            self._plans.move_to_end(key)
            # Byte pressure never evicts the entry just stored (>1 floor),
            # so a single oversized bundle still caches.
            while len(self._plans) > 1 and (
                len(self._plans) > self.max_entries
                or (self.max_bytes is not None and self._bytes > self.max_bytes)
            ):
                old_key, _ = self._plans.popitem(last=False)
                self._bytes -= self._charges.pop(old_key, 0)
                self._evictions += 1

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._charges.clear()
            self._hits = 0
            self._misses = 0
            self._evictions = 0
            self._bytes = 0

    @property
    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(
                self._hits,
                self._misses,
                len(self._plans),
                self._evictions,
                self._bytes,
            )


class StructureCache(PlanCache):
    """First level of the session's two-level plan cache.

    Maps a :data:`StructureKey` — a plan key *without* ``nbytes`` — to the
    per-candidate-algorithm ``{algorithm: PlanStructure}`` bundle produced
    by the planner's size-independent phase.  A plan-cache miss at a new
    buffer size reuses the bundle and pays only the cheap numeric phase;
    only a new (collective, fabric, algorithm-mode) combination routes.
    Same bounded lock-guarded LRU semantics as :class:`PlanCache`, plus
    byte-charged eviction: bundles are charged their numpy array footprint
    so large-n structures (tables scale with states × rounds) cannot pin
    unbounded memory no matter how few entries they span.
    """

    def _charge(self, value: Any) -> int:
        total = 0
        for structure in value.values():
            for arr in (
                structure.dilation,
                structure.congestion,
                structure.feasible,
                structure.enterable,
                structure.trans,
            ):
                total += int(arr.nbytes)
            total += 512  # fixed overhead: states, keys, dict slot
        return total


def _resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` → the current CUDA device; CUDA without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PcclSession runs on CUDA by default, and CUDA is not "
                "available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PcclSession:
    """Stateful planning session over one photonic fabric.

    Args:
      hw: α–β + reconfiguration hardware parameters.  ``hw``'s
        reconfiguration mode (``HardwareParams.reconfig_mode``) flows through
        every plan: with partial/overlapped reconfiguration
        (``hw.with_link_reconfig(r_link, overlap=True)``) the threaded fabric
        state makes warm starts even cheaper — the fabric already holds most
        of the next plan's circuits, so only the few changed links are
        reprogrammed (and hidden behind communication).
      g0: initial fabric topology.  Optional; collectives over ``n`` ranks
        with no recorded fabric default to ``ring(n)`` (the paper's G0).
      standard_set: the planner's standard fallback graphs ``S``
        (Algorithm 1).  Defaults to ``{ring, torus2d}`` per rank count.
      thread_fabric: when True (default) each plan's final topology becomes
        the next plan's ``G0`` for the same rank count.  Benchmarks that
        need cold-start numbers pass False.
      max_cached_plans: LRU bound on the plan cache (evictions show up in
        :attr:`stats`).
      max_cached_structures: LRU bound on the structure cache — the first
        level of the two-level cache, keyed without ``nbytes``, holding the
        planner's size-independent routing/transition tables.  A plan-cache
        miss that hits here (e.g. a new buffer size over a known fabric)
        skips all routing and pays only the numeric phase.
      max_structure_bytes: byte bound on the same structure cache.  Entry
        counts alone under-bound memory at large ``n`` (one n=1024 bundle
        dwarfs hundreds of n=16 ones), so bundles are charged their numpy
        array footprint and evicted LRU-first past this cap (totals in
        :attr:`structure_stats`).
      device: where the session's communicators execute.  ``None`` means
        CUDA (the current card); a CUDA device without CUDA raises
        ``RuntimeError``.  Pass ``"cpu"`` to run on the CPU.
    """

    def __init__(
        self,
        hw: HardwareParams,
        g0: Optional[Topology] = None,
        standard_set: Optional[Sequence[Topology]] = None,
        *,
        thread_fabric: bool = True,
        max_cached_plans: int = 4096,
        max_cached_structures: int = 512,
        max_structure_bytes: int = 256 * 1024 * 1024,
        device: Optional[Union[str, torch.device]] = None,
    ) -> None:
        self.device = _resolve_device(device)
        self.hw = hw
        self.thread_fabric = thread_fabric
        self.cache = PlanCache(max_entries=max_cached_plans)
        self.structures = StructureCache(
            max_entries=max_cached_structures, max_bytes=max_structure_bytes
        )
        # plan() is a read-plan-store-thread sequence over fabric state;
        # serialize it so concurrent planners never start from a topology
        # the fabric doesn't hold (distinct sessions still plan in parallel)
        self._plan_lock = threading.RLock()
        self._initial: Dict[int, Topology] = {}
        self._fabric: Dict[int, Topology] = {}
        self._standard: Dict[int, List[Topology]] = {}
        self._default_n: Optional[int] = None
        if g0 is not None:
            self._initial[g0.n] = g0
            self._default_n = g0.n
        for topo in standard_set or ():
            self._standard.setdefault(topo.n, []).append(topo)

    # ------------------------------------------------------------- fabric
    def initial_fabric(self, n: Optional[int] = None) -> Topology:
        n = self._resolve_n(n)
        with self._plan_lock:  # re-entrant: plan() calls this lock held
            return self._initial.setdefault(n, ring(n))

    def fabric(self, n: Optional[int] = None) -> Topology:
        """Current fabric state for ``n``-rank collectives."""
        n = self._resolve_n(n)
        return self._fabric.get(n) or self.initial_fabric(n)

    def reset_fabric(self, n: Optional[int] = None) -> None:
        """Forget threaded state; next plan starts from the initial ``G0``."""
        with self._plan_lock:
            if n is None:
                self._fabric.clear()
            else:
                self._fabric.pop(n, None)

    def standard_set(self, n: Optional[int] = None) -> List[Topology]:
        n = self._resolve_n(n)
        with self._plan_lock:
            if n not in self._standard:
                self._standard[n] = list(default_standard_set(n))
            return self._standard[n]

    def _resolve_n(self, n: Optional[int]) -> int:
        if n is not None:
            return n
        if self._default_n is None:
            raise ValueError(
                "session has no default rank count; pass n= or construct "
                "PcclSession with g0"
            )
        return self._default_n

    # ------------------------------------------------------------ planning
    def _plan_missing(
        self,
        collective: str,
        sizes: Sequence[float],
        n: int,
        g0: Topology,
        algorithm: str,
        dims_t: Optional[Tuple[int, ...]],
        dims: Optional[Sequence[int]],
        rel_error_tol: Optional[float] = None,
    ) -> List[PcclPlan]:
        """Plan ``sizes`` through the structure cache (caller holds the
        plan lock and has already missed the per-``nbytes`` plan cache)."""
        skey: StructureKey = (collective, n, algorithm, dims_t, g0.edges)
        if rel_error_tol is not None:
            # a declared tolerance can widen the candidate set (ring_ef8),
            # so tolerant and exact requests must not share structures —
            # appended only when set, keeping every existing key unchanged
            skey = skey + (float(rel_error_tol),)
        bundle: Optional[Dict[str, PlanStructure]] = self.structures.lookup(skey)
        if bundle is None:
            bundle = {}
        plans = plan_collective_sweep(
            CollectiveRequest(
                collective, n, sizes[0], algorithm=algorithm,
                rel_error_tol=rel_error_tol,
            ),
            sizes,
            g0,
            self.hw,
            standard=self.standard_set(n),
            dims=dims,
            structure_for=bundle.get,
            on_structure=bundle.__setitem__,
        )
        self.structures.store(skey, bundle)
        return plans

    def submit(self, request: Any) -> Any:
        """Unified planning entrypoint: dispatch one frozen request value.

        Accepts any member of the :data:`AnyPlanRequest` family and returns
        what the corresponding named method would: a :class:`PcclPlan`
        (:class:`PlanRequest` / :class:`HierarchicalPlanRequest` /
        :class:`ReplanRequest`), a list of plans
        (:class:`PlanSweepRequest`), or a
        :class:`~repro_torch.core.pccl.ConcurrentPcclPlan`
        (:class:`ConcurrentPlanRequest`).  The named methods are thin
        wrappers over this — ``session.plan(c, b)`` and
        ``session.submit(PlanRequest(c, b))`` are bit-identical, share the
        same caches, and thread fabric state the same way.
        """
        if isinstance(request, PlanRequest):
            return self._submit_plan(request)
        if isinstance(request, PlanSweepRequest):
            return self._submit_sweep(request)
        if isinstance(request, HierarchicalPlanRequest):
            return self._submit_hierarchical(request)
        if isinstance(request, ReplanRequest):
            return self._submit_replan(request)
        if isinstance(request, ConcurrentPlanRequest):
            return self._submit_concurrent(request)
        raise TypeError(
            f"submit() takes a PlanRequest-family value, got "
            f"{type(request).__name__!r}"
        )

    def plan(
        self,
        collective: str,
        nbytes: float,
        *,
        n: Optional[int] = None,
        algorithm: str = "paper_default",
        dims: Optional[Sequence[int]] = None,
        rel_error_tol: Optional[float] = None,
    ) -> PcclPlan:
        """Plan ``collective`` from the *current* fabric state (cached).

        ``rel_error_tol`` declares how much relative error the caller can
        absorb (see ``cost_model.compressed_ef_error_bound``); ``auto``
        arbitration may then also pick lossy wire-compressed algorithms.
        Tolerant plans get their own cache entries (the key is extended
        only when the tolerance is set).
        """
        return self.submit(PlanRequest(
            collective, nbytes, n=n, algorithm=algorithm,
            dims=tuple(dims) if dims is not None else None,
            rel_error_tol=rel_error_tol,
        ))

    def _submit_plan(self, req: PlanRequest) -> PcclPlan:
        with self._plan_lock:
            n = self._resolve_n(req.n)
            g0 = self.fabric(n)
            key: PlanKey = (
                req.collective,
                n,
                req.nbytes,
                req.algorithm,
                req.dims,
                g0.edges,
            )
            if req.rel_error_tol is not None:
                key = key + (float(req.rel_error_tol),)
            plan = self.cache.lookup(key)
            if plan is None:
                plan = self._plan_missing(
                    req.collective, [req.nbytes], n, g0, req.algorithm,
                    req.dims, req.dims, req.rel_error_tol,
                )[0]
                self.cache.store(key, plan)
            if self.thread_fabric and plan.final_topology is not None:
                self._fabric[n] = plan.final_topology
            return plan

    def plan_sweep(
        self,
        collective: str,
        sizes: Sequence[float],
        *,
        n: Optional[int] = None,
        algorithm: str = "paper_default",
        dims: Optional[Sequence[int]] = None,
        rel_error_tol: Optional[float] = None,
    ) -> List[PcclPlan]:
        """Plan ``collective`` at every buffer size in ``sizes``, from the
        *current* fabric state, in one batched numeric phase.

        Returns one plan per size, equal to calling :meth:`plan` per size
        on a non-threading session — bit-identical when size ratios are
        powers of two (the common sweep layout), to the last ulp otherwise
        (sweeps rescale one template schedule; see
        :func:`repro_torch.core.planner.plan_sweep`).  A sweep prices
        alternatives, so every size starts from the same fabric state and —
        unlike :meth:`plan` — the fabric is **not** threaded afterwards.
        Results feed the per-``nbytes`` plan cache both ways:
        already-planned sizes are served from it, and newly planned sizes
        are stored for later :meth:`plan` calls.
        """
        return self.submit(PlanSweepRequest(
            collective, tuple(float(d) for d in sizes), n=n,
            algorithm=algorithm,
            dims=tuple(dims) if dims is not None else None,
            rel_error_tol=rel_error_tol,
        ))

    def _submit_sweep(self, req: PlanSweepRequest) -> List[PcclPlan]:
        with self._plan_lock:
            n = self._resolve_n(req.n)
            g0 = self.fabric(n)
            sizes_f = list(req.sizes)
            keys: List[PlanKey] = [
                (req.collective, n, d, req.algorithm, req.dims, g0.edges)
                for d in sizes_f
            ]
            if req.rel_error_tol is not None:
                keys = [k + (float(req.rel_error_tol),) for k in keys]
            plans: Dict[int, PcclPlan] = {}
            missing: List[int] = []
            for k, key in enumerate(keys):
                hit = self.cache.lookup(key)
                if hit is not None:
                    plans[k] = hit
                else:
                    missing.append(k)
            if missing:
                fresh = self._plan_missing(
                    req.collective, [sizes_f[k] for k in missing], n, g0,
                    req.algorithm, req.dims, req.dims, req.rel_error_tol,
                )
                for k, p in zip(missing, fresh):
                    self.cache.store(keys[k], p)
                    plans[k] = p
            return [plans[k] for k in range(len(sizes_f))]

    def plan_hierarchical(
        self,
        collective: str,
        nbytes: float,
        *,
        n: Optional[int] = None,
        algorithm: str = "paper_default",
        dims: Optional[Sequence[int]] = None,
        pods: Optional[Sequence[Sequence[int]]] = None,
        pod_size: Optional[int] = None,
    ) -> PcclPlan:
        """Plan ``collective`` through the two-level hierarchical path
        (per-pod exact DP + coarse inter-pod phase), cached.

        This is the scaling entry point: flat exact planning is quadratic in
        the state count (~``n``), while the hierarchical path plans one
        representative pod per equivalence class plus a ``P``-super-rank
        coarse phase — n=1024 cold plans land well inside the 1 s budget.
        With one pod (``pod_size=n``) the result wraps the flat exact plan
        bit-identically.  Hierarchical plans carry no single final fabric
        (pods own disjoint circuits), so fabric state is **not** threaded.
        """
        return self.submit(HierarchicalPlanRequest(
            collective, nbytes, n=n, algorithm=algorithm,
            dims=tuple(dims) if dims is not None else None,
            pods=tuple(tuple(p) for p in pods) if pods is not None else None,
            pod_size=pod_size,
        ))

    def _submit_hierarchical(self, req: HierarchicalPlanRequest) -> PcclPlan:
        with self._plan_lock:
            n = self._resolve_n(req.n)
            g0 = self.fabric(n)
            key = (
                "__hierarchical__",
                req.collective,
                n,
                req.nbytes,
                req.algorithm,
                req.dims,
                req.pods,
                req.pod_size,
                g0.edges,
            )
            plan = self.cache.lookup(key)
            if plan is None:
                plan = plan_collective_hierarchical(
                    CollectiveRequest(
                        req.collective, n, req.nbytes,
                        algorithm=req.algorithm,
                    ),
                    g0,
                    self.hw,
                    standard=self.standard_set(n),
                    dims=req.dims,
                    pods=req.pods,
                    pod_size=req.pod_size,
                )
                self.cache.store(key, plan)
            return plan

    def replan(
        self,
        collective: str,
        nbytes: float,
        *,
        n: Optional[int] = None,
        algorithm: str = "paper_default",
        dims: Optional[Sequence[int]] = None,
        failed_edges: Iterable[Edge] = (),
        failed_ranks: Iterable[int] = (),
    ) -> PcclPlan:
        """Warm-replan after link/rank failures: the fault-event fast path.

        ``failed_edges`` name physical links, so both directions die; a rank
        in ``failed_ranks`` loses every incident link.  The session's cached
        size-independent structures are re-priced incrementally — only
        states whose edge set actually changed re-route
        (O(affected states), see :func:`repro_torch.core.planner.replan`) — and
        the resulting plan equals a cold plan of the degraded fabric
        bit-for-bit.  Failures are permanent: the per-``n`` fabric,
        initial fabric, and standard set are degraded in place, so every
        later :meth:`plan` (and :meth:`reset_fabric`) sees the surviving
        links only, and the refreshed structures are cached under the
        degraded fingerprint for further warm events.
        """
        return self.submit(ReplanRequest(
            collective, nbytes, n=n, algorithm=algorithm,
            dims=tuple(dims) if dims is not None else None,
            failed_edges=tuple(failed_edges),
            failed_ranks=tuple(failed_ranks),
        ))

    def _submit_replan(self, req: ReplanRequest) -> PcclPlan:
        with self._plan_lock:
            n = self._resolve_n(req.n)
            g0 = self.fabric(n)
            failed_e = frozenset(
                e for (u, v) in req.failed_edges for e in ((u, v), (v, u))
            )
            failed_r = frozenset(req.failed_ranks)
            skey: StructureKey = (
                req.collective, n, req.algorithm, req.dims, g0.edges
            )
            bundle = self.structures.lookup(skey) or {}
            new_bundle: Dict[str, PlanStructure] = {}
            plan = replan_collective(
                CollectiveRequest(
                    req.collective, n, req.nbytes, algorithm=req.algorithm
                ),
                g0,
                self.hw,
                standard=self.standard_set(n),
                dims=req.dims,
                changed_edges=tuple(failed_e),
                changed_ranks=tuple(failed_r),
                structure_for=bundle.get,
                on_structure=new_bundle.__setitem__,
            )
            self._standard[n] = [
                degrade_topology(s, failed_e, failed_r)
                for s in self.standard_set(n)
            ]
            d_g0 = degrade_topology(g0, failed_e, failed_r)
            self._fabric[n] = d_g0
            if n in self._initial:
                self._initial[n] = degrade_topology(
                    self._initial[n], failed_e, failed_r
                )
            self.structures.store(
                (req.collective, n, req.algorithm, req.dims, d_g0.edges),
                new_bundle,
            )
            self.cache.store(
                (req.collective, n, req.nbytes, req.algorithm, req.dims,
                 d_g0.edges),
                plan,
            )
            if self.thread_fabric and plan.final_topology is not None:
                self._fabric[n] = plan.final_topology
            return plan

    def plan_concurrent(
        self,
        requests: Sequence[ConcurrentCollectiveRequest],
        *,
        n: Optional[int] = None,
        offsets: Optional[Sequence[int]] = None,
    ) -> ConcurrentPcclPlan:
        """Jointly plan several concurrently-active collectives (cached).

        ``requests`` are :class:`repro_torch.core.pccl.ConcurrentCollectiveRequest`
        specs — most conveniently built with
        :meth:`Communicator.concurrent_request`, so a TP×DP job plans both
        mesh axes in one call::

            comm = session.communicator("x", 16)
            tp = comm.split([r // 4 for r in range(16)])   # rows
            dp = comm.split([r % 4 for r in range(16)])    # columns
            cp = session.plan_concurrent([
                tp.concurrent_request("all_reduce", act_bytes),
                dp.concurrent_request("reduce_scatter", grad_bytes),
            ])

        The joint plan starts from the *current* fabric state, and the
        combined final topology (every group's last allocation) is threaded
        back as the next plan's ``G0``.  Results are memoized in the plan
        cache keyed by the full request tuple plus the fabric fingerprint;
        concurrent plans bypass the structure cache (their structures are
        built against the composed full-domain schedules).

        ``n`` (the shared fabric domain size) is inferred from any request
        that carries process groups; pass it explicitly when every request
        spans the whole domain.

        ``offsets`` (one non-negative int per request) staggers arrivals:
        request ``g``'s round ``i`` executes at joint round
        ``i + offsets[g]``, and during its idle prefix the group may
        pre-position into any state enterable at its first round — so a
        collective admitted mid-flight doesn't force round-0 alignment.
        """
        return self.submit(ConcurrentPlanRequest(
            tuple(requests), n=n,
            offsets=tuple(offsets) if offsets is not None else None,
        ))

    def _submit_concurrent(
        self, req: ConcurrentPlanRequest
    ) -> ConcurrentPcclPlan:
        with self._plan_lock:
            requests = req.requests
            if not requests:
                raise ValueError("plan_concurrent needs at least one request")
            n = req.n
            if n is None:
                for r in requests:
                    if r.groups is not None:
                        n = sum(len(g) for g in r.groups)
                        break
            n = self._resolve_n(n)
            g0 = self.fabric(n)
            key = (
                "__concurrent__",
                n,
                tuple(
                    (r.collective, float(r.nbytes), r.algorithm, r.groups)
                    for r in requests
                ),
                g0.edges,
            )
            if req.offsets is not None and any(req.offsets):
                # appended only for nonzero staggering, keeping every
                # pre-existing round-0-aligned cache key unchanged
                key = key + (req.offsets,)
            plan = self.cache.lookup(key)
            if plan is None:
                plan = plan_concurrent_collectives(
                    requests, n, g0, self.hw,
                    standard=self.standard_set(n), offsets=req.offsets,
                )
                self.cache.store(key, plan)
            if self.thread_fabric and plan.final_topology is not None:
                self._fabric[n] = plan.final_topology
            return plan

    def choose_algorithm(
        self, collective: str, nbytes: float, *, n: Optional[int] = None
    ) -> str:
        """§2.2 size-aware algorithm choice, via planned cost (cached)."""
        return self.plan(collective, nbytes, n=n, algorithm="auto").algorithm

    def baseline(
        self,
        collective: str,
        algorithm: str,
        nbytes: float,
        *,
        n: Optional[int] = None,
        topo: Optional[Topology] = None,
        dims: Optional[Sequence[int]] = None,
    ) -> ScheduleCost:
        """Fixed-topology cost of a named algorithm (the §5 baselines).

        Prices on the session's *initial* fabric by default — baselines
        cannot reconfigure, so threaded state never applies to them.
        """
        n = self._resolve_n(n)
        topo = topo or self.initial_fabric(n)
        sched = S.get_schedule(collective, algorithm, n, float(nbytes), dims=dims)
        return schedule_cost_fixed(topo, sched, self.hw)

    @property
    def stats(self) -> CacheStats:
        return self.cache.stats

    @property
    def structure_stats(self) -> StructureStatsTotals:
        """Hit/miss accounting for the size-independent structure cache,
        plus byte totals for it and the process-wide planner tables (the
        routing structure table and the transition memo), all of which are
        byte-charged and evict under memory pressure."""
        base = self.structures.stats
        table = STRUCTURE_TABLE.stats
        trans_entries, trans_bytes = trans_cache_stats()
        return StructureStatsTotals(
            base.hits,
            base.misses,
            base.size,
            base.evictions,
            base.bytes,
            table_bytes=table.bytes,
            table_entries=table.size,
            trans_bytes=trans_bytes,
            trans_entries=trans_entries,
        )

    def exec_stats(self):
        """Execution-engine counters: the compiled-schedule cache, the
        device-table uploads and the fusion dispatch counters.  The caches
        are **process-wide** (keyed by schedule fingerprint and device, so
        sessions share them safely); a steady-state loop only hits.  See
        :func:`repro_torch.comm.exec_engine.exec_stats`.
        """
        from repro_torch.comm.exec_engine import exec_stats

        return exec_stats()

    @property
    def reconfig_mode(self) -> str:
        """``serial`` | ``partial`` | ``overlap`` — how this session's
        hardware model prices topology changes (see ``HardwareParams``)."""
        return self.hw.reconfig_mode

    # ------------------------------------------------------- communicators
    def communicator(
        self,
        axis_name: str,
        n: Optional[int] = None,
        *,
        backend: str = "interp",
        algorithm: str = "auto",
        rel_error_tol: Optional[float] = None,
    ) -> "Communicator":
        """Executable collectives over mesh axis ``axis_name``.

        ``backend`` is one of ``interp`` (the compiled schedule engine),
        ``native`` (plain tensor collectives, the A/B baseline) or ``sim``
        (cost-model-only).  The communicator runs on the session's device.
        ``rel_error_tol`` (see :meth:`plan`) lets ``auto`` arbitration
        consider lossy wire-compressed algorithms for this communicator's
        collectives.
        """
        from .communicator import Communicator

        return Communicator(
            self, axis_name, self._resolve_n(n), backend=backend,
            algorithm=algorithm, rel_error_tol=rel_error_tol,
        )
