"""PCCL facade — the library's user-facing planning API.

Given a collective request (primitive, #ranks, buffer size), an initial
fabric state ``G0``, and hardware parameters, :func:`plan_collective`

1. builds the candidate algorithm schedules for that primitive (§2.2: the
   right algorithm depends on buffer size and hardware — there is no silver
   bullet),
2. runs the reconfiguration planner (Algorithm 1) on each schedule, and
3. returns the cheapest :class:`PcclPlan`, alongside fixed-topology baseline
   costs so callers (benchmarks, the training integration) can report the
   paper's comparisons directly.

The default input schedules follow the paper: RHD for reduce-scatter /
all-reduce (§5 "PCCL Inputs"), DEX for all-to-all (Fig. 10a), with ``auto``
additionally considering Ring (large-buffer β-optimal) and letting the
planner arbitrate — this is the "selecting the right algorithm" knob PCCL
exposes to distributed-ML programmers.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import schedules as S
from .cost_model import (
    HardwareParams,
    ScheduleCost,
    compressed_ef_error_bound,
    ideal_cost,
    schedule_cost_fixed,
)
from .planner import (
    ConcurrentPlan,
    HierarchicalPlan,
    Plan,
    PlanStructure,
    _plans_from_structure,
    build_structure,
    plan_concurrent,
    plan_hierarchical,
    plan_sweep,
    replan,
)
from .schedules import Groups, Schedule, replicate_groups
from .topology import Topology, ring, standard_topologies


@dataclass(frozen=True)
class PcclPlan:
    request: "CollectiveRequest"
    schedule: Schedule
    # flat exact-DP plan, or a stitched two-level plan (same accounting
    # surface: total_cost / num_reconfigs / final_topology / breakdown)
    plan: "Plan | HierarchicalPlan"
    candidates: Tuple[Tuple[str, float], ...]  # (algorithm, planned cost)

    @property
    def cost(self) -> float:
        return self.plan.total_cost

    @property
    def algorithm(self) -> str:
        return self.schedule.algorithm

    @property
    def num_reconfigs(self) -> int:
        return self.plan.num_reconfigs

    @property
    def final_topology(self) -> Optional[Topology]:
        """Fabric state after the last round (threaded by PcclSession)."""
        return self.plan.final_topology

    def breakdown(self) -> Dict[str, float]:
        return self.plan.breakdown()


# Version in which the deprecation shims (bare plan_collective /
# choose_algorithm here; the PcclComm shim is not ported) are removed.  Their
# replacement is the unified request surface: PcclSession.submit(PlanRequest)
# (repro_torch.api.session) — every shim warning names both.
SHIM_REMOVAL_VERSION = "2.0"


def _warn_deprecated(old: str, replacement: str) -> None:
    warnings.warn(
        f"{old} is deprecated and will be removed in repro "
        f"{SHIM_REMOVAL_VERSION}; use {replacement} instead",
        DeprecationWarning,
        stacklevel=3,
    )


@dataclass(frozen=True)
class CollectiveRequest:
    collective: str          # reduce_scatter | all_gather | all_reduce | all_to_all
    n: int
    buffer_bytes: float
    algorithm: str = "paper_default"  # or explicit name, or "auto"
    # Caller-declared tolerance on the result's relative error (w.r.t. the
    # exact result's max representable magnitude — see
    # cost_model.compressed_ef_error_bound).  None = exact results only;
    # setting it lets auto arbitration also consider lossy wire-compressed
    # algorithms (ring_ef8) whose documented bound fits under it.
    rel_error_tol: Optional[float] = None


def _pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def candidate_algorithms(
    collective: str, n: int, mode: str,
    rel_error_tol: Optional[float] = None,
) -> List[str]:
    if mode not in ("auto", "paper_default"):
        return [mode]
    if collective in ("reduce_scatter", "all_gather", "all_reduce"):
        if mode == "paper_default":
            return ["rhd"] if _pow2(n) else ["ring"]
        # §2.2: PCCL lets the user pick ANY known algorithm as the input
        # schedule — auto mode arbitrates over the full zoo via the planner.
        algos = ["ring", "bucket2d", "bucket3d"]
        if _pow2(n):
            algos.append("rhd")
        if (
            collective == "all_reduce"
            and rel_error_tol is not None
            and rel_error_tol >= compressed_ef_error_bound(n)
        ):
            # int8-on-the-wire ring: bytes/4 serialization, lossy within the
            # documented bound — only a candidate when the caller's declared
            # tolerance covers that bound.
            algos.append("ring_ef8")
        return algos
    if collective == "all_to_all":
        if mode == "paper_default":
            return ["dex"] if _pow2(n) else ["direct"]
        algos = ["direct"]
        if _pow2(n):
            algos.append("dex")
        return algos
    if collective == "p2p":
        return ["p2p"]
    raise ValueError(f"unknown collective {collective!r}")


def candidate_dims(
    algo: str, n: int, dims: Optional[Sequence[int]]
) -> Tuple[Optional[Sequence[int]], bool]:
    """(dims, usable) for one candidate algorithm: bucket algorithms over an
    ``n`` with only a degenerate (min dim 1) factorization are unusable and
    must be skipped by every arbitration path the same way."""
    if dims is None and algo.startswith("bucket"):
        from .topology import square_dims2, square_dims3

        dims = square_dims2(n) if algo == "bucket2d" else square_dims3(n)
        if min(dims) == 1:
            return None, False
    return dims, True


def default_standard_set(n: int) -> List[Topology]:
    """S of Algorithm 1: standard connected graphs the planner may fall back
    to when per-round ideal graphs would strand future rounds (§4.1)."""
    std = standard_topologies(n)
    return [std["ring"], std["torus2d"]]


def plan_collective(
    request: CollectiveRequest,
    g0: Topology,
    hw: HardwareParams,
    standard: Optional[Sequence[Topology]] = None,
    dims: Optional[Sequence[int]] = None,
) -> PcclPlan:
    """Plan one collective from a cold fabric state.

    The reconfiguration cost model rides on ``hw``
    (``HardwareParams.reconfig_mode``): the paper's serial full-delay model
    by default, or per-changed-link partial reconfiguration — optionally
    hidden behind the previous round's communication — via
    ``hw.with_link_reconfig(r_link, overlap=True)``.

    .. deprecated::
        Removed in repro 2.0 (``SHIM_REMOVAL_VERSION``).  Application code
        should go through ``PcclSession.submit(PlanRequest(...))``
        (:class:`repro_torch.api.PcclSession`), which adds plan caching and
        fabric-state threading across collectives.  The stateless planning
        kernel the session calls into is :func:`plan_collective_sweep`,
        which stays; this bare entry point warns and delegates
        bit-identically until removal.
    """
    _warn_deprecated(
        "bare plan_collective",
        "PcclSession.submit(PlanRequest(collective, nbytes)) from repro_torch.api",
    )
    return plan_collective_sweep(
        request, [request.buffer_bytes], g0, hw, standard=standard, dims=dims
    )[0]


def plan_collective_sweep(
    request: CollectiveRequest,
    sizes: Sequence[float],
    g0: Topology,
    hw: HardwareParams,
    standard: Optional[Sequence[Topology]] = None,
    dims: Optional[Sequence[int]] = None,
    structure_for: Optional[Callable[[str], Optional[PlanStructure]]] = None,
    on_structure: Optional[Callable[[str, PlanStructure], None]] = None,
) -> List[PcclPlan]:
    """Plan one collective at many buffer sizes from one fabric state.

    The batched front of :func:`plan_collective`: per candidate algorithm,
    one size-independent structure phase (``planner.build_structure``)
    prices every size via ``planner.plan_sweep``, and the cheapest plan is
    selected *per size* — exactly the arbitration a per-size
    ``plan_collective`` loop performs.  ``request.buffer_bytes`` is ignored
    in favour of ``sizes``.

    Each candidate's schedule is *built once* at ``sizes[0]`` and rescaled
    to the other sizes (schedule generators are the next cost after routing
    in a sweep; only ``Round.size`` varies with the buffer).  Plans for
    ``sizes[0]`` are therefore bit-identical to ``plan_collective`` at that
    size; other sizes are bit-identical whenever their ratio to ``sizes[0]``
    is a power of two (the common sweep layout) and equal to the last ulp
    otherwise — see :func:`repro_torch.core.planner.plan_sweep`.

    ``structure_for`` / ``on_structure`` let a caller (the session's
    two-level cache) reuse structures across calls: ``structure_for(algo)``
    may return a previously built :class:`PlanStructure` for that candidate
    algorithm, and ``on_structure(algo, structure)`` is invoked for each one
    built here.
    """
    if standard is None:
        standard = default_standard_set(request.n)
    sizes = list(sizes)
    best: List[Optional[PcclPlan]] = [None] * len(sizes)
    cands: List[List[Tuple[str, float]]] = [[] for _ in sizes]
    for algo in candidate_algorithms(
        request.collective, request.n, request.algorithm,
        request.rel_error_tol,
    ):
        algo_dims, usable = candidate_dims(algo, request.n, dims)
        if not usable:
            continue
        template = S.get_schedule(
            request.collective, algo, request.n, sizes[0], dims=algo_dims
        )
        structure = structure_for(algo) if structure_for is not None else None
        if structure is None:
            structure = build_structure(g0, standard, template, hw)
            if on_structure is not None:
                on_structure(algo, structure)
        plans = plan_sweep(
            g0, standard, template, hw, sizes, structure=structure
        )
        for k, p in enumerate(plans):
            cands[k].append((algo, p.total_cost))
            if best[k] is None or p.total_cost < best[k].cost:
                req_k = (
                    request
                    if sizes[k] == request.buffer_bytes
                    else replace(request, buffer_bytes=sizes[k])
                )
                best[k] = PcclPlan(req_k, p.schedule, p, ())
    out: List[PcclPlan] = []
    for b, c in zip(best, cands):
        assert b is not None
        out.append(PcclPlan(b.request, b.schedule, b.plan, tuple(c)))
    return out


def plan_collective_hierarchical(
    request: CollectiveRequest,
    g0: Topology,
    hw: HardwareParams,
    standard: Optional[Sequence[Topology]] = None,
    dims: Optional[Sequence[int]] = None,
    *,
    pods: Optional[Sequence[Sequence[int]]] = None,
    pod_size: Optional[int] = None,
) -> PcclPlan:
    """Plan one collective through the two-level hierarchical path
    (:func:`repro_torch.core.planner.plan_hierarchical`), arbitrating candidate
    algorithms by stitched cost exactly like :func:`plan_collective` does by
    flat cost.

    This is the scaling path: flat exact planning is O(rounds · states²)
    with states ~ n, while the hierarchical path plans one representative
    pod and one P-super-rank coarse phase.  With a single pod it degrades
    to the flat exact DP (bit-identical plan inside ``.plan.pod_plans[0]``).
    """
    if standard is None:
        standard = default_standard_set(request.n)
    best: Optional[PcclPlan] = None
    cands: List[Tuple[str, float]] = []
    for algo in candidate_algorithms(
        request.collective, request.n, request.algorithm,
        request.rel_error_tol,
    ):
        algo_dims, usable = candidate_dims(algo, request.n, dims)
        if not usable:
            continue
        schedule = S.get_schedule(
            request.collective, algo, request.n, request.buffer_bytes,
            dims=algo_dims,
        )
        hp = plan_hierarchical(
            g0, standard, schedule, hw, pods=pods, pod_size=pod_size
        )
        cands.append((algo, hp.total_cost))
        if best is None or hp.total_cost < best.cost:
            best = PcclPlan(request, schedule, hp, ())
    if best is None:
        raise ValueError(
            f"no usable candidate algorithm for {request.collective} at "
            f"n={request.n}"
        )
    return PcclPlan(best.request, best.schedule, best.plan, tuple(cands))


def replan_collective(
    request: CollectiveRequest,
    g0: Topology,
    hw: HardwareParams,
    standard: Optional[Sequence[Topology]] = None,
    dims: Optional[Sequence[int]] = None,
    *,
    changed_edges: Sequence[Tuple[int, int]] = (),
    changed_ranks: Sequence[int] = (),
    structure_for: Optional[Callable[[str], Optional[PlanStructure]]] = None,
    on_structure: Optional[Callable[[str, PlanStructure], None]] = None,
) -> PcclPlan:
    """Warm-replan one collective after a fabric mutation.

    ``g0``/``standard`` are the *pre-failure* fabric inputs; candidate
    algorithms whose structures are available via ``structure_for`` take the
    incremental O(affected-states) path of :func:`repro_torch.core.planner.replan`
    (cold building otherwise), and ``on_structure`` receives each
    post-mutation structure for recaching.  Arbitration across candidates
    matches :func:`plan_collective` on the degraded fabric exactly.
    """
    if standard is None:
        standard = default_standard_set(request.n)
    best: Optional[PcclPlan] = None
    cands: List[Tuple[str, float]] = []
    for algo in candidate_algorithms(
        request.collective, request.n, request.algorithm,
        request.rel_error_tol,
    ):
        algo_dims, usable = candidate_dims(algo, request.n, dims)
        if not usable:
            continue
        schedule = S.get_schedule(
            request.collective, algo, request.n, request.buffer_bytes,
            dims=algo_dims,
        )
        structure = structure_for(algo) if structure_for is not None else None
        p, new_structure = replan(
            g0, standard, schedule, hw, structure,
            changed_edges=changed_edges, changed_ranks=changed_ranks,
        )
        if on_structure is not None:
            on_structure(algo, new_structure)
        cands.append((algo, p.total_cost))
        if best is None or p.total_cost < best.cost:
            best = PcclPlan(request, schedule, p, ())
    if best is None:
        raise ValueError(
            f"no usable candidate algorithm for {request.collective} at "
            f"n={request.n}"
        )
    return PcclPlan(best.request, best.schedule, best.plan, tuple(cands))


# --------------------------------------------------------- concurrent groups


@dataclass(frozen=True)
class ConcurrentCollectiveRequest:
    """One member of a concurrent plan: a collective over one process-group
    set of a shared ``n``-rank fabric domain.

    ``groups`` partitions the domain into equal-size groups that each run
    the collective simultaneously (the ``Communicator.split`` pattern — TP
    rows / DP columns of a 2-D mesh); ``None`` means a single group spanning
    the whole domain.  ``nbytes`` is the per-rank buffer size *within* a
    group, and ``algorithm`` follows :func:`candidate_algorithms` semantics
    (``auto`` arbitrates over the zoo via each candidate's solo plan).
    """

    collective: str
    nbytes: float
    groups: Optional[Groups] = None
    algorithm: str = "paper_default"

    def __post_init__(self) -> None:
        # normalize list-of-lists literals: group sets are part of hashable
        # plan-cache keys, so they must be tuples all the way down
        if self.groups is not None:
            object.__setattr__(
                self, "groups", tuple(tuple(g) for g in self.groups)
            )

    def group_size(self, n: int) -> int:
        return len(self.groups[0]) if self.groups else n


@dataclass(frozen=True)
class ConcurrentPcclPlan:
    """Joint plan for several concurrent collective requests (the facade
    wrapper around :class:`repro_torch.core.planner.ConcurrentPlan`)."""

    requests: Tuple[ConcurrentCollectiveRequest, ...]
    n: int
    algorithms: Tuple[str, ...]       # chosen algorithm per request
    plan: ConcurrentPlan

    @property
    def cost(self) -> float:
        return self.plan.total_cost

    @property
    def joint_cost(self) -> float:
        return self.plan.joint_cost

    @property
    def sequential_cost(self) -> float:
        return self.plan.sequential_cost

    @property
    def speedup(self) -> float:
        return self.plan.speedup

    @property
    def serialized(self) -> bool:
        return self.plan.serialized

    @property
    def final_topology(self) -> Optional[Topology]:
        return self.plan.final_topology

    @property
    def offsets(self) -> Tuple[int, ...]:
        """Per-request arrival-round offsets the joint plan was built for."""
        return self.plan.offsets

    def solo_costs(self) -> Tuple[float, ...]:
        """Per-request fabric-to-itself planned costs (the sequential parts)."""
        return tuple(g.solo.total_cost for g in self.plan.groups)


def _validate_concurrent_groups(
    requests: Sequence[ConcurrentCollectiveRequest], n: int
) -> None:
    for req in requests:
        if req.groups is None:
            continue
        sizes = {len(g) for g in req.groups}
        if len(sizes) != 1:
            raise ValueError(
                f"request {req.collective}: unequal group sizes {sizes}"
            )
        flat = sorted(r for g in req.groups for r in g)
        if flat != list(range(n)):
            raise ValueError(
                f"request {req.collective}: groups must partition the "
                f"{n}-rank domain exactly once"
            )


def plan_concurrent_collectives(
    requests: Sequence[ConcurrentCollectiveRequest],
    n: int,
    g0: Topology,
    hw: HardwareParams,
    standard: Optional[Sequence[Topology]] = None,
    *,
    offsets: Optional[Sequence[int]] = None,
) -> ConcurrentPcclPlan:
    """Jointly plan several concurrently-active collectives on one fabric.

    Per request, each candidate algorithm's group-local schedule is built at
    the requested size, composed across its process groups
    (:func:`repro_torch.core.schedules.replicate_groups`) and solo-planned; the
    cheapest candidate is that request's input schedule — the same per-size
    arbitration as :func:`plan_collective`, applied per group.  The chosen
    schedules (structures reused from arbitration) then go through the
    multi-group arbiter :func:`repro_torch.core.planner.plan_concurrent`, which
    overlaps the groups' rounds with per-link contention pricing and never
    prices worse than running the solo plans sequentially.

    ``offsets`` (one arrival round per request) staggers admissions: request
    ``k``'s rounds start at joint round ``offsets[k]`` — see
    :func:`repro_torch.core.planner.plan_concurrent`.
    """
    requests = tuple(requests)
    if not requests:
        raise ValueError("plan_concurrent_collectives needs at least one request")
    if offsets is not None and len(tuple(offsets)) != len(requests):
        raise ValueError(
            f"got {len(tuple(offsets))} offsets for {len(requests)} requests"
        )
    if standard is None:
        standard = default_standard_set(n)
    _validate_concurrent_groups(requests, n)

    chosen_scheds: List[Schedule] = []
    chosen_structs: List[PlanStructure] = []
    chosen_solos: List[Plan] = []
    algorithms: List[str] = []
    for req in requests:
        m = req.group_size(n)
        best_plan: Optional[Plan] = None
        best_sched: Optional[Schedule] = None
        best_struct: Optional[PlanStructure] = None
        for algo in candidate_algorithms(
            req.collective, m, req.algorithm,
            getattr(req, "rel_error_tol", None),
        ):
            algo_dims, usable = candidate_dims(algo, m, None)
            if not usable:
                continue
            local = S.get_schedule(
                req.collective, algo, m, req.nbytes, dims=algo_dims
            )
            sched = (
                replicate_groups(local, req.groups, n)
                if req.groups is not None
                else local
            )
            struct = build_structure(g0, standard, sched, hw)
            solo = _plans_from_structure(struct, [sched], hw)[0]
            if best_plan is None or solo.total_cost < best_plan.total_cost:
                best_plan, best_sched, best_struct = solo, sched, struct
        if best_sched is None or best_struct is None:
            raise ValueError(
                f"request {req.collective} (group size {m}, algorithm "
                f"{req.algorithm!r}) has no usable candidate schedule — "
                "e.g. a bucket algorithm over a group size with a "
                "degenerate factorization"
            )
        chosen_scheds.append(best_sched)
        chosen_structs.append(best_struct)
        chosen_solos.append(best_plan)
        algorithms.append(best_sched.algorithm)

    joint = plan_concurrent(
        g0, standard, chosen_scheds, hw,
        structures=chosen_structs, solo_plans=chosen_solos,
        offsets=offsets,
    )
    return ConcurrentPcclPlan(
        requests=requests,
        n=n,
        algorithms=tuple(algorithms),
        plan=joint,
    )


def baseline_cost(
    collective: str,
    algorithm: str,
    topo: Topology,
    n: int,
    buffer_bytes: float,
    hw: HardwareParams,
    dims: Optional[Sequence[int]] = None,
) -> ScheduleCost:
    """Fixed-topology cost of a named algorithm (the §5 baselines)."""
    sched = S.get_schedule(collective, algorithm, n, buffer_bytes, dims=dims)
    return schedule_cost_fixed(topo, sched, hw)


def theoretical_cost(
    collective: str, algorithm: str, n: int, buffer_bytes: float,
    hw: HardwareParams, dims: Optional[Sequence[int]] = None,
) -> float:
    """Textbook α–β cost of the algorithm (every round contention-free)."""
    sched = S.get_schedule(collective, algorithm, n, buffer_bytes, dims=dims)
    return ideal_cost(sched, hw)


# --------------------------------------------------------------------------
# Size-aware algorithm choice used by the training integration: the paper's
# §2.2 guidance (latency-optimal for small buffers, bandwidth-optimal for
# large) falls out of planned costs rather than a hand-tuned threshold.
# --------------------------------------------------------------------------

def choose_algorithm(
    collective: str, n: int, buffer_bytes: float, hw: HardwareParams,
    g0: Optional[Topology] = None,
) -> str:
    """.. deprecated:: removed in repro 2.0 (``SHIM_REMOVAL_VERSION``) —
    use ``PcclSession.choose_algorithm`` or
    ``PcclSession.submit(PlanRequest(..., algorithm="auto")).algorithm``
    (cached, fabric aware).  Kept as a stateless shim that delegates
    bit-identically until then."""
    _warn_deprecated(
        "bare choose_algorithm",
        "PcclSession.choose_algorithm (or PcclSession.submit(PlanRequest("
        "..., algorithm='auto')).algorithm) from repro_torch.api",
    )
    g0 = g0 or ring(n)
    p = plan_collective_sweep(
        CollectiveRequest(collective, n, buffer_bytes, algorithm="auto"),
        [buffer_bytes], g0, hw,
    )[0]
    return p.algorithm
