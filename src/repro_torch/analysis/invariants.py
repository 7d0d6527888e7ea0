"""Plan and circuit invariant checker (static, no device execution).

Complements the chunk-dataflow verifier (``analysis/verify.py``): where the
verifier proves a schedule computes the right *values*, this module proves a
schedule/plan is *realizable and priced consistently* on the photonic fabric:

* **Round feasibility** — per-round fan-out against the tile's transmitter /
  receiver budget (``HardwareParams.tx_per_gpu`` / ``rx_per_gpu``),
  permutation validity for single-Tx tiles, endpoint sanity.
* **Circuit realizability** — every distinct round structure routes on the
  MZI mesh (Algorithm 3, ``core/circuits.py``) and on the inter-server fiber
  graph (Algorithm 4, ``core/fibers.py``), with the routers' own validity
  invariants re-checked on their output.
* **Plan accounting** — an Algorithm-1 :class:`~repro_torch.core.planner.Plan` is
  replayed against a freshly built :class:`~repro_torch.core.planner.PlanStructure`:
  every step's state must be enterable and feasible, its round cost must
  reprice identically, reconfiguration is charged exactly when the edge set
  changes (zero on stay-put), overlap charges only the excess over the
  previous round, and the totals must sum.
* **Mode monotonicity** — for the same scenario, planned cost under
  ``overlap`` ≤ ``partial`` ≤ ``serial`` reconfiguration pricing (partial is
  capped at the full-fabric delay; overlap only subtracts).
* **Concurrent accounting** — a :class:`~repro_torch.core.planner.ConcurrentPlan`
  is replayed through the planner's own joint evaluator: comm/reconfig
  decomposition must match, reconfiguration is charged only on *union*
  edge-set changes, every group's traffic must route inside its own
  allocated topology, and the never-worse-than-sequential bound must hold.

All checks return :class:`InvariantViolation` lists; :func:`assert_invariants`
raises :class:`PlanInvariantError` on any non-empty result.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from collections import Counter

from ..core.circuits import CircuitRequest, MZIMesh, route_circuits, validate_routes
from ..core.cost_model import (
    HardwareParams,
    round_cost_from_factors,
    round_structure_key,
)
from ..core.fibers import route_fibers, server_grid
from ..core.planner import (
    HierarchicalPlan,
    Plan,
    ConcurrentPlan,
    _JointState,
    _pod_standard_set,
    build_structure,
    plan,
)
from ..core.schedules import Schedule, pod_subschedules
from ..core.topology import Topology, induced_topology, quotient_topology

_REL_TOL = 1e-9
_ABS_TOL = 1e-12


def _close(a: float, b: float) -> bool:
    return math.isclose(a, b, rel_tol=_REL_TOL, abs_tol=_ABS_TOL)


@dataclass(frozen=True)
class InvariantViolation:
    kind: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"{self.where} [{self.kind}] {self.message}"


class PlanInvariantError(AssertionError):
    def __init__(self, violations: Sequence[InvariantViolation]):
        self.violations = tuple(violations)
        lines = [f"{len(violations)} invariant violation(s)"]
        lines += [f"  {v}" for v in violations]
        super().__init__("\n".join(lines))


# ------------------------------------------------------------ round feasibility


def check_round_feasibility(
    schedule: Schedule,
    hw: Optional[HardwareParams] = None,
    *,
    tx_limit: Optional[int] = None,
    rx_limit: Optional[int] = None,
) -> List[InvariantViolation]:
    """Fan-out vs. transmitter budget, permutation validity, endpoint sanity.

    Limits default to ``hw.tx_per_gpu`` / ``hw.rx_per_gpu`` (1 each when no
    ``hw`` is given — the paper's single-Tx tile, where every round must be
    a permutation so one circuit set realizes it).
    """
    tx = tx_limit if tx_limit is not None else (hw.tx_per_gpu if hw else 1)
    rx = rx_limit if rx_limit is not None else (hw.rx_per_gpu if hw else 1)
    out: List[InvariantViolation] = []
    n = schedule.n
    for ri, rnd in enumerate(schedule.rounds):
        fan_out: Dict[int, int] = {}
        fan_in: Dict[int, int] = {}
        for t in rnd.transfers:
            if not (0 <= t.src < n and 0 <= t.dst < n):
                out.append(InvariantViolation(
                    "bad-rank", f"round {ri}",
                    f"transfer {t.src}->{t.dst} outside [0,{n})"))
                continue
            if t.src == t.dst:
                out.append(InvariantViolation(
                    "self-transfer", f"round {ri}", f"rank {t.src} sends to itself"))
                continue
            fan_out[t.src] = fan_out.get(t.src, 0) + 1
            fan_in[t.dst] = fan_in.get(t.dst, 0) + 1
        for r, k in sorted(fan_out.items()):
            if k > tx:
                out.append(InvariantViolation(
                    "tx-limit", f"round {ri}",
                    f"rank {r} drives {k} circuits but has {tx} transmitter(s)"))
        for r, k in sorted(fan_in.items()):
            if k > rx:
                out.append(InvariantViolation(
                    "rx-limit", f"round {ri}",
                    f"rank {r} terminates {k} circuits but has {rx} receiver(s)"))
        if tx == 1 and rx == 1 and rnd.transfers and not rnd.is_permutation():
            out.append(InvariantViolation(
                "not-permutation", f"round {ri}",
                "single-Tx tiles need each round to be a permutation"))
    return out


# --------------------------------------------------------- circuit realizability


def _default_mesh(n: int) -> Tuple[MZIMesh, List[int]]:
    """A square MZI mesh with one attachment node per rank, spread over the
    grid (ranks pinned to distinct switches, row-major with stride).  The
    side is 2·(⌈√n⌉): enough waveguide capacity that any permutation round
    routes under the default WDM binning (see ``check_circuit_realizability``)."""
    side = 2 * max(2, math.isqrt(max(n - 1, 1)) + 1)
    mesh = MZIMesh(side, side)
    stride = max(1, mesh.n_nodes // max(n, 1))
    nodes = [(r * stride) % mesh.n_nodes for r in range(n)]
    assert len(set(nodes)) == n
    return mesh, nodes


def check_circuit_realizability(
    schedule: Schedule,
    *,
    mesh: Optional[MZIMesh] = None,
    rank_nodes: Optional[Sequence[int]] = None,
    n_wavelengths: Optional[int] = None,
    check_fibers: bool = True,
    gpus_per_server: int = 4,
) -> List[InvariantViolation]:
    """Route every distinct round structure with Algorithms 3 and 4.

    Alg. 3: each round's (src, dst) pairs become circuit requests on an MZI
    mesh (default: square grid with ranks pinned to spread-out switches);
    the round is realizable iff no request fails, and the router's output is
    re-validated with ``validate_routes``.  Transmitters are binned into
    ``n_wavelengths`` WDM groups (wavelength = src mod bins, default
    ``max(2, n // 2)``), so Alg. 3's per-λ-per-waveguide exclusivity is
    exercised without modelling one λ per tile.  Alg. 4: the same pairs,
    collapsed to server-to-server demands on a ``server_grid``, must route
    with flow conservation (every route connects its endpoints; the
    reported per-edge loads must equal a recount over the routes).

    Rounds are deduplicated by pair-structure key, so e.g. a ring's n−1
    identical-permutation rounds are routed once.
    """
    out: List[InvariantViolation] = []
    n = schedule.n
    if mesh is None or rank_nodes is None:
        mesh, rank_nodes = _default_mesh(n)
    bins = n_wavelengths if n_wavelengths is not None else max(2, n // 2)
    n_servers = max(1, -(-n // gpus_per_server))
    fiber_topo = server_grid(n_servers) if (check_fibers and n_servers > 1) else None

    seen: Dict[object, int] = {}
    for ri, rnd in enumerate(schedule.rounds):
        pairs = [t.pair() for t in rnd.transfers]
        if not pairs:
            continue
        key = round_structure_key(pairs)
        if key in seen:
            continue
        seen[key] = ri

        reqs = [CircuitRequest(rank_nodes[s], rank_nodes[d], s % bins)
                for s, d in pairs if 0 <= s < n and 0 <= d < n and s != d]
        if len(reqs) != len(pairs):
            out.append(InvariantViolation(
                "bad-request", f"round {ri}",
                "transfers with invalid endpoints cannot be routed"))
            continue
        result = route_circuits(mesh, reqs)
        if result.failed:
            out.append(InvariantViolation(
                "mesh-unroutable", f"round {ri}",
                f"Alg. 3 failed to place {len(result.failed)} of "
                f"{len(reqs)} circuits on a {mesh.rows}x{mesh.cols} mesh"))
        else:
            try:
                validate_routes(mesh, result, reqs)
            except AssertionError as e:  # router broke its own invariant
                out.append(InvariantViolation(
                    "mesh-invalid-routes", f"round {ri}", str(e)))

        if fiber_topo is not None:
            demands = [(s // gpus_per_server, d // gpus_per_server)
                       for s, d in pairs if s // gpus_per_server != d // gpus_per_server]
            if not demands:
                continue
            try:
                routing = route_fibers(fiber_topo, demands)
            except RuntimeError as e:
                out.append(InvariantViolation(
                    "fiber-unroutable", f"round {ri}", str(e)))
                continue
            recount: Dict[Tuple[int, int], int] = {}
            for (s, d), path in zip(demands, routing.routes):
                if path[0] != s or path[-1] != d:
                    out.append(InvariantViolation(
                        "fiber-bad-route", f"round {ri}",
                        f"route for {s}->{d} connects {path[0]}->{path[-1]}"))
                for a, b in zip(path[:-1], path[1:]):
                    recount[(a, b)] = recount.get((a, b), 0) + 1
            if recount != {e: c for e, c in routing.edge_load.items() if c}:
                out.append(InvariantViolation(
                    "fiber-load-mismatch", f"round {ri}",
                    "Alg. 4 edge loads disagree with a recount over its routes"))
            elif routing.z != max(recount.values(), default=0):
                out.append(InvariantViolation(
                    "fiber-z-mismatch", f"round {ri}",
                    f"z={routing.z} but max recounted load is "
                    f"{max(recount.values(), default=0)}"))
    return out


# -------------------------------------------------------------- plan accounting


def check_plan(
    p: Plan, g0: Topology, standard: Sequence[Topology]
) -> List[InvariantViolation]:
    """Replay an Algorithm-1 plan against a freshly built structure."""
    out: List[InvariantViolation] = []
    sched, hw = p.schedule, p.hw
    structure = build_structure(g0, standard, sched, hw)
    states = structure.states

    if len(p.steps) != len(sched.rounds):
        out.append(InvariantViolation(
            "step-count", "plan",
            f"{len(p.steps)} steps for {len(sched.rounds)} rounds"))
        return out

    prev = structure.g0_idx
    prev_comm = 0.0
    total = 0.0
    for i, step in enumerate(p.steps):
        where = f"step {i}"
        if step.round_index != i:
            out.append(InvariantViolation(
                "round-index", where, f"round_index={step.round_index}"))
        s = step.state_idx
        if not 0 <= s < len(states):
            out.append(InvariantViolation(
                "state-index", where, f"state_idx={s} of {len(states)}"))
            return out
        if step.topo_name != states[s].topo.name:
            out.append(InvariantViolation(
                "state-name", where,
                f"step names {step.topo_name!r}, structure has "
                f"{states[s].topo.name!r}"))
        if s != prev and not structure.enterable[i, s]:
            out.append(InvariantViolation(
                "entry", where,
                f"state {states[s].topo.name} is not enterable at round {i}"))
        if not structure.feasible[i, s]:
            out.append(InvariantViolation(
                "infeasible-state", where,
                f"round {i} does not route on {states[s].topo.name}"))
        want = round_cost_from_factors(
            int(structure.dilation[i, s]), int(structure.congestion[i, s]),
            bool(structure.feasible[i, s]), sched.rounds[i].size, hw)
        if not _close(step.cost.total, want.total):
            out.append(InvariantViolation(
                "round-cost", where,
                f"step prices {step.cost.total:.6g}, repricing gives "
                f"{want.total:.6g}"))
        if step.reconfigured != (s != prev):
            out.append(InvariantViolation(
                "reconfigured-flag", where,
                f"reconfigured={step.reconfigured} but state "
                f"{'changed' if s != prev else 'stayed'}"))
        want_rc = float(structure.trans[prev, s])
        if hw.overlap and i > 0:
            want_rc = max(0.0, want_rc - prev_comm)
        if s == prev and step.reconfig_cost != 0.0:
            out.append(InvariantViolation(
                "reconfig-on-stay", where,
                f"charged {step.reconfig_cost:.6g} without an edge-set change"))
        elif not _close(step.reconfig_cost, want_rc):
            out.append(InvariantViolation(
                "reconfig-cost", where,
                f"step charges {step.reconfig_cost:.6g}, transition table "
                f"gives {want_rc:.6g}"))
        total += step.cost.total + step.reconfig_cost
        prev_comm = step.cost.total
        prev = s
    if not _close(total, p.total_cost):
        out.append(InvariantViolation(
            "total-cost", "plan",
            f"steps sum to {total:.6g}, plan claims {p.total_cost:.6g}"))
    final = states[prev].topo if p.steps else g0
    if p.final_topology is not None and p.final_topology.edges != final.edges:
        out.append(InvariantViolation(
            "final-topology", "plan",
            "final_topology does not match the last step's state"))
    return out


def _prefixed(
    violations: Sequence[InvariantViolation], prefix: str
) -> List[InvariantViolation]:
    return [
        InvariantViolation(v.kind, f"{prefix}: {v.where}", v.message)
        for v in violations
    ]


def check_hierarchical_plan(
    hp: HierarchicalPlan, g0: Topology, standard: Sequence[Topology]
) -> List[InvariantViolation]:
    """Replay a two-level hierarchical plan: both planning levels, the
    pod decomposition itself, and the stitching arithmetic.

    * every representative pod plan replays through :func:`check_plan`
      against the pod's induced fabric (violations prefixed ``pod p``),
      and the coarse inter-pod plan against the quotient fabric
      (prefixed ``inter``);
    * **containment/conservation** — per round, each pod's executed
      transfers (its shared representative plan, mapped to the pod's local
      ids) must be exactly the original round's traffic inside that pod,
      and the declared ``boundary`` pod-pair multiplicities must be exactly
      the original cross-pod traffic — nothing dropped, invented, or
      leaked across a pod boundary;
    * **stitching** — ``round_costs[i]`` must equal the max over groups of
      round ``i``'s comm + reconfig (barrier-synced independent groups),
      and ``total_cost`` their sum.

    With one pod the plan *is* the flat exact DP and delegates to
    :func:`check_plan` on the caller's inputs.
    """
    out: List[InvariantViolation] = []
    sched = hp.schedule
    n, R, P = sched.n, len(sched.rounds), len(hp.pods)

    if sorted(r for pod in hp.pods for r in pod) != list(range(n)):
        out.append(InvariantViolation(
            "pods-not-partition", "pods",
            f"pods do not partition ranks 0..{n - 1} exactly once"))
        return out
    if len(hp.pod_plans) != P:
        out.append(InvariantViolation(
            "pod-plan-count", "pods",
            f"{len(hp.pod_plans)} pod plans for {P} pods"))
        return out
    for pp in hp.pod_plans:
        if pp.ranks != hp.pods[pp.pod_index]:
            out.append(InvariantViolation(
                "pod-ranks", f"pod {pp.pod_index}",
                "PodPlan.ranks disagrees with the pod partition"))
            return out

    if P == 1:
        if hp.inter_plan is not None:
            out.append(InvariantViolation(
                "inter-plan", "inter",
                "single-pod plan carries an inter-pod phase"))
        out += _prefixed(
            check_plan(hp.pod_plans[0].plan, g0, standard), "pod 0")
        group_plans: List[Plan] = [hp.pod_plans[0].plan]
    else:
        intra, rep, boundary = pod_subschedules(sched, hp.pods)
        if hp.rep != rep:
            out.append(InvariantViolation(
                "rep-map", "pods",
                "stored pod-representative map disagrees with the "
                "schedule's pod equivalence classes"))
        for p in sorted(set(hp.rep)):
            ranks = hp.pods[p]
            pod_g0 = induced_topology(g0, ranks, name=f"{g0.name}|pod{p}")
            out += _prefixed(
                check_plan(
                    hp.pod_plans[p].plan, pod_g0, _pod_standard_set(len(ranks))
                ),
                f"pod {p}",
            )
        if hp.inter_plan is None:
            out.append(InvariantViolation(
                "inter-plan", "inter", f"{P} pods but no inter-pod plan"))
            return out
        coarse_g0 = quotient_topology(g0, hp.pods, name=f"{g0.name}/pods")
        if hp.inter_plan.schedule.n != P:
            out.append(InvariantViolation(
                "inter-n", "inter",
                f"coarse schedule spans {hp.inter_plan.schedule.n} "
                f"super-ranks for {P} pods"))
            return out
        out += _prefixed(
            check_plan(hp.inter_plan, coarse_g0, _pod_standard_set(P)),
            "inter",
        )
        if len(hp.inter_plan.schedule.rounds) != R:
            out.append(InvariantViolation(
                "inter-rounds", "inter",
                f"coarse schedule has {len(hp.inter_plan.schedule.rounds)} "
                f"rounds for horizon {R}"))
            return out
        group_plans = [hp.pod_plans[p].plan for p in sorted(set(hp.rep))]
        group_plans.append(hp.inter_plan)

    # ---- containment / conservation against the original schedule
    pod_of = [0] * n
    local_of = [0] * n
    for p, ranks in enumerate(hp.pods):
        for j, r in enumerate(ranks):
            pod_of[r] = p
            local_of[r] = j
    if len(hp.boundary) != R:
        out.append(InvariantViolation(
            "boundary-length", "boundary",
            f"{len(hp.boundary)} boundary rounds for horizon {R}"))
        return out
    for i, rnd in enumerate(sched.rounds):
        cross: Counter = Counter()
        inside: List[Counter] = [Counter() for _ in range(P)]
        for t in rnd.transfers:
            if t.src == t.dst:
                continue
            ps, pd = pod_of[t.src], pod_of[t.dst]
            if ps == pd:
                inside[ps][(local_of[t.src], local_of[t.dst])] += 1
            else:
                cross[(ps, pd)] += 1
        if tuple(sorted(cross.items())) != hp.boundary[i]:
            out.append(InvariantViolation(
                "boundary-conservation", f"round {i}",
                "declared cross-pod pod-pair multiplicities disagree with "
                "the schedule's actual cross-pod traffic"))
        if P > 1 and hp.inter_plan is not None:
            crnd = hp.inter_plan.schedule.rounds[i]
            executed = Counter(
                (t.src, t.dst) for t in crnd.transfers if t.src != t.dst)
            if set(executed) != set(cross):
                out.append(InvariantViolation(
                    "inter-containment", f"round {i}",
                    "coarse round's pod pairs are not exactly the round's "
                    "cross-pod pairs"))
            if crnd.size != rnd.size:
                out.append(InvariantViolation(
                    "inter-size", f"round {i}",
                    f"coarse round carries {crnd.size} bytes, original "
                    f"round {rnd.size}"))
        for pp in hp.pod_plans:
            psched = pp.plan.schedule
            if len(psched.rounds) != R:
                out.append(InvariantViolation(
                    "pod-rounds", f"pod {pp.pod_index}",
                    f"pod plan has {len(psched.rounds)} rounds for "
                    f"horizon {R}"))
                return out
            prnd = psched.rounds[i]
            executed = Counter(
                (t.src, t.dst) for t in prnd.transfers if t.src != t.dst)
            if executed != inside[pp.pod_index]:
                out.append(InvariantViolation(
                    "pod-containment", f"pod {pp.pod_index} round {i}",
                    "pod's executed transfers are not exactly the original "
                    "round's traffic inside the pod"))
            if prnd.size != rnd.size:
                out.append(InvariantViolation(
                    "pod-size", f"pod {pp.pod_index} round {i}",
                    f"pod round carries {prnd.size} bytes, original round "
                    f"{rnd.size}"))

    # ---- stitching arithmetic: barrier-synced independent groups
    if len(hp.round_costs) != R:
        out.append(InvariantViolation(
            "round-costs-length", "stitching",
            f"{len(hp.round_costs)} round costs for horizon {R}"))
        return out
    for i in range(R):
        want = max((gp.steps[i].total for gp in group_plans), default=0.0)
        if not _close(hp.round_costs[i], want):
            out.append(InvariantViolation(
                "round-cost-stitching", f"round {i}",
                f"stitched cost {hp.round_costs[i]:.6g}, slowest group "
                f"gives {want:.6g}"))
    if not _close(hp.total_cost, sum(hp.round_costs)):
        out.append(InvariantViolation(
            "total-cost", "stitching",
            f"round costs sum to {sum(hp.round_costs):.6g}, plan claims "
            f"{hp.total_cost:.6g}"))
    if hp.final_topology is not None:
        out.append(InvariantViolation(
            "final-topology", "stitching",
            "hierarchical plans cannot thread a single final topology"))
    return out


def check_mode_monotonicity(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
    r_link: Optional[float] = None,
) -> List[InvariantViolation]:
    """Planned cost must satisfy overlap ≤ partial ≤ serial pointwise.

    Partial reconfiguration is capped at the full-fabric delay, so for every
    transition it is ≤ serial; overlap only ever subtracts.  The optimal
    plan under a pointwise-cheaper pricing can therefore never cost more.
    """
    if r_link is None:
        r_link = hw.reconfig_delay_per_link
    if r_link is None:
        n_edges = max(len(g0.edges), 1)
        r_link = hw.reconfig_delay / (2 * n_edges)
    serial = replace(hw, reconfig_delay_per_link=None, overlap=False)
    partial = serial.with_link_reconfig(r_link)
    overlap = serial.with_link_reconfig(r_link, overlap=True)
    costs = {m.reconfig_mode: plan(g0, standard, schedule, m).total_cost
             for m in (serial, partial, overlap)}
    out: List[InvariantViolation] = []
    if costs["partial"] > costs["serial"] + _ABS_TOL + _REL_TOL * costs["serial"]:
        out.append(InvariantViolation(
            "mode-monotonicity", "partial vs serial",
            f"partial {costs['partial']:.6g} > serial {costs['serial']:.6g}"))
    if costs["overlap"] > costs["partial"] + _ABS_TOL + _REL_TOL * costs["partial"]:
        out.append(InvariantViolation(
            "mode-monotonicity", "overlap vs partial",
            f"overlap {costs['overlap']:.6g} > partial {costs['partial']:.6g}"))
    return out


# -------------------------------------------------------- concurrent accounting


def check_concurrent_plan(
    cp: ConcurrentPlan, g0: Topology, standard: Sequence[Topology]
) -> List[InvariantViolation]:
    """Replay a joint plan through the planner's own evaluator."""
    out: List[InvariantViolation] = []
    schedules = [g.schedule for g in cp.groups]
    structures = [build_structure(g0, standard, sch, cp.hw) for sch in schedules]
    # offsets=() predates the arrival-offset field (and means all-zero)
    ev = _JointState(
        g0, structures, schedules, cp.hw, offsets=cp.offsets or None
    )

    seqs = []
    for gi, grp in enumerate(cp.groups):
        if len(grp.states) != cp.n_rounds:
            out.append(InvariantViolation(
                "seq-length", f"group {gi}",
                f"{len(grp.states)} states for horizon {cp.n_rounds}"))
            return out
        ns = len(structures[gi].states)
        for i, s in enumerate(grp.states):
            if not 0 <= s < ns:
                out.append(InvariantViolation(
                    "state-index", f"group {gi} round {i}", f"state {s} of {ns}"))
                return out
            name = structures[gi].states[s].topo.name
            if grp.state_names[i] != name:
                out.append(InvariantViolation(
                    "state-name", f"group {gi} round {i}",
                    f"plan names {grp.state_names[i]!r}, structure has {name!r}"))
        seqs.append(tuple(grp.states))

    total, comm, reconf, final_vec = ev.evaluate(seqs)
    if not _close(total, cp.joint_cost):
        out.append(InvariantViolation(
            "joint-cost", "plan",
            f"evaluator gives {total:.6g}, plan claims {cp.joint_cost:.6g}"))
    if not _close(float(sum(comm)), cp.comm_cost):
        out.append(InvariantViolation(
            "comm-cost", "plan",
            f"evaluator gives {sum(comm):.6g}, plan claims {cp.comm_cost:.6g}"))
    if not _close(float(sum(reconf)), cp.reconfig_cost):
        out.append(InvariantViolation(
            "reconfig-cost", "plan",
            f"evaluator gives {sum(reconf):.6g}, plan claims "
            f"{cp.reconfig_cost:.6g}"))

    # reconfig charged only on union edge-set changes
    prev = ev.g0_vec
    for i in range(cp.n_rounds):
        u = ev.union_vec([seqs[g][i] for g in range(ev.G)])
        if not np.any(prev ^ u) and reconf[i] != 0.0:
            out.append(InvariantViolation(
                "reconfig-without-change", f"round {i}",
                f"charged {reconf[i]:.6g} with an unchanged union edge set"))
        prev = u

    # every group's traffic routes inside its own allocated topology
    # (joint-round indices: a group with an arrival offset moves traffic
    # only inside its [offset, offset + rounds) window; loads() is empty
    # outside it and the check below is vacuous there)
    for g in range(ev.G):
        for i in range(ev.R):
            if not ev.pairs[g][i]:
                continue
            ld = ev.loads(g, i, seqs[g][i])
            if ld is None:
                out.append(InvariantViolation(
                    "group-unroutable", f"group {g} round {i}",
                    f"traffic does not route on allocated state "
                    f"{structures[g].states[seqs[g][i]].topo.name}"))
                continue
            idx, _ = ld
            alloc = ev.inc[g][seqs[g][i]]
            if idx.shape[0] and not alloc[idx].all():
                out.append(InvariantViolation(
                    "alloc-escape", f"group {g} round {i}",
                    "routed load touches edges outside the group's allocation"))

    # never worse than the sequential-independent baseline
    seq_cost = float(sum(g.solo.total_cost for g in cp.groups))
    if not _close(seq_cost, cp.sequential_cost):
        out.append(InvariantViolation(
            "sequential-cost", "plan",
            f"solo plans sum to {seq_cost:.6g}, plan claims "
            f"{cp.sequential_cost:.6g}"))
    if cp.serialized != (cp.joint_cost > cp.sequential_cost):
        out.append(InvariantViolation(
            "serialized-flag", "plan",
            f"serialized={cp.serialized} with joint {cp.joint_cost:.6g} vs "
            f"sequential {cp.sequential_cost:.6g}"))
    bound = min(cp.joint_cost, cp.sequential_cost)
    if cp.total_cost > bound + _ABS_TOL + _REL_TOL * bound:
        out.append(InvariantViolation(
            "never-worse", "plan",
            f"total {cp.total_cost:.6g} exceeds min(joint, sequential) "
            f"{bound:.6g}"))
    return out


# ------------------------------------------------------------------ aggregation


def check_schedule(
    schedule: Schedule,
    hw: Optional[HardwareParams] = None,
    *,
    realizability: bool = False,
) -> List[InvariantViolation]:
    """Round feasibility (+ optionally Alg. 3/4 realizability) for a schedule."""
    out = check_round_feasibility(schedule, hw)
    if realizability:
        out += check_circuit_realizability(schedule)
    return out


def assert_invariants(violations: Sequence[InvariantViolation]) -> None:
    if violations:
        raise PlanInvariantError(violations)
