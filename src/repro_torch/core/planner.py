"""PCCL's reconfiguration planner (paper Algorithm 1).

The paper formulates "when to reconfigure" as an ILP over binary ``t_{i,j}``
(round *i* uses topology *j*) with

* one-topology-per-round (Eq. 4),
* contiguous use of round-derived ideal topologies (Eq. 5: an ideal graph can
  only be *entered* in the round that generates it, then carried forward), and
* reconfiguration cost paid on a topology change between consecutive rounds
  (Eq. 7), with per-round cost = CommCost (Algorithm 2) + ReconfCost.

That constraint structure is a shortest path over a tiny layered graph, so the
primary solver here is an **exact dynamic program** (`plan`):

    f(i, s) = CommCost(topo(s), R_i, w_i)
              + min over admissible predecessors p of [ f(i-1, p) + T_i(p, s) ]

where the state space is the edge-set-deduplicated union of {G0} ∪ S ∪
{ideal(R_k)}.  Deduplication matters for fidelity: e.g. every round of a ring
schedule has the *same* ideal graph, so staying on it must not re-pay ``r``
(paper Eq. 7 charges only on change).

Structure / numeric split
-------------------------
Everything the buffer size touches is a *price*; everything expensive is
*structure*.  The planner therefore runs in two phases:

* **Structure phase** (:func:`build_structure`, size-independent): the
  deduplicated state set, the per-(round, state) dilation/congestion integer
  matrices ``(D, C)`` (Algorithm 2 routing, served by
  ``cost_model.STRUCTURE_TABLE`` keyed on (edge-set, pair-multiset) so
  structurally identical rounds are routed once), and the pairwise
  reconfiguration table (``_transition_costs``: an edge-incidence boolean
  matrix and one vectorized symmetric-difference count, memoized across
  calls).
* **Numeric phase** (cheap): price ``(D, C)`` at the requested α/β/w and run
  the DP.  The DP value table is batched over a *size axis* — ``f`` has shape
  ``(len(sizes), ns)`` — so :func:`plan_sweep` prices an entire buffer-size
  sweep from a single structure phase.  ``plan`` is the K=1 special case of
  the same code path, which makes sweep plans bit-identical to a per-size
  ``plan`` loop (same step sequence, same totals, same tie-breaking).

The transition cost ``T_i(p, s)`` generalizes the paper's ``r·1[p≠s]``
(``cost_model.reconfig_cost``):

* serial (default): the full fabric delay ``r`` on any change — the paper's
  pessimistic model, bit-identical to the original planner;
* partial (``hw.reconfig_delay_per_link``): ``r_link`` per changed directed
  circuit, capped at ``r`` — only the links that differ are reprogrammed;
* overlapped (``hw.overlap``): ``max(0, ReconfCost(p, s) − CommCost_{i−1}(p))``
  for ``i ≥ 1`` — round *i*'s reprogramming is hidden behind round *i−1*'s
  communication (SWOT-style overlap).  The reconfiguration out of ``G0``
  (round 0) has nothing to hide behind and is always paid in full.

Cross-checks (used in tests):
* `plan_bruteforce` — exhaustive enumeration of all feasible assignments.
* `plan_milp` — the paper's ILP (with pairwise transition variables when
  costs are non-uniform), via scipy HiGHS.

All three agree in every reconfiguration mode; the DP runs in
O(rounds · states²) *numeric* work after O(distinct round structures ·
states) routing calls, and plans the largest scale-up domains in well under
the paper's one-second budget (§4.1).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .cost_model import (
    LARGE_PENALTY,
    STRUCTURE_TABLE,
    HardwareParams,
    RoundCost,
    clear_structure_caches,
    comm_cost_round,
    edge_loads,
    pairs_of,
    reconfig_cost,
    round_cost_from_factors,
    round_structure_key,
)
from .schedules import Round, Schedule, Transfer, pod_subschedules
from .topology import (
    Edge,
    Topology,
    degrade_topology,
    derive_pods,
    induced_topology,
    quotient_topology,
    ring,
    square_dims2,
    torus2d,
)


@dataclass(frozen=True)
class TopoState:
    """One deduplicated candidate topology for the DP/ILP."""

    idx: int
    topo: Topology
    standard: bool                       # in {G0} ∪ S: enterable at any round
    entry_rounds: FrozenSet[int]         # rounds whose ideal graph this is

    def enterable_at(self, i: int) -> bool:
        return self.standard or i in self.entry_rounds


@dataclass(frozen=True)
class PlanStep:
    round_index: int
    state_idx: int
    topo_name: str
    reconfigured: bool
    cost: RoundCost
    reconfig_cost: float

    @property
    def total(self) -> float:
        return self.cost.total + self.reconfig_cost


@dataclass(frozen=True)
class Plan:
    schedule: Schedule
    hw: HardwareParams
    steps: Tuple[PlanStep, ...]
    total_cost: float
    # Topology the fabric is left in after the last round (G0 for empty
    # schedules).  Sessions thread this into the next plan's G0 so
    # back-to-back collectives don't re-pay reconfigurations (api.session).
    final_topology: Optional[Topology] = None

    @property
    def num_reconfigs(self) -> int:
        return sum(1 for s in self.steps if s.reconfigured)

    def breakdown(self) -> Dict[str, float]:
        return {
            "alpha": sum(s.cost.alpha_base for s in self.steps),
            "beta": sum(s.cost.beta_base for s in self.steps),
            "dilation": sum(s.cost.dilation_extra for s in self.steps),
            "congestion": sum(s.cost.congestion_extra for s in self.steps),
            "reconfig": sum(s.reconfig_cost for s in self.steps),
            "total": self.total_cost,
        }


def build_states(
    g0: Topology, standard: Sequence[Topology], schedule: Schedule
) -> List[TopoState]:
    """Dedup {G0} ∪ S ∪ ideal-graphs by directed edge set (input set G of
    Alg. 1 with the bitmap identity of Eq. 7 applied to edge sets)."""
    by_edges: Dict[FrozenSet[Edge], Dict] = {}

    def add(topo: Topology, is_standard: bool, entry_round: Optional[int]) -> None:
        rec = by_edges.setdefault(
            topo.edges, {"topo": topo, "standard": False, "entries": set()}
        )
        rec["standard"] = rec["standard"] or is_standard
        if entry_round is not None:
            rec["entries"].add(entry_round)

    add(g0, True, None)
    for s in standard:
        if s.n != schedule.n:
            raise ValueError(f"standard topology {s.name} has n={s.n} != {schedule.n}")
        add(s, True, None)
    for i, rnd in enumerate(schedule.rounds):
        add(rnd.ideal_topology(schedule.n), False, i)

    states = []
    for k, rec in enumerate(by_edges.values()):
        states.append(
            TopoState(k, rec["topo"], rec["standard"], frozenset(rec["entries"]))
        )
    return states


# -------------------------------------------------------------- structure


@dataclass(frozen=True, eq=False)
class PlanStructure:
    """The size-independent phase of Algorithm 1.

    Holds everything ``plan``/``plan_sweep`` need that does not depend on
    α/β/w: the deduplicated state set, the ``(rounds × states)`` integer
    dilation/congestion matrices plus feasibility mask, and the pairwise
    reconfiguration-cost table.  Building one is the expensive part of
    planning; pricing it at a size is a handful of vectorized ops.  Sessions
    cache these keyed *without* ``nbytes`` (api.session.PcclSession).
    """

    states: Tuple[TopoState, ...]
    g0_idx: int
    n_rounds: int
    dilation: np.ndarray      # (R, ns) int64
    congestion: np.ndarray    # (R, ns) int64
    feasible: np.ndarray      # (R, ns) bool
    enterable: np.ndarray     # (R, ns) bool: Eq. 5 entry constraint
    trans: np.ndarray         # (ns, ns) float64, read-only
    round_keys: Tuple         # per-round pair-multiset keys (for validation)
    # build provenance, checked when a structure is reused (plan_sweep):
    # trans bakes in these reconfig params, g0_idx this start state
    g0_edges: FrozenSet[Edge] = frozenset()
    reconfig_params: Tuple[float, Optional[float]] = (0.0, None)
    # edge-sets of standard topologies dropped by the dead-state prune
    # (infeasible for every round, e.g. disconnected by link failures) —
    # recorded so structure reuse can still validate its standard set
    pruned_standard: FrozenSet[FrozenSet[Edge]] = frozenset()
    # the exact Schedule object this structure was built from, when known:
    # ``_check_structure`` skips the O(rounds × pairs) round-key replay on an
    # identity hit (the session's ``get_schedule`` memo hands every caller
    # one shared object, so warm replans validate in O(1))
    schedule: Optional[Schedule] = None


def _round_structures(
    states: Sequence[TopoState],
    schedule: Schedule,
    round_keys: Optional[Tuple] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple]:
    """(dilation, congestion, feasible, round_keys): Algorithm 2's integer
    factors for every (round, state).

    Structurally identical rounds (same pair multiset) are routed once and
    their rows copied — a ring schedule's n−1 rounds are one routing query
    per state.  Individual (topology, pair-set) queries additionally hit the
    process-wide ``STRUCTURE_TABLE``.

    Non-linear states carry undirected-component labels computed once per
    state; a (state, round) combo whose pairs cross components is marked
    infeasible without routing (no shortest-path walk) — the common case on
    degraded fabrics and coarsened inter-pod graphs, where disconnected
    candidates would otherwise each pay a scipy APSP.  The rounds a
    non-linear state still has to route after the table and component
    shortcuts are priced in one batched predecessor walk
    (``_route_rounds_general``), not one scalar walk per round."""
    from .cost_model import (
        _StackedLinear,
        _bidi_path_labels,
        _linear_labels,
        _route_linear_batch,
        _route_rounds_bidi,
        _route_rounds_general,
    )
    from .topology import _BIG

    n_rounds = len(schedule.rounds)
    ns = len(states)

    # --- deduplicate rounds by pair multiset; route only the distinct ones,
    # then expand rows back to the full round axis with one fancy index.
    # A caller that already knows the per-round keys (replan reuses the
    # validated ``structure.round_keys``) passes them in and skips the
    # O(rounds × pairs) key derivation.
    keys: List = []
    first: Dict = {}
    didx = np.empty(n_rounds, dtype=np.int64)
    d_keys: List = []
    d_arrays: List = []  # (srcs, dsts) index arrays, or None for empty rounds
    for i, rnd in enumerate(schedule.rounds):
        pairs: Optional[List[Tuple[int, int]]] = None
        if round_keys is not None:
            key = round_keys[i]
        else:
            pairs = pairs_of(rnd)
            key = round_structure_key(pairs)
        keys.append(key)
        k = first.get(key)
        if k is None:
            k = len(d_keys)
            first[key] = k
            d_keys.append(key)
            arrs = rnd.__dict__.get("_pair_arrays", False)
            if arrs is False:  # memoized alongside pairs_of: same rounds
                if pairs is None:  # get re-priced across plans and replans
                    pairs = pairs_of(rnd)
                if pairs:
                    arrs = (
                        np.asarray([p[0] for p in pairs]),
                        np.asarray([p[1] for p in pairs]),
                    )
                else:
                    arrs = None
                object.__setattr__(rnd, "_pair_arrays", arrs)
            d_arrays.append(arrs)
        didx[i] = k
    nd = len(d_keys)
    ddil = np.zeros((nd, ns), dtype=np.int64)
    dcong = np.zeros((nd, ns), dtype=np.int64)
    dfeas = np.ones((nd, ns), dtype=bool)

    # Linear states (permutation ideal graphs — usually most of the state
    # set) are routed against each distinct round structure in ONE batched
    # numpy pass over stacked component labels, not per-state calls.
    lin_states: List[TopoState] = []
    lin_labels: List = []
    other_states: List[TopoState] = []
    for s in states:
        lab = _linear_labels(s.topo)
        if lab is not None:
            lin_states.append(s)
            lin_labels.append(lab)
        else:
            other_states.append(s)
    stacked = _StackedLinear(lin_labels) if lin_states else None

    for k in range(nd):
        if d_arrays[k] is None:  # empty round: (0, 0, True) on every topology
            continue
        if stacked is None:
            break
        key = d_keys[k]
        srcs, dsts = d_arrays[k]
        cached = {}
        for s in lin_states:
            hit = STRUCTURE_TABLE.lookup(s.topo, key)
            if hit is not None:
                cached[s.idx] = hit
        if len(cached) == len(lin_states):
            for s_idx, (d, c, ok) in cached.items():
                ddil[k, s_idx], dcong[k, s_idx], dfeas[k, s_idx] = d, c, ok
        else:
            bd, bc, bf = _route_linear_batch(stacked, srcs, dsts)
            for t, s in enumerate(lin_states):
                f3 = (int(bd[t]), int(bc[t]), bool(bf[t]))
                if s.idx not in cached:
                    STRUCTURE_TABLE.store(s.topo, key, f3)
                ddil[k, s.idx], dcong[k, s.idx], dfeas[k, s.idx] = f3

    # Non-linear states: table lookups and the cross-component shortcut
    # first; whatever survives is routed in ONE batched shortest-path walk
    # per state over all its uncached distinct rounds (the warm-replan
    # path's dominant cost was one scalar walk per round here).
    for s in other_states:
        # bidirectional path forests (a ring that lost a link — the typical
        # degraded fabric) route by position arithmetic, no path walk and no
        # per-round component prefilter (the router prices infeasibility)
        bidi = _bidi_path_labels(s.topo)
        lab: Optional[np.ndarray] = None
        pending: List[int] = []
        for k in range(nd):
            if d_arrays[k] is None:
                continue
            f3 = STRUCTURE_TABLE.lookup(s.topo, d_keys[k])
            if f3 is None:
                if bidi is None:
                    if lab is None:
                        lab = _undirected_components(s.topo)
                    srcs, dsts = d_arrays[k]
                    if (lab[srcs] != lab[dsts]).any():
                        # a pair crosses undirected components: unroutable
                        # in any direction, same verdict every routing path
                        # returns
                        f3 = (_BIG, _BIG, False)
                        STRUCTURE_TABLE.store(s.topo, d_keys[k], f3)
                    else:
                        pending.append(k)
                        continue
                else:
                    pending.append(k)
                    continue
            ddil[k, s.idx], dcong[k, s.idx], dfeas[k, s.idx] = f3
        if not pending:
            continue
        if bidi is not None:
            routed = _route_rounds_bidi(bidi, [d_arrays[k] for k in pending])
        else:
            routed = _route_rounds_general(
                s.topo, [d_arrays[k] for k in pending]
            )
        STRUCTURE_TABLE.store_many(
            s.topo, [(d_keys[k], f3) for k, f3 in zip(pending, routed)]
        )
        for k, f3 in zip(pending, routed):
            ddil[k, s.idx], dcong[k, s.idx], dfeas[k, s.idx] = f3

    return ddil[didx], dcong[didx], dfeas[didx], tuple(keys)


def _undirected_components(topo: Topology) -> np.ndarray:
    """Undirected connected-component label per node.  A pair whose endpoints
    sit in different components is unroutable regardless of direction —
    Algorithm 2's feasibility has this as a necessary condition that needs no
    shortest-path computation."""
    parent = list(range(topo.n))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in topo.edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    return np.asarray([find(x) for x in range(topo.n)], dtype=np.int64)


def build_structure(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
) -> PlanStructure:
    """Run the size-independent phase once; see :class:`PlanStructure`.

    Only ``schedule``'s round *structure* (pair multisets) matters — its
    sizes are ignored, so one structure prices any member of a buffer-size
    sweep."""
    states = build_states(g0, standard, schedule)
    dil, cong, feas, keys = _round_structures(states, schedule)
    states, dil, cong, feas, pruned = _prune_dead_states(
        states, g0, dil, cong, feas
    )
    trans = _transition_costs(states, hw)
    enterable = _enterable_mask(states, len(schedule.rounds))
    return PlanStructure(
        states=tuple(states),
        g0_idx=_g0_state(states, g0),
        n_rounds=len(schedule.rounds),
        dilation=dil,
        congestion=cong,
        feasible=feas,
        enterable=enterable,
        trans=trans,
        round_keys=keys,
        g0_edges=g0.edges,
        reconfig_params=(hw.reconfig_delay, hw.reconfig_delay_per_link),
        pruned_standard=pruned,
        schedule=schedule,
    )


def _enterable_mask(states: Sequence[TopoState], n_rounds: int) -> np.ndarray:
    """(rounds × states) Eq. 5 entry mask, column-scattered rather than
    evaluated per cell (R·ns ``enterable_at`` calls add up at n≥1024)."""
    ent = np.zeros((n_rounds, len(states)), dtype=bool)
    for s in states:
        if s.standard:
            ent[:, s.idx] = True
        else:
            for i in s.entry_rounds:
                ent[i, s.idx] = True
    return ent


def _prune_dead_states(
    states: List[TopoState],
    g0: Topology,
    dil: np.ndarray,
    cong: np.ndarray,
    feas: np.ndarray,
) -> Tuple[List[TopoState], np.ndarray, np.ndarray, np.ndarray,
           FrozenSet[FrozenSet[Edge]]]:
    """Drop candidate states that are infeasible for *every* round, before
    the transition table is built — each dead state would otherwise cost a
    row and column of the ns² table plus a DP lane while never being part
    of any finite-cost plan.  G0 is always kept (it is the start state even
    when a degraded fabric cannot route a single round).  Ideal-graph states
    are feasible at their own entry round by construction, so on a healthy
    fabric the mask never fires and plans are bit-identical with or without
    this pass; what it prunes in practice are standard/initial topologies
    disconnected by link failures (``replan``) and coarse super-rank
    candidates that cannot carry a boundary round (``plan_hierarchical``)."""
    if feas.size == 0:  # no rounds: nothing to judge feasibility against
        return states, dil, cong, feas, frozenset()
    keep = feas.any(axis=0)
    keep[_g0_state(states, g0)] = True
    if keep.all():
        return states, dil, cong, feas, frozenset()
    pruned = frozenset(s.topo.edges for s in states if not keep[s.idx])
    states = [
        replace(s, idx=k)
        for k, s in enumerate(s for s in states if keep[s.idx])
    ]
    return states, dil[:, keep], cong[:, keep], feas[:, keep], pruned


# Bounded LRU over (state edge-sets, reconfig params) → transition matrix.
# A session sweeping buffer sizes re-plans the same (states, hw) pair per
# size point; the table is dense but small (ns² floats), so memoizing it
# behind the same lock/LRU discipline as _SP_CACHE removes the rebuild.
# Eviction is size-aware on top of the entry count: an entry is charged its
# array bytes plus its key's edge-set footprint, so 64 n=1024 entries
# (each key alone holds ~1k-edge topologies) cannot pin gigabytes.
_TRANS_CACHE: "OrderedDict[Tuple, np.ndarray]" = OrderedDict()
_TRANS_CACHE_MAX = 64
_TRANS_CACHE_MAX_BYTES = 64 * 1024 * 1024
_TRANS_CACHE_BYTES = [0]  # mutable cell, guarded by _TRANS_CACHE_LOCK
_TRANS_CACHE_LOCK = threading.Lock()


def _trans_entry_charge(key: Tuple, arr: np.ndarray) -> int:
    edge_sets = key[0]
    return int(arr.nbytes) + 120 * sum(len(es) for es in edge_sets) + 512


def trans_cache_stats() -> Tuple[int, int]:
    """(entries, estimated bytes) currently held by the transition memo."""
    with _TRANS_CACHE_LOCK:
        return len(_TRANS_CACHE), _TRANS_CACHE_BYTES[0]


def _transition_costs_update(
    old_trans: np.ndarray,
    states: Sequence[TopoState],
    changed_idx: Sequence[int],
    hw: HardwareParams,
) -> np.ndarray:
    """Rows/columns of the transition table touched by ``changed_idx``,
    recomputed against ``old_trans`` (the pre-mutation table for the same
    state positions).  Exactly the arithmetic of :func:`_transition_costs`
    restricted to the affected pairs — ``|E_p Δ E_s|`` via set symmetric
    difference instead of the full incidence matmul — so a warm replan does
    O(changed · ns) set work, not O(ns²) + an O(ns · |E|) matrix build."""
    trans = np.array(old_trans)  # writable copy; old_trans is read-only
    edge_sets = [s.topo.edges for s in states]
    for c in changed_idx:
        ec = edge_sets[c]
        if hw.reconfig_delay_per_link is None:
            # serial mode needs only 1[E_c ≠ E_s], and state edge sets are
            # pairwise distinct by construction: every off-diagonal entry
            # is the flat delay, no symmetric differences at all
            row = np.full(len(edge_sets), hw.reconfig_delay)
            row[c] = 0.0
        else:
            cnt = np.fromiter(
                (len(ec ^ es) for es in edge_sets),
                dtype=np.float64,
                count=len(edge_sets),
            )
            row = np.minimum(hw.reconfig_delay, hw.reconfig_delay_per_link * cnt)
        trans[c, :] = row
        trans[:, c] = row
    trans.setflags(write=False)
    return trans


def _transition_costs(states: Sequence[TopoState], hw: HardwareParams) -> np.ndarray:
    """trans[p, s] = ReconfCost(topo_p → topo_s); 0 on the diagonal.

    Vectorized: states become rows of a boolean edge-incidence matrix over
    the union of all states' directed edges (edges in no state contribute 0
    to any symmetric difference), and ``|E_p Δ E_s|`` for every pair falls
    out of one matmul: ``|E_p| + |E_s| − 2·|E_p ∩ E_s|``.  States are
    deduplicated by edge set, so every off-diagonal entry is a genuine
    change (serial mode: the constant ``r``, recovering the paper's
    ``r·1[p≠s]``).

    Memoized per (state edge-sets, reconfiguration params); the returned
    array is shared and marked read-only."""
    key = (
        tuple(s.topo.edges for s in states),
        hw.reconfig_delay,
        hw.reconfig_delay_per_link,
    )
    with _TRANS_CACHE_LOCK:
        hit = _TRANS_CACHE.get(key)
        if hit is not None:
            _TRANS_CACHE.move_to_end(key)
            return hit

    ns = len(states)
    edge_union = sorted(set().union(*(s.topo.edges for s in states)) or set())
    index = {e: k for k, e in enumerate(edge_union)}
    # float64 so the Gram matrix goes through BLAS; counts stay exact
    inc = np.zeros((ns, max(len(edge_union), 1)))
    for s in states:
        for e in s.topo.edges:
            inc[s.idx, index[e]] = 1.0
    sizes = inc.sum(axis=1)
    changed = sizes[:, None] + sizes[None, :] - 2.0 * (inc @ inc.T)
    if hw.reconfig_delay_per_link is None:
        trans = np.where(changed > 0, hw.reconfig_delay, 0.0)
    else:
        trans = np.minimum(hw.reconfig_delay, hw.reconfig_delay_per_link * changed)
    trans.setflags(write=False)

    with _TRANS_CACHE_LOCK:
        if key not in _TRANS_CACHE:
            _TRANS_CACHE_BYTES[0] += _trans_entry_charge(key, trans)
        _TRANS_CACHE[key] = trans
        _TRANS_CACHE.move_to_end(key)
        while len(_TRANS_CACHE) > 1 and (
            len(_TRANS_CACHE) > _TRANS_CACHE_MAX
            or _TRANS_CACHE_BYTES[0] > _TRANS_CACHE_MAX_BYTES
        ):
            vkey, varr = _TRANS_CACHE.popitem(last=False)
            _TRANS_CACHE_BYTES[0] -= _trans_entry_charge(vkey, varr)
    return trans


def clear_planner_caches(keep_shortest_paths: bool = False) -> None:
    """Drop the transition memo plus every routing cache below it (structure
    table, shortest paths).  Benchmarks use this to time cold planning;
    ``keep_shortest_paths=True`` retains the pre-split-era ``_SP_CACHE``
    (see ``cost_model.clear_structure_caches``)."""
    with _TRANS_CACHE_LOCK:
        _TRANS_CACHE.clear()
        _TRANS_CACHE_BYTES[0] = 0
    clear_structure_caches(keep_shortest_paths=keep_shortest_paths)


# ---------------------------------------------------------------- numeric


def _price(structure: PlanStructure, schedules: Sequence[Schedule],
           hw: HardwareParams) -> np.ndarray:
    """cost[k, i, s] = CommCost(topo_s, R_i, w_i(size_k)): the numeric phase.

    One vectorized expression over the whole ``(sizes × rounds × states)``
    block, with the identical operation order to
    ``cost_model.round_cost_from_factors`` so batched totals are bit-equal
    to scalar pricing."""
    w = np.array([[r.size for r in sch.rounds] for sch in schedules])  # (K, R)
    dil = structure.dilation[None, :, :]
    cong = structure.congestion[None, :, :]
    priced = hw.alpha * dil + (hw.beta * cong) * w[:, :, None]
    cost = np.where(dil == 0, 0.0, priced)
    return np.where(~structure.feasible[None, :, :], LARGE_PENALTY, cost)


def _effective_transition(
    trans: np.ndarray, cost: np.ndarray, i: int, hw: HardwareParams
) -> np.ndarray:
    """T_i[p, s] for entering round ``i`` on ``s`` from round ``i−1`` on ``p``.

    With overlap enabled, reprogramming round ``i``'s circuits happens while
    round ``i−1`` communicates on ``p``; only the excess is charged.  Round 0
    (``i == 0``) has no previous communication and pays ``trans`` in full.
    """
    if not hw.overlap or i == 0:
        return trans
    return np.maximum(0.0, trans - cost[i - 1][:, None])


def _g0_state(states: Sequence[TopoState], g0: Topology) -> int:
    for s in states:
        if s.topo.edges == g0.edges:
            return s.idx
    raise AssertionError("G0 missing from state set")


def _plans_from_structure(
    structure: PlanStructure,
    schedules: Sequence[Schedule],
    hw: HardwareParams,
) -> List[Plan]:
    """Exact DP over a pre-built structure, batched along the size axis.

    ``f`` is shaped ``(K, ns)`` per round (K = len(schedules)); every numpy
    step mirrors the K=1 recurrence exactly — same candidate sums, same
    argmin tie-breaking (first minimum, stay-put wins ties per Eq. 7's
    charge-only-on-change semantics) — so each returned plan is bit-identical
    to planning its schedule alone."""
    states = structure.states
    g0_idx = structure.g0_idx
    trans = structure.trans
    n_rounds = structure.n_rounds
    K = len(schedules)
    ns = len(states)
    idx = np.arange(ns)
    cost = _price(structure, schedules, hw)          # (K, R, ns)

    INF = float("inf")
    f = np.full((K, n_rounds, ns), INF)
    parent = np.full((K, n_rounds, ns), -1, dtype=np.int64)

    enter0 = structure.enterable[0] | (idx == g0_idx)
    f[:, 0, enter0] = cost[:, 0, enter0] + trans[g0_idx, enter0][None, :]
    parent[:, 0, enter0] = g0_idx

    if K == 1:
        # 2-D specialization of the loop below for the single-schedule case
        # (every plan()/replan() call): diagonal views instead of fancy
        # indexing, full-width wheres instead of masked assignment, no K
        # broadcasting.  Same candidate sums and tie-breaking element for
        # element — plan_sweep's sweep ≡ loop tests pin the two paths to
        # each other bit-for-bit.
        f0, parent0, cost0 = f[0], parent[0], cost[0]
        eff = trans
        cand = np.empty((ns, ns))
        for i in range(1, n_rounds):
            prev = f0[i - 1]
            if hw.overlap:
                eff = np.maximum(0.0, trans - cost0[i - 1][:, None])
            np.add(prev[:, None], eff, out=cand)     # cand[p, s]
            best_p = cand.argmin(axis=0)
            best = cand.min(axis=0)
            stay = np.diagonal(cand)
            prefer_stay = stay <= best
            best = np.where(prefer_stay, stay, best)
            best_p = np.where(prefer_stay, idx, best_p)

            enterable = structure.enterable[i]
            fin = np.isfinite(prev)
            f0[i] = np.where(
                enterable, best + cost0[i],
                np.where(fin, prev + cost0[i], INF),
            )
            parent0[i] = np.where(
                enterable, best_p, np.where(fin, idx, -1)
            )
    else:
        eff = trans[None, :, :]  # constant unless overlap re-derives per round
        cand = np.empty((K, ns, ns))
        for i in range(1, n_rounds):
            prev = f[:, i - 1, :]                    # (K, ns)
            if hw.overlap:
                eff = np.maximum(
                    0.0, trans[None, :, :] - cost[:, i - 1, :, None]
                )
            np.add(prev[:, :, None], eff, out=cand)  # cand[k, p, s]
            best_p = cand.argmin(axis=1)             # (K, ns)
            best = cand.min(axis=1)  # same element argmin names: first min
            # staying put (p == s, zero transition) wins ties, matching
            # Eq. 7's charge-only-on-change semantics
            stay = cand[:, idx, idx]
            prefer_stay = stay <= best
            best = np.where(prefer_stay, stay, best)
            best_p = np.where(prefer_stay, idx[None, :], best_p)

            enterable = structure.enterable[i]
            f[:, i, enterable] = best[:, enterable] + cost[:, i, enterable]
            parent[:, i, enterable] = best_p[:, enterable]
            carry = ~enterable
            if carry.any():
                # Eq. 5: ideal graphs outside their entry round carry only
                fin = np.isfinite(prev[:, carry])
                f[:, i, carry] = np.where(
                    fin, prev[:, carry] + cost[:, i, carry], INF
                )
                parent[:, i, carry] = np.where(fin, idx[carry][None, :], -1)

    last = f[:, n_rounds - 1, :].argmin(axis=1)      # (K,)
    plans: List[Plan] = []
    for k, sched in enumerate(schedules):
        seq = [int(last[k])]
        for i in range(n_rounds - 1, 0, -1):
            seq.append(int(parent[k, i, seq[-1]]))
        seq.reverse()

        steps: List[PlanStep] = []
        prev_idx = g0_idx
        for i, s_idx in enumerate(seq):
            reconf = s_idx != prev_idx
            t = trans[prev_idx, s_idx]
            if hw.overlap and i > 0:
                t = max(0.0, t - cost[k, i - 1, prev_idx])
            steps.append(
                PlanStep(
                    round_index=i,
                    state_idx=s_idx,
                    topo_name=states[s_idx].topo.name,
                    reconfigured=reconf,
                    cost=round_cost_from_factors(
                        int(structure.dilation[i, s_idx]),
                        int(structure.congestion[i, s_idx]),
                        bool(structure.feasible[i, s_idx]),
                        sched.rounds[i].size,
                        hw,
                    ),
                    reconfig_cost=float(t),
                )
            )
            prev_idx = s_idx
        plans.append(
            Plan(
                sched, hw, tuple(steps), float(f[k, n_rounds - 1, seq[-1]]),
                final_topology=states[seq[-1]].topo,
            )
        )
    return plans


def plan(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
) -> Plan:
    """Exact DP solution of Algorithm 1 (any reconfiguration mode)."""
    if len(schedule.rounds) == 0:
        return Plan(schedule, hw, (), 0.0, final_topology=g0)
    structure = build_structure(g0, standard, schedule, hw)
    return _plans_from_structure(structure, [schedule], hw)[0]


def _rescale_schedule(schedule: Schedule, nbytes: float) -> Schedule:
    """Same round structure, every payload scaled to buffer size ``nbytes``."""
    if not schedule.rounds:
        return replace(schedule, buffer_bytes=nbytes)
    factor = nbytes / schedule.buffer_bytes
    return replace(
        schedule,
        buffer_bytes=nbytes,
        rounds=tuple(replace(r, size=r.size * factor) for r in schedule.rounds),
    )


def _check_structure(
    structure: PlanStructure,
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
) -> None:
    """Validate a caller-supplied structure against the planning inputs.

    A structure may have been built from a different schedule, fabric, or
    hardware model — its (D, C) matrices, transition table, and start state
    are only valid for its own."""
    if structure.g0_edges != g0.edges:
        raise ValueError(
            "supplied structure was built for a different G0 edge set"
        )
    if structure.reconfig_params != (
        hw.reconfig_delay, hw.reconfig_delay_per_link
    ):
        raise ValueError(
            "supplied structure was built under different reconfiguration "
            f"parameters {structure.reconfig_params}; its transition table "
            "does not price this hardware model"
        )
    std_edges = {s.topo.edges for s in structure.states if s.standard}
    for topo in standard:
        if (
            topo.edges not in std_edges
            and topo.edges not in structure.pruned_standard
        ):
            raise ValueError(
                f"standard topology {topo.name} is not a state of the "
                "supplied structure"
            )
    if len(schedule.rounds) != structure.n_rounds:
        raise ValueError(
            f"template has {len(schedule.rounds)} rounds; supplied "
            f"structure has {structure.n_rounds}"
        )
    if structure.schedule is schedule:
        # built from this exact (immutable) Schedule object — the per-round
        # key replay below would be comparing the schedule with itself.  The
        # common warm path: get_schedule's memo hands out shared objects.
        return
    for i, rnd in enumerate(schedule.rounds):
        if round_structure_key(pairs_of(rnd)) != structure.round_keys[i]:
            raise ValueError(
                f"template round {i} does not match the supplied "
                "structure's pair multiset"
            )


def plan_sweep(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
    sizes: Sequence[float],
    *,
    schedules: Optional[Sequence[Schedule]] = None,
    structure: Optional[PlanStructure] = None,
) -> List[Plan]:
    """Plan one schedule structure at many buffer sizes — one structure
    phase, one batched numeric phase.

    ``schedule`` donates the round *structure* (which pairs, which rounds);
    ``sizes`` are the per-rank buffer sizes to price.  By default each size
    point reuses ``schedule`` with payloads rescaled proportionally; pass
    ``schedules`` (one per size, e.g. rebuilt via
    ``schedules.get_schedule``) when exact per-size payload arithmetic
    matters — every schedule must share ``schedule``'s round structure.
    Pass ``structure`` to reuse a previously built :class:`PlanStructure`.

    Returns one :class:`Plan` per size, bit-identical (steps and totals) to
    calling :func:`plan` on each size's schedule individually.  (With the
    default rescaling, a rescaled payload ``r.size · (d / d_ref)`` can
    differ in the last ulp from a generator-built one at ``d`` unless the
    size ratio is a power of two — build the sweep's template at the size
    whose exactness matters, or pass ``schedules``.)
    """
    if len(schedule.rounds) == 0:
        sweep = (
            schedules
            if schedules is not None
            else [_rescale_schedule(schedule, float(d)) for d in sizes]
        )
        return [Plan(sch, hw, (), 0.0, final_topology=g0) for sch in sweep]
    if structure is None:
        structure = build_structure(g0, standard, schedule, hw)
    else:
        _check_structure(structure, g0, standard, schedule, hw)
    if schedules is None:
        # rescaled schedules share the template's transfers, so they match
        # the (now template-validated) structure by construction
        schedules = [_rescale_schedule(schedule, float(d)) for d in sizes]
    else:
        if len(schedules) != len(sizes):
            raise ValueError(
                f"got {len(schedules)} schedules for {len(sizes)} sizes"
            )
        for sch in schedules:
            if len(sch.rounds) != structure.n_rounds:
                raise ValueError(
                    f"schedule {sch.algorithm}@{sch.buffer_bytes:g}B has "
                    f"{len(sch.rounds)} rounds; structure has {structure.n_rounds}"
                )
            for i, rnd in enumerate(sch.rounds):
                if round_structure_key(pairs_of(rnd)) != structure.round_keys[i]:
                    raise ValueError(
                        f"schedule {sch.algorithm}@{sch.buffer_bytes:g}B round {i} "
                        "does not match the structure's pair multiset"
                    )
    return _plans_from_structure(structure, schedules, hw)


# ------------------------------------------------- hierarchical planning


@dataclass(frozen=True)
class PodPlan:
    """One pod's slice of a hierarchical plan: the exact DP's plan for the
    pod's intra-pod sub-schedule, expressed over local rank ids
    (``ranks[local]`` is the global rank).  Structurally identical pods
    share one underlying :class:`Plan` object."""

    pod_index: int
    ranks: Tuple[int, ...]
    plan: Plan


@dataclass(frozen=True)
class HierarchicalPlan:
    """A stitched two-level plan: per-pod exact DP plans plus one coarse
    inter-pod plan over the super-rank (quotient) graph.

    Execution model priced here: pods own disjoint circuits and reconfigure
    independently, the boundary network is one more independent group, and
    every round is barrier-synced across groups — so round ``i`` lasts as
    long as its slowest group's reconfiguration + communication,
    ``round_costs[i] = max over groups of (steps[i].cost + reconfig)``, and
    ``total_cost = Σ_i round_costs[i]``.  The inter-pod phase is
    *capacity-optimistic*: each distinct pod pair of a round becomes one
    coarse transfer at the full round payload, so multiple rank pairs
    crossing the same pod pair are assumed to share aggregated boundary
    bandwidth.  ``analysis.invariants.check_hierarchical_plan`` replays both
    levels plus this stitching arithmetic.

    With one pod there is no decomposition: ``pod_plans[0].plan`` *is* the
    flat exact-DP plan (bit-identical steps and totals) and ``inter_plan``
    is ``None``.
    """

    schedule: Schedule
    hw: HardwareParams
    pods: Tuple[Tuple[int, ...], ...]
    rep: Tuple[int, ...]                 # pod → representative pod index
    pod_plans: Tuple[PodPlan, ...]
    inter_plan: Optional[Plan]
    # per-round cross-pod traffic: sorted ((src_pod, dst_pod), multiplicity)
    boundary: Tuple[Tuple[Tuple[Tuple[int, int], int], ...], ...]
    round_costs: Tuple[float, ...]
    total_cost: float
    # like Plan.final_topology, but a stitched fabric state is not a single
    # Topology the session can thread forward — always None
    final_topology: Optional[Topology] = None

    def groups(self) -> Tuple[Plan, ...]:
        """The distinct per-group plans (one per pod equivalence class,
        plus the inter-pod plan when present)."""
        seen: Dict[int, Plan] = {}
        for pp in self.pod_plans:
            seen.setdefault(id(pp.plan), pp.plan)
        out = tuple(seen.values())
        if self.inter_plan is not None:
            out = out + (self.inter_plan,)
        return out

    @property
    def num_reconfigs(self) -> int:
        return sum(g.num_reconfigs for g in self.groups())

    def breakdown(self) -> Dict[str, float]:
        pod_totals = [pp.plan.total_cost for pp in self.pod_plans]
        return {
            "total": self.total_cost,
            "max_pod_total": max(pod_totals, default=0.0),
            "inter_total": (
                self.inter_plan.total_cost if self.inter_plan is not None else 0.0
            ),
            "num_pods": float(len(self.pods)),
        }


def _pod_standard_set(m: int) -> List[Topology]:
    """Standard candidates for an m-node (sub-)fabric — the same ring +
    most-square torus pair ``pccl.default_standard_set`` uses at the top
    level (duplicates dedup away in ``build_states``)."""
    if m < 2:
        return []
    std = [ring(m)]
    a, b = square_dims2(m)
    if a >= 2:  # a 1×m "torus" is just the ring again
        std.append(torus2d(a, b))
    return std


def plan_hierarchical(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
    *,
    pods: Optional[Sequence[Sequence[int]]] = None,
    pod_size: Optional[int] = None,
) -> HierarchicalPlan:
    """Two-level planning: exact DP per pod, exact DP over the coarse
    super-rank graph, stitched (see :class:`HierarchicalPlan`).

    ``pods`` partitions the ranks explicitly; otherwise
    ``topology.derive_pods(n, pod_size)`` cuts contiguous blocks aligned
    with the fabric's torus tiles / ring segments.  Pods with identical
    intra-pod round structure are planned once (``schedules.
    pod_subschedules`` deduplication), so planning cost scales with the
    number of *distinct* pod classes — typically one — plus one coarse
    phase over ``P`` super-ranks, not with ``n``.

    With ``pods=1`` (or ``pod_size=n``) this *is* the flat exact DP on the
    caller's inputs, wrapped: same steps, same total.
    """
    n = schedule.n
    if g0.n != n:
        raise ValueError(f"G0 has n={g0.n}, schedule has n={n}")
    if pods is None:
        pods = derive_pods(n, pod_size)
    else:
        pods = tuple(tuple(p) for p in pods)
    P = len(pods)
    R = len(schedule.rounds)

    if P == 1:
        flat = plan(g0, standard, schedule, hw)
        return HierarchicalPlan(
            schedule=schedule,
            hw=hw,
            pods=pods,
            rep=(0,),
            pod_plans=(PodPlan(0, pods[0], flat),),
            inter_plan=None,
            boundary=tuple(() for _ in range(R)),
            round_costs=tuple(s.total for s in flat.steps),
            total_cost=flat.total_cost,
        )

    intra, rep, boundary = pod_subschedules(schedule, pods)

    rep_plans: Dict[int, Plan] = {}
    for p in sorted(set(rep)):
        ranks = pods[p]
        pod_g0 = induced_topology(g0, ranks, name=f"{g0.name}|pod{p}")
        rep_plans[p] = plan(pod_g0, _pod_standard_set(len(ranks)), intra[p], hw)

    coarse_g0 = quotient_topology(g0, pods, name=f"{g0.name}/pods")
    # rounds crossing the same pod pairs share one coarse transfer tuple —
    # keyed on the pairs alone, since multiplicities (which differ round to
    # round) don't change the capacity-optimistic coarse round
    coarse_transfers: Dict[Tuple, Tuple[Transfer, ...]] = {}
    coarse_rounds = []
    for i in range(R):
        pkey = tuple(pr for pr, _cnt in boundary[i])
        ts = coarse_transfers.get(pkey)
        if ts is None:
            ts = tuple(Transfer(u, v) for u, v in pkey)
            coarse_transfers[pkey] = ts
        coarse_rounds.append(Round(ts, schedule.rounds[i].size))
    coarse_schedule = Schedule(
        schedule.collective,
        f"{schedule.algorithm}@inter",
        P,
        schedule.buffer_bytes,
        tuple(coarse_rounds),
    )
    inter = plan(coarse_g0, _pod_standard_set(P), coarse_schedule, hw)

    group_plans = [rep_plans[p] for p in sorted(set(rep))] + [inter]
    round_costs = tuple(
        max(gp.steps[i].total for gp in group_plans) for i in range(R)
    )
    return HierarchicalPlan(
        schedule=schedule,
        hw=hw,
        pods=pods,
        rep=rep,
        pod_plans=tuple(
            PodPlan(p, pods[p], rep_plans[rep[p]]) for p in range(P)
        ),
        inter_plan=inter,
        boundary=boundary,
        round_costs=round_costs,
        total_cost=float(sum(round_costs)),
    )


# ------------------------------------------------- incremental replanning


def replan(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
    structure: Optional[PlanStructure] = None,
    *,
    changed_edges: Iterable[Edge] = (),
    changed_ranks: Iterable[int] = (),
) -> Tuple[Plan, PlanStructure]:
    """Warm replanning after a fabric mutation: O(affected states) routing
    instead of a cold structure phase.

    ``g0``/``standard`` are the *pre-failure* inputs ``structure`` was built
    from; ``changed_edges`` (directed circuits — pass both directions of a
    dead physical link) and ``changed_ranks`` (every incident circuit dies)
    describe the mutation.  The fault model degrades the initial and
    standard topologies only — round ideal graphs are what the switch
    *programs*, so they regenerate from the schedule unchanged.

    Column-level reuse: degraded states keep their position in the state
    set, so (dilation, congestion, feasibility) columns of states whose
    edge set did not change are copied from ``structure`` and only the
    degraded states — typically 2–3 of hundreds — are re-routed (round
    deduplication and the ``STRUCTURE_TABLE`` still apply).  The transition
    table rebuild is one memoized vectorized pass.  The result is
    bit-identical — same steps, same totals, same tie-breaks — to cold

        plan(degrade(g0), [degrade(s) for s in standard], schedule, hw)

    which is also the fallback whenever column reuse is unsound (no
    ``structure`` supplied, degradation merged two states into one edge
    set, or the supplied structure had already pruned states).  Returns
    ``(plan, structure)`` for the degraded fabric so sessions can cache the
    new structure for subsequent warm paths.
    """
    failed_e = frozenset(changed_edges)
    failed_r = frozenset(changed_ranks)
    d_g0 = degrade_topology(g0, failed_e, failed_r)
    d_std = [degrade_topology(s, failed_e, failed_r) for s in standard]

    def cold() -> Tuple[Plan, PlanStructure]:
        s2 = build_structure(d_g0, d_std, schedule, hw)
        return _plans_from_structure(s2, [schedule], hw)[0], s2

    if len(schedule.rounds) == 0:
        s2 = build_structure(d_g0, d_std, schedule, hw)
        return Plan(schedule, hw, (), 0.0, final_topology=d_g0), s2
    if structure is None:
        return cold()
    _check_structure(structure, g0, standard, schedule, hw)
    if structure.pruned_standard:
        # the old columns do not cover the pruned states; start clean
        return cold()

    # Reconstruct the degraded state set from the old one without replaying
    # ``build_states`` over every round: the fault model touches only the
    # fabric-derived states (G0 + standards, the ones flagged ``standard``),
    # ideal-graph states regenerate from the schedule unchanged.  The
    # rebuild-from-scratch path remains for the cases positional reuse
    # cannot express: a degraded fabric state colliding with another
    # state's edge set (merge), or a state that doubles as a round's ideal
    # graph changing shape (it would split in a cold build).
    old = structure.states
    fresh: Optional[List[TopoState]] = None
    degraded: Dict[int, Topology] = {}
    # positional reuse is only sound when the old fabric states are exactly
    # the caller's {G0} ∪ standard (the documented contract; anything else
    # goes through the rebuild-and-compare path below)
    split = {o.topo.edges for o in old if o.standard} != (
        {g0.edges} | {s.edges for s in standard}
    )
    for o in old:
        if split:
            break
        if not o.standard:
            continue
        d_topo = degrade_topology(o.topo, failed_e, failed_r)
        if d_topo.edges == o.topo.edges:
            continue
        if o.entry_rounds:
            split = True
            break
        degraded[o.idx] = d_topo
    if not split:
        edge_sets = [
            degraded[o.idx].edges if o.idx in degraded else o.topo.edges
            for o in old
        ]
        if len(set(edge_sets)) == len(edge_sets):
            fresh = [
                replace(o, topo=degraded[o.idx]) if o.idx in degraded else o
                for o in old
            ]
    if fresh is None:
        rebuilt = build_states(d_g0, d_std, schedule)
        if len(rebuilt) != len(old) or any(
            f.standard != o.standard or f.entry_rounds != o.entry_rounds
            for f, o in zip(rebuilt, old)
        ):
            # degradation merged or split states: positional column reuse
            # is no longer sound
            return cold()
        fresh = rebuilt
        changed_idx = [
            f.idx for f, o in zip(fresh, old) if f.topo.edges != o.topo.edges
        ]
    else:
        changed_idx = sorted(degraded)
    if not changed_idx:
        return _plans_from_structure(structure, [schedule], hw)[0], structure

    dil = structure.dilation.copy()
    cong = structure.congestion.copy()
    feas = structure.feasible.copy()
    sub = [replace(fresh[i], idx=j) for j, i in enumerate(changed_idx)]
    sdil, scong, sfeas, _skeys = _round_structures(
        sub, schedule, round_keys=structure.round_keys
    )
    dil[:, changed_idx] = sdil
    cong[:, changed_idx] = scong
    feas[:, changed_idx] = sfeas

    states, dil, cong, feas, pruned = _prune_dead_states(
        fresh, d_g0, dil, cong, feas
    )
    if pruned:
        # pruning reindexed the states; positional reuse of the old
        # transition table is off — rebuild it (memoized, vectorized)
        trans = _transition_costs(states, hw)
    else:
        trans = _transition_costs_update(structure.trans, states, changed_idx, hw)
    enterable = _enterable_mask(states, len(schedule.rounds))
    new_structure = PlanStructure(
        states=tuple(states),
        g0_idx=_g0_state(states, d_g0),
        n_rounds=structure.n_rounds,
        dilation=dil,
        congestion=cong,
        feasible=feas,
        enterable=enterable,
        trans=trans,
        round_keys=structure.round_keys,
        g0_edges=d_g0.edges,
        reconfig_params=(hw.reconfig_delay, hw.reconfig_delay_per_link),
        pruned_standard=pruned,
        schedule=schedule,
    )
    return _plans_from_structure(new_structure, [schedule], hw)[0], new_structure


# ------------------------------------------------------------------ oracles


def _round_costs(
    states: Sequence[TopoState], schedule: Schedule, hw: HardwareParams
) -> Tuple[np.ndarray, Dict[Tuple[int, int], RoundCost]]:
    """(cost, objs): cost[i, s] = CommCost(topo_s, R_i, w_i) (Algorithm 2)
    and objs[(i, s)] the full RoundCost decomposition.

    Structurally identical rounds at the same payload size — keyed by
    ``(pair multiset, size)`` — share one row of costs and one set of
    RoundCost objects, so e.g. a ring schedule's n−1 identical rounds are
    priced once even outside ``plan_sweep``."""
    n_rounds = len(schedule.rounds)
    cost = np.empty((n_rounds, len(states)))
    cost_objs: Dict[Tuple[int, int], RoundCost] = {}
    first_row: Dict[Tuple, int] = {}
    for i, rnd in enumerate(schedule.rounds):
        key = (round_structure_key(pairs_of(rnd)), rnd.size)
        j = first_row.get(key)
        if j is not None:
            cost[i] = cost[j]
            for s in states:
                cost_objs[(i, s.idx)] = cost_objs[(j, s.idx)]
            continue
        first_row[key] = i
        for s in states:
            rc = comm_cost_round(s.topo, rnd, None, hw)
            cost[i, s.idx] = rc.total
            cost_objs[(i, s.idx)] = rc
    return cost, cost_objs


def plan_bruteforce(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
) -> float:
    """Exhaustive minimum over all feasible topology assignments (tests only)."""
    states = build_states(g0, standard, schedule)
    n_rounds = len(schedule.rounds)
    cost, _ = _round_costs(states, schedule, hw)
    g0_idx = _g0_state(states, g0)
    trans = _transition_costs(states, hw)
    effs = [_effective_transition(trans, cost, i, hw) for i in range(n_rounds)]
    best = [float("inf")]

    def feasible(prev: int, s: TopoState, i: int) -> bool:
        return s.enterable_at(i) or s.idx == prev

    def dfs(i: int, prev: int, acc: float) -> None:
        if acc >= best[0]:
            return
        if i == n_rounds:
            best[0] = acc
            return
        for s in states:
            if not feasible(prev, s, i):
                continue
            step = cost[i, s.idx] + effs[i][prev, s.idx]
            dfs(i + 1, s.idx, acc + step)

    dfs(0, g0_idx, 0.0)
    return best[0]


def plan_milp(
    g0: Topology,
    standard: Sequence[Topology],
    schedule: Schedule,
    hw: HardwareParams,
) -> float:
    """The paper's ILP (Eqs. 2–7) via scipy HiGHS, for cross-validation.

    Variables: t_{i,j} ∈ {0,1} for each round i and state j, plus — because
    partial/overlapped reconfiguration makes the transition cost depend on
    the *pair* of consecutive topologies, not just "changed or not" — flow
    variables y_{i,p,s} ≥ 0 linearizing t_{i-1,p} ∧ t_{i,s}:

        Σ_s y_{i,p,s} = t_{i-1,p}   ∀ i ≥ 1, p
        Σ_p y_{i,p,s} = t_{i,s}     ∀ i ≥ 1, s

    With binary t each round's y is a one-unit transportation problem whose
    only feasible point is the indicator of the chosen (p, s) pair, so the
    continuous relaxation of y is exact.  Objective:
    Σ t_{i,j}·CommCost + Σ y_{i,p,s}·T_i(p, s), with the round-0 transition
    out of G0 folded into the t_{0,j} coefficients.  Constraint 5 becomes
    t_{i,j} ≤ t_{i-1,j} for non-standard j outside its entry rounds.
    """
    from scipy.optimize import LinearConstraint, milp
    from scipy.sparse import lil_matrix

    states = build_states(g0, standard, schedule)
    n_rounds = len(schedule.rounds)
    ns = len(states)
    cost, _ = _round_costs(states, schedule, hw)
    g0_idx = _g0_state(states, g0)
    trans = _transition_costs(states, hw)

    # variable layout: t vars [0, n_rounds*ns), y vars afterwards
    nt = n_rounds * ns
    nv = nt + max(0, n_rounds - 1) * ns * ns

    def t(i: int, j: int) -> int:
        return i * ns + j

    def y(i: int, p: int, s: int) -> int:  # i >= 1
        return nt + (i - 1) * ns * ns + p * ns + s

    c = np.zeros(nv)
    for i in range(n_rounds):
        for j in range(ns):
            c[t(i, j)] = cost[i, j]
    for j in range(ns):
        c[t(0, j)] += trans[g0_idx, j]
    for i in range(1, n_rounds):
        eff = _effective_transition(trans, cost, i, hw)
        for p in range(ns):
            for s in range(ns):
                c[y(i, p, s)] = eff[p, s]

    rows: List[Tuple[Dict[int, float], float, float]] = []  # (coeffs, lb, ub)

    # Eq. 4: exactly one topology per round
    for i in range(n_rounds):
        rows.append(({t(i, j): 1.0 for j in range(ns)}, 1.0, 1.0))

    # transition-flow consistency
    for i in range(1, n_rounds):
        for p in range(ns):
            coeffs = {y(i, p, s): 1.0 for s in range(ns)}
            coeffs[t(i - 1, p)] = -1.0
            rows.append((coeffs, 0.0, 0.0))
        for s in range(ns):
            coeffs = {y(i, p, s): 1.0 for p in range(ns)}
            coeffs[t(i, s)] = -1.0
            rows.append((coeffs, 0.0, 0.0))

    # Eq. 5 (carry-only for ideal states outside entry rounds)
    for j, s in enumerate(states):
        if s.standard:
            continue
        for i in range(n_rounds):
            if i in s.entry_rounds:
                continue
            if i == 0:
                rows.append(({t(0, j): 1.0}, 0.0, 0.0))
            else:
                rows.append(({t(i, j): 1.0, t(i - 1, j): -1.0}, -np.inf, 0.0))

    A = lil_matrix((len(rows), nv))
    lb = np.empty(len(rows))
    ub = np.empty(len(rows))
    for k, (coeffs, lo, hi) in enumerate(rows):
        for var, coef in coeffs.items():
            A[k, var] = coef
        lb[k] = lo
        ub[k] = hi

    integrality = np.zeros(nv)
    integrality[:nt] = 1.0
    res = milp(
        c=c,
        constraints=LinearConstraint(A.tocsr(), lb, ub),
        integrality=integrality,
        bounds=(0, 1),
    )
    if not res.success:
        raise RuntimeError(f"MILP failed: {res.message}")
    return float(res.fun)


# ------------------------------------------------------- concurrent groups
#
# Real training steps keep several collectives in flight at once — TP
# all-reduce, DP reduce-scatter, PP sends — all sharing one photonic fabric,
# while Algorithm 1 prices each as if it owned every link.  The arbiter below
# plans them *jointly*: each group keeps its own Algorithm-1 state machine
# (its PlanStructure), but a joint round's circuits are the union of the
# per-group allocations, and traffic is priced per *link*:
#
#   comm_i = max_g [ α·D_g(i, s_g) + β·max_{e ∈ routes_g} Σ_h w_h·load_h(e) ]
#
# i.e. every group's round runs at the speed of its most-contended link,
# counting every group's bytes on that link, and the joint round finishes
# when the slowest group does.  With link-disjoint allocations this
# degenerates to max_g (α·D_g + β·C_g·w_g) — the groups genuinely overlap —
# and shared links surface as priced congestion, the same
# α·dilation + β·congestion·w arithmetic as Algorithm 2.  Reconfiguration is
# charged on changes of the *union* edge set (a circuit some group already
# holds is free for a group that needs it next round); finished groups'
# circuits persist, so they never bill later transitions.
#
# Solvers, same discipline as the single-group planner:
#   * `plan_concurrent`  — greedy + refinement: seed every group with its
#     independent (solo) plan, then iterate exact per-group best-response
#     DPs (others fixed) until the joint cost stops improving; several
#     deterministic seeds, best taken.
#   * `plan_concurrent_exact` — exact DP over the product state space
#     (oracle for n ≤ 8 tests).
# The sequential-independent baseline (each group solo-planned cold from
# G0, costs summed — exactly what a per-collective planner bills a step)
# bounds the result: `total_cost = min(joint, sequential)`, so joint
# planning never prices worse than sequential independent planning.

_EMPTY_LOADS = (np.zeros(0, dtype=np.int64), np.zeros(0))
_MISS = object()


@dataclass(frozen=True)
class ConcurrentGroupPlan:
    """One group's slice of a :class:`ConcurrentPlan`."""

    schedule: Schedule
    solo: Plan                      # planned as if the group owned the fabric
    states: Tuple[int, ...]         # chosen state per joint round (carried
                                    # unchanged past the group's last round)
    state_names: Tuple[str, ...]


@dataclass(frozen=True)
class ConcurrentPlan:
    """Joint plan for several collectives sharing one fabric."""

    hw: HardwareParams
    groups: Tuple[ConcurrentGroupPlan, ...]
    n_rounds: int                   # joint horizon = max group offset+rounds
    joint_cost: float               # converged aligned-overlap cost
    sequential_cost: float          # Σ solo costs (time-multiplexed fabric)
    serialized: bool                # joint overlap did not pay; run back-to-back
    comm_cost: float                # joint decomposition (aligned candidate)
    reconfig_cost: float
    final_topology: Optional[Topology] = None
    # per-group arrival-round offsets (empty = every group starts at round 0);
    # the invariant checker replays the joint cost with these
    offsets: Tuple[int, ...] = ()

    @property
    def total_cost(self) -> float:
        """What the arbiter charges, bounded by the sequential baseline —
        the sum of cold fabric-to-itself solo plans, i.e. what today's
        per-collective planner bills a step.  (A real back-to-back run
        would start each group from its predecessor's final topology; the
        baseline deliberately prices the *independent-planning* model the
        arbiter is competing against, not that threaded execution.)"""
        return self.sequential_cost if self.serialized else self.joint_cost

    @property
    def speedup(self) -> float:
        """Planned-cost improvement over sequential independent planning."""
        return self.sequential_cost / self.total_cost if self.total_cost > 0 else 1.0


class _JointState:
    """Shared arrays for joint evaluation and best-response over one
    concurrent instance: the directed-edge universe of every group's states,
    per-group incidence/dilation/feasibility matrices padded to the joint
    horizon, and a memo of per-(group, round, state) link loads.

    ``offsets`` gives each group an *arrival round*: group ``g``'s schedule
    round ``i`` executes at joint round ``i + offsets[g]``, so staggered
    admissions (a serving arbiter admitting requests mid-step) are not
    forced into round-0 alignment.  Before its offset a group moves no
    traffic; it holds ``G0`` by default but may *pre-position* into any
    state enterable at its round 0 (paying the union reconfiguration then —
    which overlapped reconfiguration can hide behind the other groups'
    in-flight rounds, exactly the reconfigure-during-idle-gaps win)."""

    def __init__(
        self,
        g0: Topology,
        structures: Sequence[PlanStructure],
        schedules: Sequence[Schedule],
        hw: HardwareParams,
        *,
        offsets: Optional[Sequence[int]] = None,
    ) -> None:
        self.hw = hw
        self.structures = list(structures)
        self.schedules = list(schedules)
        self.G = len(structures)
        self.rounds_g = [len(sch.rounds) for sch in schedules]
        if offsets is None:
            self.offsets: Tuple[int, ...] = (0,) * self.G
        else:
            self.offsets = tuple(int(o) for o in offsets)
            if len(self.offsets) != self.G:
                raise ValueError(
                    f"got {len(self.offsets)} offsets for {self.G} schedules"
                )
            if any(o < 0 for o in self.offsets):
                raise ValueError(f"offsets must be >= 0, got {self.offsets}")
        self.R = max(o + r for o, r in zip(self.offsets, self.rounds_g))
        universe = set(g0.edges)
        for st in self.structures:
            for s in st.states:
                universe |= s.topo.edges
        self.edges = sorted(universe)
        self.E = max(len(self.edges), 1)
        self._eidx = {e: k for k, e in enumerate(self.edges)}
        self.g0_vec = np.zeros(self.E, dtype=bool)
        for e in g0.edges:
            self.g0_vec[self._eidx[e]] = True

        self.inc: List[np.ndarray] = []      # (ns, E) bool
        self.dil: List[np.ndarray] = []      # (R, ns), padded 0
        self.feas: List[np.ndarray] = []     # (R, ns) bool, padded True
        self.enter: List[np.ndarray] = []    # (R, ns) bool, padded False
        self.sizes: List[np.ndarray] = []    # (R,) bytes/transfer, padded 0
        self.pairs: List[List[List[Tuple[int, int]]]] = []
        self.pair_keys: List[List] = []
        for st, sch, rg, off in zip(
            self.structures, self.schedules, self.rounds_g, self.offsets
        ):
            ns = len(st.states)
            inc = np.zeros((ns, self.E), dtype=bool)
            for s in st.states:
                for e in s.topo.edges:
                    inc[s.idx, self._eidx[e]] = True
            self.inc.append(inc)
            dil = np.zeros((self.R, ns))
            dil[off:off + rg] = st.dilation
            feas = np.ones((self.R, ns), dtype=bool)
            feas[off:off + rg] = st.feasible
            ent = np.zeros((self.R, ns), dtype=bool)
            ent[off:off + rg] = st.enterable
            if off:
                # idle prefix: pre-position into anything round 0 may enter
                ent[:off] = st.enterable[0]
            self.dil.append(dil)
            self.feas.append(feas)
            self.enter.append(ent)
            sz = np.zeros(self.R)
            prs: List[List[Tuple[int, int]]] = []
            keys: List = []
            for i in range(self.R):
                j = i - off
                if 0 <= j < rg:
                    prs.append(pairs_of(sch.rounds[j]))
                    keys.append(st.round_keys[j])
                    sz[i] = sch.rounds[j].size
                else:
                    prs.append([])
                    keys.append(None)
            self.sizes.append(sz)
            self.pairs.append(prs)
            self.pair_keys.append(keys)
        self._loads: Dict[Tuple, Optional[Tuple[np.ndarray, np.ndarray]]] = {}
        self._scratch = np.zeros(self.E)

    # ---------------------------------------------------------- link loads
    def loads(self, g: int, i: int, s: int):
        """(edge-index array, count array) of group ``g``'s round-``i``
        transfers routed on state ``s``'s topology — each group's traffic is
        confined to its own allocation.  ``None`` when unroutable; empty
        arrays for empty rounds and joint rounds outside the group's
        ``[offset, offset + rounds)`` window."""
        if not self.pairs[g][i]:
            return _EMPTY_LOADS
        key = (g, self.pair_keys[g][i], s)
        hit = self._loads.get(key, _MISS)
        if hit is not _MISS:
            return hit
        res = edge_loads(
            self.structures[g].states[s].topo,
            self.pairs[g][i],
            key=self.pair_keys[g][i],
        )
        out: Optional[Tuple[np.ndarray, np.ndarray]] = None
        if res is not None:
            _, pairs_counts = res
            idx = np.asarray([self._eidx[e] for e, _ in pairs_counts], dtype=np.int64)
            cnt = np.asarray([c for _, c in pairs_counts], dtype=np.float64)
            out = (idx, cnt)
        self._loads[key] = out
        return out

    # --------------------------------------------------------- joint costs
    def comm_of(self, states_at_i: Sequence[int], i: int) -> float:
        """Joint communication time of round ``i`` with each group ``g`` on
        state ``states_at_i[g]`` (see the model comment above)."""
        hw = self.hw
        scratch = self._scratch
        active: List[Tuple[int, np.ndarray]] = []
        try:
            for g in range(self.G):
                ld = self.loads(g, i, states_at_i[g])
                if ld is None:
                    return LARGE_PENALTY
                idx, cnt = ld
                if idx.shape[0] == 0:
                    continue
                scratch[idx] += self.sizes[g][i] * cnt
                active.append((g, idx))
            worst = 0.0
            for g, idx in active:
                rc = hw.alpha * float(self.dil[g][i, states_at_i[g]]) + \
                    hw.beta * float(scratch[idx].max())
                if rc > worst:
                    worst = rc
            return worst
        finally:
            for _, idx in active:
                scratch[idx] = 0.0

    def union_vec(self, states_at_i: Sequence[int]) -> np.ndarray:
        u = np.zeros(self.E, dtype=bool)
        for g in range(self.G):
            u |= self.inc[g][states_at_i[g]]
        return u

    def _price_scalar(self, changed: int) -> float:
        if changed == 0:
            return 0.0
        if self.hw.reconfig_delay_per_link is None:
            return self.hw.reconfig_delay
        return min(self.hw.reconfig_delay,
                   self.hw.reconfig_delay_per_link * changed)

    def _price_vec(self, changed: np.ndarray) -> np.ndarray:
        if self.hw.reconfig_delay_per_link is None:
            return np.where(changed > 0.5, self.hw.reconfig_delay, 0.0)
        return np.minimum(self.hw.reconfig_delay,
                          self.hw.reconfig_delay_per_link * changed)

    def evaluate(self, seqs: Sequence[Sequence[int]]):
        """(total, per-round comm, per-round reconfig, final union vector)
        of a full assignment — the single source of joint-cost arithmetic
        (solvers re-evaluate through here, so candidates compare exactly)."""
        comm = [
            self.comm_of([seqs[g][i] for g in range(self.G)], i)
            for i in range(self.R)
        ]
        prev = self.g0_vec
        reconf: List[float] = []
        for i in range(self.R):
            u = self.union_vec([seqs[g][i] for g in range(self.G)])
            t = self._price_scalar(int(np.count_nonzero(prev ^ u)))
            if self.hw.overlap and i > 0:
                t = max(0.0, t - comm[i - 1])
            reconf.append(t)
            prev = u
        return float(sum(comm) + sum(reconf)), comm, reconf, prev

    # ------------------------------------------------------- best response
    def best_response(
        self, seqs: Sequence[Sequence[int]], g: int, others: Sequence[int]
    ) -> Tuple[int, ...]:
        """Exact DP for group ``g`` with the groups in ``others`` frozen at
        their ``seqs`` assignments (groups outside ``others`` are absent).

        Per-round costs are the *joint* comm times (g's state slows other
        groups whose links it shares, and vice versa), and transitions price
        changes of the union edge set — so the DP minimizes exactly the
        quantity :meth:`evaluate` reports, restricted to ``g``'s coordinate.
        """
        hw = self.hw
        st = self.structures[g]
        ns = len(st.states)
        R, E = self.R, self.E

        o_vec = np.zeros((R, E), dtype=bool)
        o_bytes = np.zeros((R, E))
        o_terms: List[List[Tuple[float, np.ndarray]]] = []
        for i in range(R):
            terms: List[Tuple[float, np.ndarray]] = []
            for h in others:
                s_h = seqs[h][i]
                o_vec[i] |= self.inc[h][s_h]
                ld = self.loads(h, i, s_h)
                if ld is None or ld[0].shape[0] == 0:
                    continue
                idx, cnt = ld
                o_bytes[i, idx] += self.sizes[h][i] * cnt
                terms.append((hw.alpha * float(self.dil[h][i, s_h]), idx))
            o_terms.append(terms)

        # joint comm cost of round i per candidate state of g, others fixed
        cost = np.full((R, ns), LARGE_PENALTY)
        for i in range(R):
            if not self.pairs[g][i]:
                base = 0.0
                for a_dh, idx_h in o_terms[i]:
                    rc = a_dh + hw.beta * float(o_bytes[i, idx_h].max())
                    if rc > base:
                        base = rc
                cost[i, :] = base
                continue
            w = self.sizes[g][i]
            for s in range(ns):
                if not self.feas[g][i, s]:
                    continue
                ld = self.loads(g, i, s)
                if ld is None:
                    continue
                idx, cnt = ld
                scratch = o_bytes[i].copy()
                scratch[idx] += w * cnt
                rc = hw.alpha * float(self.dil[g][i, s]) + \
                    hw.beta * float(scratch[idx].max())
                for a_dh, idx_h in o_terms[i]:
                    rc_h = a_dh + hw.beta * float(scratch[idx_h].max())
                    if rc_h > rc:
                        rc = rc_h
                cost[i, s] = rc

        # DP with per-round transition tables (the union edge set seen from
        # g's side changes with the others' rounds); same vectorization and
        # tie-breaking as _plans_from_structure
        idxs = np.arange(ns)
        INF = float("inf")
        f = np.full((R, ns), INF)
        parent = np.full((R, ns), -1, dtype=np.int64)
        B_prev: Optional[np.ndarray] = None
        for i in range(R):
            B = self.inc[g] | o_vec[i][None, :]
            Bf = B.astype(np.float64)
            Bsz = Bf.sum(axis=1)
            if i == 0:
                g0f = self.g0_vec.astype(np.float64)
                changed = g0f.sum() + Bsz - 2.0 * (Bf @ g0f)
                T = self._price_vec(changed)
                enter0 = self.enter[g][0] | (idxs == st.g0_idx)
                f[0, enter0] = cost[0, enter0] + T[enter0]
                parent[0, enter0] = st.g0_idx
            else:
                Af = B_prev.astype(np.float64)
                Asz = Af.sum(axis=1)
                changed = Asz[:, None] + Bsz[None, :] - 2.0 * (Af @ Bf.T)
                T = self._price_vec(changed)
                if hw.overlap:
                    eff = np.maximum(0.0, T - cost[i - 1][:, None])
                else:
                    eff = T
                cand = f[i - 1][:, None] + eff
                best_p = cand.argmin(axis=0)
                best = cand[best_p, idxs]
                stay = cand[idxs, idxs]
                prefer_stay = stay <= best
                best = np.where(prefer_stay, stay, best)
                best_p = np.where(prefer_stay, idxs, best_p)
                ent = self.enter[g][i]
                f[i, ent] = best[ent] + cost[i, ent]
                parent[i, ent] = best_p[ent]
                carry = ~ent
                if carry.any():
                    # staying put is not free here: the union still changes
                    # when *other* groups reconfigure around g's held edges,
                    # so the carried state pays the diagonal transition —
                    # exactly what evaluate() charges
                    diag = np.diagonal(eff)
                    fin = np.isfinite(f[i - 1, carry])
                    f[i, carry] = np.where(
                        fin,
                        f[i - 1, carry] + diag[carry] + cost[i, carry],
                        INF,
                    )
                    parent[i, carry] = np.where(fin, idxs[carry], -1)
            B_prev = B
        last = int(f[R - 1].argmin())
        seq = [last]
        for i in range(R - 1, 0, -1):
            seq.append(int(parent[i, seq[-1]]))
        seq.reverse()
        return tuple(seq)


def _concurrent_structures(
    g0: Topology,
    standard: Sequence[Topology],
    schedules: Sequence[Schedule],
    hw: HardwareParams,
    structures: Optional[Sequence[PlanStructure]],
) -> List[PlanStructure]:
    for sch in schedules:
        if sch.n != g0.n:
            raise ValueError(
                f"schedule {sch.algorithm} spans n={sch.n} ranks but the "
                f"fabric has n={g0.n}"
            )
        if not sch.rounds:
            raise ValueError("plan_concurrent needs non-empty schedules")
    if structures is None:
        return [build_structure(g0, standard, sch, hw) for sch in schedules]
    structures = list(structures)
    if len(structures) != len(schedules):
        raise ValueError(
            f"got {len(structures)} structures for {len(schedules)} schedules"
        )
    for st, sch in zip(structures, schedules):
        _check_structure(st, g0, standard, sch, hw)
    return structures


def plan_concurrent(
    g0: Topology,
    standard: Sequence[Topology],
    schedules: Sequence[Schedule],
    hw: HardwareParams,
    *,
    structures: Optional[Sequence[PlanStructure]] = None,
    solo_plans: Optional[Sequence[Plan]] = None,
    refine_passes: int = 6,
    offsets: Optional[Sequence[int]] = None,
) -> ConcurrentPlan:
    """Jointly plan several concurrently-active collectives on one fabric.

    Each schedule is a full-domain composition of one process-group set's
    collective (``schedules.replicate_groups``); rounds are aligned by index
    (bulk-synchronous steps) and groups that finish early leave their
    circuits in place.  See the module comment above for the cost model.

    The solver seeds every group with its independent Algorithm-1 plan,
    adds greedy staggered seeds (each group best-responding to the groups
    placed before it, in both orders), refines each seed by round-robin
    exact best-response DPs until the joint cost stops improving, and keeps
    the cheapest.  Everything is deterministic — same inputs, same plan,
    bit-for-bit.  ``total_cost`` is bounded by the sequential-independent
    baseline (``sequential_cost``: each group solo-planned cold from ``G0``,
    costs summed — the independent-planning model, not a threaded
    back-to-back execution), so the arbiter never prices worse than
    sequential independent planning; ``serialized`` says the bound was the
    better choice (it can be, e.g., under overlapped reconfiguration, where
    serial execution hides reprogramming better than sharing does).

    ``offsets`` staggers arrivals: group ``g``'s round ``i`` executes at
    joint round ``i + offsets[g]`` (see :class:`_JointState`) — the online
    arbiter's admission path, where a prefill collective admitted mid-step
    joins decode rounds already in flight instead of forcing round-0
    alignment.
    """
    schedules = list(schedules)
    if not schedules:
        raise ValueError("plan_concurrent needs at least one schedule")
    structures = _concurrent_structures(g0, standard, schedules, hw, structures)
    if solo_plans is not None:
        # a caller that already solo-planned each group during algorithm
        # arbitration (pccl.plan_concurrent_collectives) passes the plans in
        # so the O(rounds·ns²) numeric phase is not re-run per group
        solo = list(solo_plans)
        if len(solo) != len(schedules):
            raise ValueError(
                f"got {len(solo)} solo plans for {len(schedules)} schedules"
            )
    else:
        solo = [
            _plans_from_structure(st, [sch], hw)[0]
            for st, sch in zip(structures, schedules)
        ]
    sequential_cost = float(sum(p.total_cost for p in solo))

    ev = _JointState(g0, structures, schedules, hw, offsets=offsets)
    R, G = ev.R, ev.G

    def padded(plan: Plan, g: int) -> Tuple[int, ...]:
        # idle prefix holds G0 (the solo seed never pre-positions; the
        # best-response refinement may), then the solo states, then the
        # final state carried to the joint horizon
        seq = [structures[g].g0_idx] * ev.offsets[g]
        seq += [s.state_idx for s in plan.steps]
        seq += [seq[-1]] * (R - len(seq))
        return tuple(seq)

    def refine(seqs: List[Tuple[int, ...]]):
        total = ev.evaluate(seqs)[0]
        for _ in range(max(refine_passes, 0)):
            improved = False
            for g in range(G):
                trial = list(seqs)
                trial[g] = ev.best_response(
                    seqs, g, [h for h in range(G) if h != g]
                )
                t = ev.evaluate(trial)[0]
                if t < total:
                    seqs, total = trial, t
                    improved = True
            if not improved:
                break
        return seqs, total

    base = [padded(p, g) for g, p in enumerate(solo)]
    candidates = [refine(list(base))]
    if G > 1:
        # staggered greedy seeds: grant the fabric in priority order, each
        # group best-responding to those already placed
        for order in (list(range(G)), list(reversed(range(G)))):
            seqs = list(base)
            placed: List[int] = []
            for g in order:
                seqs[g] = ev.best_response(seqs, g, placed)
                placed.append(g)
            candidates.append(refine(seqs))
    best_seqs, _ = min(candidates, key=lambda c: c[1])
    joint_cost, comm, reconf, final_vec = ev.evaluate(best_seqs)
    serialized = joint_cost > sequential_cost
    if serialized:
        final_topo = solo[-1].final_topology
    else:
        final_edges = frozenset(
            e for e, on in zip(ev.edges, final_vec.tolist()) if on
        )
        final_topo = Topology(g0.n, final_edges, name="concurrent_final")
    groups = tuple(
        ConcurrentGroupPlan(
            schedule=sch,
            solo=sp,
            states=tuple(best_seqs[g]),
            state_names=tuple(
                structures[g].states[s].topo.name for s in best_seqs[g]
            ),
        )
        for g, (sch, sp) in enumerate(zip(schedules, solo))
    )
    return ConcurrentPlan(
        hw=hw,
        groups=groups,
        n_rounds=R,
        joint_cost=float(joint_cost),
        sequential_cost=sequential_cost,
        serialized=serialized,
        comm_cost=float(sum(comm)),
        reconfig_cost=float(sum(reconf)),
        final_topology=final_topo,
        # all-zero staggering IS round-0 alignment: normalize to the empty
        # tuple so aligned plans compare equal however the caller spelled it
        offsets=ev.offsets if any(ev.offsets) else (),
    )


def plan_concurrent_exact(
    g0: Topology,
    standard: Sequence[Topology],
    schedules: Sequence[Schedule],
    hw: HardwareParams,
    *,
    structures: Optional[Sequence[PlanStructure]] = None,
    max_product_states: int = 4096,
    offsets: Optional[Sequence[int]] = None,
) -> float:
    """Exact joint DP over the product state space (oracle for n ≤ 8 tests).

    Returns the optimal *aligned* joint cost — the quantity
    ``plan_concurrent(...).joint_cost`` approximates; the serialized
    fallback is deliberately outside its search space.  ``offsets`` carries
    the same arrival-round semantics as :func:`plan_concurrent`."""
    import itertools

    schedules = list(schedules)
    if not schedules:
        raise ValueError("plan_concurrent_exact needs at least one schedule")
    structures = _concurrent_structures(g0, standard, schedules, hw, structures)
    ev = _JointState(g0, structures, schedules, hw, offsets=offsets)
    G, R = ev.G, ev.R
    ns_list = [len(st.states) for st in structures]
    n_prod = 1
    for k in ns_list:
        n_prod *= k
    if n_prod > max_product_states:
        raise ValueError(
            f"product state space {n_prod} exceeds {max_product_states}; "
            "the exact solver is an oracle for small instances"
        )
    prod = list(itertools.product(*[range(k) for k in ns_list]))
    unions = {tup: ev.union_vec(tup) for tup in prod}
    comm_memo: Dict[Tuple[int, Tuple[int, ...]], float] = {}

    def comm(tup: Tuple[int, ...], i: int) -> float:
        key = (i, tup)
        v = comm_memo.get(key)
        if v is None:
            v = ev.comm_of(tup, i)
            comm_memo[key] = v
        return v

    f: Dict[Tuple[int, ...], float] = {}
    for tup in prod:
        if all(
            ev.enter[g][0][s] or s == structures[g].g0_idx
            for g, s in enumerate(tup)
        ):
            changed = int(np.count_nonzero(ev.g0_vec ^ unions[tup]))
            f[tup] = ev._price_scalar(changed) + comm(tup, 0)
    for i in range(1, R):
        nf: Dict[Tuple[int, ...], float] = {}
        for ptup, pv in f.items():
            pc = comm(ptup, i - 1)
            pu = unions[ptup]
            for stup in prod:
                if not all(
                    ev.enter[g][i][s] or s == ptup[g]
                    for g, s in enumerate(stup)
                ):
                    continue
                t = ev._price_scalar(int(np.count_nonzero(pu ^ unions[stup])))
                if hw.overlap:
                    t = max(0.0, t - pc)
                v = pv + t + comm(stup, i)
                old = nf.get(stup)
                if old is None or v < old:
                    nf[stup] = v
        f = nf
    return float(min(f.values()))
