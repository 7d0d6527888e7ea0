"""Extended α–β cost model with congestion and dilation (paper §3, Alg. 2).

``comm_cost_round`` is Algorithm 2 verbatim: route every transfer of a round
on the candidate topology via BFS shortest paths, then

* ``dilation``   = max path hops across transfers (latency multiplier on α),
* ``congestion`` = max number of transfers sharing one *directed* edge
  (bandwidth divisor, paper Fig. 6), and

``cost = α · dilation + β · congestion · w``  (Alg. 2 line 15; Eq. 1 summed
over rounds).  A transfer with no path returns the large penalty.

Hardware presets carry the constants used in the paper's evaluation (§5) and
the TPU-v5e adaptation target used by the launch/roofline stack.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from .schedules import Round, Schedule
from .topology import Topology, _BIG

LARGE_PENALTY = 1.0e18  # seconds; Alg. 2 line 10


@dataclass(frozen=True)
class HardwareParams:
    """α–β coefficients plus reconfiguration delay (all seconds / bytes).

    Reconfiguration cost model (``reconfig_cost``):

    * ``reconfig_delay_per_link is None`` (default) — the paper's serial
      model: any topology change pays the full fabric delay ``r``.
    * ``reconfig_delay_per_link = r_link`` — partial reconfiguration: a
      change pays ``r_link`` per *changed* directed circuit (set up or torn
      down), capped at ``reconfig_delay``.  Models switches that reprogram
      ports independently rather than the whole fabric at once.
    * ``overlap = True`` — additionally hide round *i*'s reprogramming
      behind round *i−1*'s communication (SWOT-style
      reconfiguration/communication overlap); the planner charges only the
      part of the reconfiguration that outlasts the previous round.
    """

    name: str
    alpha: float            # fixed per-transfer cost (s)
    beta: float             # 1 / link bandwidth (s per byte)
    reconfig_delay: float   # r: full-fabric reprogram time (s)
    tx_per_gpu: int = 1     # optical transmitters per accelerator tile
    rx_per_gpu: int = 1
    # r_link: per-changed-circuit reprogram time (s); None → serial model
    reconfig_delay_per_link: Optional[float] = None
    # hide reconfiguration behind the previous round's communication
    overlap: bool = False

    def with_reconfig(self, r: float) -> "HardwareParams":
        return replace(self, name=f"{self.name}_r{r:g}", reconfig_delay=r)

    def with_link_reconfig(
        self, r_link: float, *, overlap: bool = False
    ) -> "HardwareParams":
        """Partial-reconfiguration variant (optionally overlapped)."""
        tag = f"{self.name}_rl{r_link:g}" + ("_ov" if overlap else "")
        return replace(
            self, name=tag, reconfig_delay_per_link=r_link, overlap=overlap
        )

    def with_overlap(self, overlap: bool = True) -> "HardwareParams":
        return replace(self, name=f"{self.name}_ov", overlap=overlap)

    @property
    def reconfig_mode(self) -> str:
        """``serial`` | ``partial`` | ``overlap`` (how changes are priced)."""
        if self.overlap:
            return "overlap"
        return "serial" if self.reconfig_delay_per_link is None else "partial"


def reconfig_cost(prev_topo: Topology, next_topo: Topology, hw: HardwareParams) -> float:
    """Cost (s) of reprogramming the fabric from ``prev_topo`` to ``next_topo``.

    Serial model: the full ``reconfig_delay`` on any change.  Partial model
    (``reconfig_delay_per_link`` set): ``r_link`` per changed directed
    circuit — circuits present in exactly one of the two edge sets — capped
    at the full-fabric delay.  Identical edge sets always cost 0.

    Overlap (``hw.overlap``) is *not* applied here: it depends on what the
    fabric is doing while reprogramming, so the planner subtracts the
    previous round's communication time at the DP transition.
    """
    if prev_topo.edges == next_topo.edges:
        return 0.0
    if hw.reconfig_delay_per_link is None:
        return hw.reconfig_delay
    changed = len(prev_topo.edges ^ next_topo.edges)
    return min(hw.reconfig_delay, hw.reconfig_delay_per_link * changed)


# §5: α = 3 µs (H100 DGX p2p latency), β = 1/450 GB/s (NVLink), r = 5 µs
# (Passage-class MZI switching).  Appendix A sweeps r ∈ {10, 25, 50, 500} µs;
# Fig. 9 uses 1 ms (MEMS-class).
H100_DGX = HardwareParams("h100_dgx", alpha=3e-6, beta=1.0 / (450e9), reconfig_delay=5e-6)
H100_DGX_R10US = H100_DGX.with_reconfig(10e-6)
H100_DGX_R25US = H100_DGX.with_reconfig(25e-6)
H100_DGX_R50US = H100_DGX.with_reconfig(50e-6)
H100_DGX_R500US = H100_DGX.with_reconfig(500e-6)
H100_DGX_R1MS = H100_DGX.with_reconfig(1e-3)

# TPU v5e adaptation target: 50 GB/s per ICI link, ~1 µs software α,
# OCS-class reconfiguration (ms) and Passage-class (µs) variants.
TPU_V5E_OCS = HardwareParams("tpu_v5e_ocs", alpha=1e-6, beta=1.0 / (50e9), reconfig_delay=2e-3)
TPU_V5E_PHOTONIC = HardwareParams("tpu_v5e_photonic", alpha=1e-6, beta=1.0 / (50e9), reconfig_delay=5e-6)

PRESETS: Dict[str, HardwareParams] = {
    p.name: p
    for p in [
        H100_DGX,
        H100_DGX_R10US,
        H100_DGX_R25US,
        H100_DGX_R50US,
        H100_DGX_R500US,
        H100_DGX_R1MS,
        TPU_V5E_OCS,
        TPU_V5E_PHOTONIC,
    ]
}


@dataclass(frozen=True)
class RoundCost:
    """Per-round cost with the decomposition used by Figs. 8/9."""

    total: float
    dilation: int
    congestion: int
    alpha_base: float        # α (one hop, no dilation)
    beta_base: float         # β·w (full bandwidth, no congestion)
    dilation_extra: float    # (dilation-1)·α
    congestion_extra: float  # (congestion-1)·β·w
    feasible: bool


# Bounded LRU over (n, edges) → (dist, pred).  Sessions may plan from
# multiple threads, so all access is lock-guarded; eviction drops only the
# least-recently-used entry (a blanket clear() used to dump the hot entry
# mid-sweep).
_SP_CACHE: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_SP_CACHE_MAX = 64
_SP_CACHE_LOCK = threading.Lock()


def _scipy_paths(topo: Topology):
    """(dist, pred) all-pairs unweighted shortest paths — C-speed via scipy.
    Cached per topology; the planner prices O(rounds × states) rounds so this
    is the hot path (paper claims <1 s for the largest scale-up domains)."""
    import numpy as np

    key = (topo.n, topo.edges)
    with _SP_CACHE_LOCK:
        hit = _SP_CACHE.get(key)
        if hit is not None:
            _SP_CACHE.move_to_end(key)
            return hit
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path as sp

    n = topo.n
    if topo.edges:
        rows, cols = zip(*topo.edges)
    else:
        rows, cols = (), ()
    g = csr_matrix(
        (np.ones(len(rows)), (np.asarray(rows), np.asarray(cols))), shape=(n, n)
    )
    dist, pred = sp(g, method="D", directed=True, unweighted=True,
                    return_predecessors=True)
    with _SP_CACHE_LOCK:
        _SP_CACHE[key] = (dist, pred)
        _SP_CACHE.move_to_end(key)
        while len(_SP_CACHE) > _SP_CACHE_MAX:
            _SP_CACHE.popitem(last=False)
    return dist, pred


PairKey = FrozenSet[Tuple[Tuple[int, int], int]]


# Bounded LRU over (n, edges) → component labels for *linear* graphs (every
# node: out-degree ≤ 1 and in-degree ≤ 1, i.e. unions of simple paths and
# cycles — exactly the ideal graphs of permutation rounds, the planner's
# dominant candidate states).  None is cached too: "not linear" is as
# expensive to rediscover as the labels are to build.
_LINEAR_CACHE: "OrderedDict[Tuple, Optional[Tuple]]" = OrderedDict()
_LINEAR_CACHE_MAX = 512
_LINEAR_CACHE_LOCK = threading.Lock()


def _linear_labels(topo: Topology):
    """(comp, pos, off, length, cyclic, n_slots) labels for a linear graph,
    or None if ``topo`` is not linear.

    ``comp[v]``/``pos[v]`` place each node on its path/cycle; ``off[c]``
    gives component ``c`` a private block of ``length[c] + 1`` edge slots
    (slot ``p`` = the edge out of position ``p``), so all components share
    one flat difference array when counting edge loads."""
    import numpy as np

    key = (topo.n, topo.edges)
    with _LINEAR_CACHE_LOCK:
        if key in _LINEAR_CACHE:
            _LINEAR_CACHE.move_to_end(key)
            return _LINEAR_CACHE[key]

    n = topo.n
    succ = [-1] * n
    pred = [-1] * n
    linear = True
    for u, v in topo.edges:
        if succ[u] != -1 or pred[v] != -1:
            linear = False
            break
        succ[u] = v
        pred[v] = u

    labels = None
    if linear:
        comp = [-1] * n
        pos = [0] * n
        length: List[int] = []
        cyclic: List[bool] = []
        for s in range(n):  # paths (and isolated nodes) start where pred is unset
            if pred[s] == -1:
                u, p, c = s, 0, len(length)
                while u != -1:
                    comp[u] = c
                    pos[u] = p
                    p += 1
                    u = succ[u]
                length.append(p)
                cyclic.append(False)
        for s in range(n):  # everything left lies on a cycle
            if comp[s] == -1:
                u, p, c = s, 0, len(length)
                while comp[u] == -1:
                    comp[u] = c
                    pos[u] = p
                    p += 1
                    u = succ[u]
                length.append(p)
                cyclic.append(True)
        length_a = np.asarray(length, dtype=np.int64)
        off = np.zeros(len(length) + 1, dtype=np.int64)
        np.cumsum(length_a + 1, out=off[1:])
        labels = (
            np.asarray(comp, dtype=np.int64),
            np.asarray(pos, dtype=np.int64),
            off[:-1],
            length_a,
            np.asarray(cyclic, dtype=bool),
            int(off[-1]),
        )

    with _LINEAR_CACHE_LOCK:
        _LINEAR_CACHE[key] = labels
        _LINEAR_CACHE.move_to_end(key)
        while len(_LINEAR_CACHE) > _LINEAR_CACHE_MAX:
            _LINEAR_CACHE.popitem(last=False)
    return labels


def _route_pairs_linear(labels, srcs, dsts) -> Tuple[int, int, bool]:
    """Route on a linear graph: unique paths ⇒ exact dilation/congestion.

    Distance is position arithmetic per component; per-edge load is an
    interval count (difference array over each component's edge slots,
    cycles split at the wrap point).  ``srcs``/``dsts`` are index arrays."""
    import numpy as np

    comp, pos, off, length, cyclic, n_slots = labels
    cu = comp[srcs]
    if (cu != comp[dsts]).any():
        return (_BIG, _BIG, False)
    L = length[cu]
    cyc = cyclic[cu]
    pu = pos[srcs]
    pv = pos[dsts]
    d = pv - pu
    if (~cyc & (d < 0)).any():  # backwards along a path: unreachable
        return (_BIG, _BIG, False)
    d = np.where(cyc, d % L, d)  # src != dst on one comp ⇒ d ≥ 1
    dilation = int(d.max())

    base = off[cu]
    wrap = cyc & (pv < pu)
    plus1 = base + pu
    minus1 = np.where(wrap, base + L, base + pv)
    plus2 = base[wrap]
    minus2 = (base + pv)[wrap]
    idx = np.concatenate([plus1, plus2, minus1, minus2])
    sgn = np.ones(idx.shape[0])
    sgn[plus1.shape[0] + plus2.shape[0]:] = -1.0
    diff = np.bincount(idx, weights=sgn, minlength=n_slots + 1)
    return (dilation, int(diff.cumsum().max()), True)


class _StackedLinear:
    """Label arrays of many linear topologies stacked for batch routing.

    Component ids and edge slots are globalized (state ``s`` owns slot block
    ``[bounds[s], bounds[s+1])``), so one set of vectorized ops routes a
    round against *every* linear candidate state simultaneously — the
    planner's structure phase is O(distinct round structures) batched calls
    instead of O(structures × states) scalar ones."""

    def __init__(self, labels_list: Sequence[Tuple]) -> None:
        import numpy as np

        comp_rows, pos_rows, lens, cycs, offs = [], [], [], [], []
        comp_base = 0
        slot_base = 0
        bounds = [0]
        for comp, pos, off, length, cyclic, n_slots in labels_list:
            comp_rows.append(comp + comp_base)
            pos_rows.append(pos)
            offs.append(off + slot_base)
            lens.append(length)
            cycs.append(cyclic)
            comp_base += length.shape[0]
            slot_base += n_slots
            bounds.append(slot_base)
        self.comp = np.stack(comp_rows)          # (S, n) global comp ids
        self.pos = np.stack(pos_rows)            # (S, n)
        self.glen = np.concatenate(lens)         # (C,)
        self.gcyc = np.concatenate(cycs)         # (C,)
        self.goff = np.concatenate(offs)         # (C,) global slot offsets
        self.bounds = np.asarray(bounds)         # (S+1,)
        self.n_slots = slot_base


def _route_linear_batch(stacked: "_StackedLinear", srcs, dsts):
    """(dilation, congestion, feasible) arrays over all stacked states.

    Identical arithmetic to :func:`_route_pairs_linear` per state; the diff
    arrays of all states share one flat buffer (each state's block sums to
    zero, so a single cumsum segments cleanly at block boundaries)."""
    import numpy as np

    cu = stacked.comp[:, srcs]                   # (S, P)
    cv = stacked.comp[:, dsts]
    L = stacked.glen[cu]
    cyc = stacked.gcyc[cu]
    pu = stacked.pos[:, srcs]
    pv = stacked.pos[:, dsts]
    d = pv - pu
    ok = (cu == cv) & (cyc | (d > 0))
    feas = ok.all(axis=1)                        # (S,)
    d = np.where(cyc, d % L, d)  # feasible rows: every entry ≥ 1
    dil = np.where(feas, d.max(axis=1), _BIG)

    cong = np.full(feas.shape[0], _BIG, dtype=np.int64)
    fidx = np.nonzero(feas)[0]
    if fidx.shape[0]:
        base = stacked.goff[cu[fidx]]            # (F, P)
        pu_f, pv_f, L_f = pu[fidx], pv[fidx], L[fidx]
        wrap = stacked.gcyc[cu[fidx]] & (pv_f < pu_f)
        plus1 = (base + pu_f).ravel()
        minus1 = np.where(wrap, base + L_f, base + pv_f).ravel()
        plus2 = base[wrap]                       # bool-indexing flattens
        minus2 = (base + pv_f)[wrap]
        idx = np.concatenate([plus1, plus2, minus1, minus2])
        sgn = np.ones(idx.shape[0])
        sgn[plus1.shape[0] + plus2.shape[0]:] = -1.0
        run = np.bincount(idx, weights=sgn, minlength=stacked.n_slots + 1).cumsum()
        # each feasible block's running load; interleaved infeasible blocks
        # contributed nothing so their slots sit at exactly 0
        seg = np.maximum.reduceat(run, stacked.bounds[fidx])
        cong[fidx] = seg.astype(np.int64)
    return dil, cong, feas


# Bounded LRU over (n, edges) → path-position labels for *bidirectional path
# forests* (every directed edge has its reverse, undirected degree ≤ 2, no
# cycles) — exactly the shape of a ring fabric that lost a link, the dominant
# state on the warm-replan path.  Cycles are excluded: antipodal pairs on an
# even bidirectional cycle have tied shortest paths, so routes would not be
# provably identical to the predecessor-walk leg.  None is cached too.
_BIDI_CACHE: "OrderedDict[Tuple, Optional[Tuple]]" = OrderedDict()
_BIDI_CACHE_MAX = 512
_BIDI_CACHE_LOCK = threading.Lock()


def _bidi_path_labels(topo: Topology):
    """(comp, pos, off, n_slots) labels for a bidirectional path forest, or
    None if ``topo`` is not one.

    ``comp[v]``/``pos[v]`` place each node on its undirected path; component
    ``c`` owns slot block ``[off[c], off[c] + length_c)`` where slot ``p``
    stands for the segment between positions ``p`` and ``p + 1`` (one slot
    per direction plane, see :func:`_route_rounds_bidi`).  On such graphs
    every pair has a *unique* simple path, so shortest-path routing is
    forced and results are bit-identical to the general predecessor walk."""
    import numpy as np

    key = (topo.n, topo.edges)
    with _BIDI_CACHE_LOCK:
        if key in _BIDI_CACHE:
            _BIDI_CACHE.move_to_end(key)
            return _BIDI_CACHE[key]

    n = topo.n
    adj: List[List[int]] = [[] for _ in range(n)]
    ok = True
    for u, v in topo.edges:
        if (v, u) not in topo.edges:
            ok = False
            break
        adj[u].append(v)
    if ok:
        ok = all(len(a) <= 2 for a in adj)
    labels = None
    if ok:
        comp = [-1] * n
        pos = [0] * n
        length: List[int] = []
        for s in range(n):  # paths start at endpoints (degree 0 or 1)
            if comp[s] != -1 or len(adj[s]) == 2:
                continue
            c = len(length)
            u, prev, p = s, -1, 0
            while u != -1:
                comp[u] = c
                pos[u] = p
                p += 1
                nxt = -1
                for w in adj[u]:
                    if w != prev:
                        nxt = w
                        break
                prev, u = u, nxt
            length.append(p)
        if all(c != -1 for c in comp):  # unvisited nodes would lie on cycles
            length_a = np.asarray(length, dtype=np.int64)
            off = np.zeros(len(length) + 1, dtype=np.int64)
            np.cumsum(length_a, out=off[1:])
            labels = (
                np.asarray(comp, dtype=np.int64),
                np.asarray(pos, dtype=np.int64),
                off[:-1],
                int(off[-1]),
            )

    with _BIDI_CACHE_LOCK:
        _BIDI_CACHE[key] = labels
        _BIDI_CACHE.move_to_end(key)
        while len(_BIDI_CACHE) > _BIDI_CACHE_MAX:
            _BIDI_CACHE.popitem(last=False)
    return labels


def _route_rounds_bidi(
    labels, pair_arrays_list: Sequence[Tuple]
) -> List[Tuple[int, int, bool]]:
    """Batch-route many rounds on ONE bidirectional path forest.

    Same contract as :func:`_route_rounds_general` (and bit-identical to it:
    unique simple paths force the same routes) without any shortest-path
    machinery — dilation is position arithmetic, congestion is two interval
    difference planes (one per travel direction, since the two directed
    circuits of a segment are distinct links) cumsum'd per round."""
    import numpy as np

    comp, pos, off, n_slots = labels
    R = len(pair_arrays_list)
    counts = np.asarray([s.shape[0] for s, _ in pair_arrays_list])
    srcs = np.concatenate([s for s, _ in pair_arrays_list])
    dsts = np.concatenate([d for _, d in pair_arrays_list])
    seg = np.repeat(np.arange(R), counts)

    cu = comp[srcs]
    same = cu == comp[dsts]
    feas = np.bincount(seg[~same], minlength=R) == 0
    pu = pos[srcs]
    pv = pos[dsts]
    d = np.abs(pv - pu)
    dil = np.zeros(R, dtype=np.int64)
    keep = feas[seg]
    np.maximum.at(dil, seg[keep], d[keep])

    base = off[cu]
    lo = base + np.minimum(pu, pv)
    hi = base + np.maximum(pu, pv)
    fwd = keep & (pu < pv)          # ascending positions: forward plane
    bwd = keep & (pu > pv)          # descending: backward plane
    m = R * n_slots
    rowbase = seg * n_slots
    plus = np.concatenate([(rowbase + lo)[fwd], m + (rowbase + lo)[bwd]])
    minus = np.concatenate([(rowbase + hi)[fwd], m + (rowbase + hi)[bwd]])
    diff = np.bincount(plus, minlength=2 * m) - np.bincount(
        minus, minlength=2 * m
    )
    # rows: fwd plane rounds 0..R-1, then bwd plane; each component block's
    # entries cancel before the block ends, so one row cumsum segments cleanly
    run = diff.reshape(2 * R, n_slots).cumsum(axis=1)
    mx = run.max(axis=1)
    cong = np.maximum(mx[:R], mx[R:])

    out: List[Tuple[int, int, bool]] = []
    for k in range(R):
        if feas[k]:
            out.append((int(dil[k]), int(cong[k]), True))
        else:
            out.append((_BIG, _BIG, False))
    return out


def _route_rounds_general(
    topo: Topology, pair_arrays_list: Sequence[Tuple]
) -> List[Tuple[int, int, bool]]:
    """Batch the general shortest-path leg of :func:`_route_pairs` over many
    rounds on ONE topology: a single predecessor-matrix walk prices every
    round simultaneously instead of one walk per round.

    ``pair_arrays_list[k]`` is round ``k``'s prebuilt ``(srcs, dsts)`` index
    arrays (non-empty, self-pairs already dropped).  Returns one
    ``(dilation, congestion, feasible)`` triple per round, bit-identical to
    calling ``_route_pairs(topo, pairs, allow_fast=False)`` per round: the
    same ``dist``/``pred`` matrices drive the same deterministic routes, the
    per-round edge-load multisets are segment-tagged rather than recomputed.
    The warm-replan path leans on this — a degraded standard topology must
    re-price every distinct round of the schedule, and per-round scalar
    walks were the dominant cost of ``planner.replan``."""
    import numpy as np

    R = len(pair_arrays_list)
    dist, pred = _scipy_paths(topo)
    n = topo.n
    counts = np.asarray([s.shape[0] for s, _ in pair_arrays_list])
    srcs = np.concatenate([s for s, _ in pair_arrays_list])
    dsts = np.concatenate([d for _, d in pair_arrays_list])
    seg = np.repeat(np.arange(R), counts)

    d = dist[srcs, dsts]
    finite = np.isfinite(d)
    feas = np.bincount(seg[~finite], minlength=R) == 0
    dil = np.zeros(R)
    np.maximum.at(dil, seg[finite], d[finite])

    # walk only the pairs of fully feasible rounds (infinite-distance pairs
    # would never terminate; their rounds are already (_BIG, _BIG, False))
    keep = feas[seg]
    ws, wseg = srcs[keep], seg[keep]
    cur = dsts[keep].copy()
    codes: List = []
    active = cur != ws
    nn = n * n
    while active.any():
        prev = pred[ws[active], cur[active]]
        codes.append(
            wseg[active] * nn + prev.astype(np.int64) * n + cur[active]
        )
        nxt = cur.copy()
        nxt[active] = prev
        cur = nxt
        active = cur != ws
    if codes:
        all_codes = np.concatenate(codes)
        if R * nn <= (1 << 23):
            # dense per-round edge-load counting: one bincount + row max
            # beats the O(E log E) sort of np.unique at modest R·n²
            loads = np.bincount(all_codes, minlength=R * nn)
            cong_a = loads.reshape(R, nn).max(axis=1)
            return [
                (int(dil[k]), int(cong_a[k]), True) if feas[k]
                else (_BIG, _BIG, False)
                for k in range(R)
            ]
        uniq, cnts = np.unique(all_codes, return_counts=True)
        useg = uniq // nn  # ascending (uniq is sorted)
        bounds = np.searchsorted(useg, np.arange(R + 1))
    else:  # every round infeasible (or all pairs self-pairs, excluded above)
        cnts = np.zeros(0, dtype=np.int64)
        bounds = np.zeros(R + 1, dtype=np.int64)

    out: List[Tuple[int, int, bool]] = []
    for k in range(R):
        if not feas[k]:
            out.append((_BIG, _BIG, False))
            continue
        block = cnts[bounds[k]:bounds[k + 1]]
        cong = int(block.max()) if block.shape[0] else 0
        out.append((int(dil[k]), cong, True))
    return out


def pairs_of(rnd: Round) -> List[Tuple[int, int]]:
    """The (src, dst) pairs of a round that actually move data.

    Memoized on the round itself (schedules are memoized too, so planners
    keep re-pricing the same ``Round`` objects); callers must not mutate
    the returned list."""
    cached = rnd.__dict__.get("_pairs")
    if cached is None:
        cached = [(t.src, t.dst) for t in rnd.transfers if t.src != t.dst]
        object.__setattr__(rnd, "_pairs", cached)
    return cached


# Bounded LRU over (n, edges, pair-multiset) → per-directed-edge loads.
# The concurrent-group arbiter (planner.plan_concurrent) prices cross-group
# contention per *link*, which needs the full load vector rather than the
# max that STRUCTURE_TABLE keeps.
_EDGE_LOAD_CACHE: "OrderedDict[Tuple, Optional[Tuple]]" = OrderedDict()
_EDGE_LOAD_CACHE_MAX = 65536
_EDGE_LOAD_CACHE_LOCK = threading.Lock()


def edge_loads(
    topo: Topology,
    pairs: Sequence[Tuple[int, int]],
    key: Optional[PairKey] = None,
) -> Optional[Tuple[int, Tuple[Tuple[Tuple[int, int], int], ...]]]:
    """``(dilation, ((edge, count), ...))`` for routing ``pairs`` on ``topo``,
    or ``None`` when some pair has no path.

    Routes follow the same deterministic shortest paths as
    :func:`_route_pairs`' general path (the ``_scipy_paths`` predecessor
    walk).  Every fast path in ``_route_pairs`` routes along *unique*
    shortest paths (linear graphs, direct circuits, functional graphs), so
    ``max(count)`` here always equals the congestion factor
    ``STRUCTURE_TABLE`` reports and ``dilation`` matches exactly — the
    concurrent arbiter's per-link pricing degenerates to Alg. 2's
    ``(D, C)`` whenever a group has the fabric to itself.
    """
    import numpy as np

    if not pairs:
        return (0, ())
    if key is None:
        key = round_structure_key(pairs)
    full_key = (topo.n, topo.edges, key)
    with _EDGE_LOAD_CACHE_LOCK:
        if full_key in _EDGE_LOAD_CACHE:
            _EDGE_LOAD_CACHE.move_to_end(full_key)
            return _EDGE_LOAD_CACHE[full_key]

    srcs = np.asarray([p[0] for p in pairs])
    dsts = np.asarray([p[1] for p in pairs])
    dist, pred = _scipy_paths(topo)
    d = dist[srcs, dsts]
    result: Optional[Tuple] = None
    if np.all(np.isfinite(d)):
        dilation = int(d.max())
        cur = dsts.copy()
        codes: List = []
        active = cur != srcs
        while active.any():
            prev = pred[srcs[active], cur[active]]
            codes.append(prev.astype(np.int64) * topo.n + cur[active])
            nxt = cur.copy()
            nxt[active] = prev
            cur = nxt
            active = cur != srcs
        uniq, counts = np.unique(np.concatenate(codes), return_counts=True)
        loads = tuple(
            ((int(c) // topo.n, int(c) % topo.n), int(k))
            for c, k in zip(uniq.tolist(), counts.tolist())
        )
        result = (dilation, loads)

    with _EDGE_LOAD_CACHE_LOCK:
        _EDGE_LOAD_CACHE[full_key] = result
        _EDGE_LOAD_CACHE.move_to_end(full_key)
        while len(_EDGE_LOAD_CACHE) > _EDGE_LOAD_CACHE_MAX:
            _EDGE_LOAD_CACHE.popitem(last=False)
    return result


def round_structure_key(pairs: Sequence[Tuple[int, int]]) -> PairKey:
    """Canonical pair-*multiset* key of a round's structure.

    Dilation/congestion (Alg. 2) depend only on which (src, dst) pairs a
    round routes and how many copies of each — not on the payload size and
    not on transfer order.  Rounds sharing this key share routing factors on
    every topology."""
    from collections import Counter

    return frozenset(Counter(pairs).items())


def _route_pairs(
    topo: Topology,
    pairs: Sequence[Tuple[int, int]],
    *,
    allow_fast: bool = True,
    pair_arrays=None,
) -> Tuple[int, int, bool]:
    """Algorithm 2 lines 1–14 on explicit pairs: (dilation, congestion,
    feasible).  ``allow_fast=False`` forces the scipy general path (used by
    the property tests to cross-check the fast paths).  ``pair_arrays`` is
    an optional prebuilt ``(srcs, dsts)`` index-array pair — callers pricing
    one round against many topologies build it once.

    General path is vectorized: all transfers' shortest paths are walked
    simultaneously via the predecessor matrix (one numpy step per hop
    depth)."""
    import numpy as np

    if not pairs:
        return (0, 0, True)
    if pair_arrays is None:
        pair_arrays = (
            np.asarray([p[0] for p in pairs]),
            np.asarray([p[1] for p in pairs]),
        )
    srcs, dsts = pair_arrays

    # Fast path 1: linear graphs (out-degree ≤ 1 AND in-degree ≤ 1 — unions
    # of simple paths/cycles, i.e. permutation rounds' ideal graphs, the
    # planner's dominant candidate states): paths are unique and
    # distances/edge loads fall out of cached component position labels,
    # vectorized over all transfers at once.  Subsumes the
    # round-on-its-own-ideal-graph query (every pair a direct circuit).
    if allow_fast:
        labels = _linear_labels(topo)
        if labels is not None:
            return _route_pairs_linear(labels, srcs, dsts)

    # Fast path 2: every transfer is a direct circuit on a non-linear
    # topology.  Any length-1 shortest path is necessarily the direct edge,
    # so this agrees with the general path exactly.
    if allow_fast and all(p in topo.edges for p in pairs):
        from collections import Counter

        cong = max(Counter(pairs).values())
        return (1, cong, True)

    # Fast path 3: other functional graphs (out-degree ≤ 1 but some node
    # receives twice): the only path from u is the unique outgoing chain.
    out: Dict[int, int] = {}
    functional = allow_fast
    for u, v in topo.edges:
        if not functional:
            break
        if u in out:
            functional = False
            break
        out[u] = v
    if functional:
        edge_usage: Dict[Tuple[int, int], int] = {}
        dil = 0
        for s, d in pairs:
            cur, hops = s, 0
            while cur != d:
                nxt = out.get(cur)
                if nxt is None or hops > topo.n:
                    return (_BIG, _BIG, False)
                edge_usage[(cur, nxt)] = edge_usage.get((cur, nxt), 0) + 1
                cur = nxt
                hops += 1
            dil = max(dil, hops)
        return (dil, max(edge_usage.values(), default=0), True)

    dist, pred = _scipy_paths(topo)
    d = dist[srcs, dsts]
    if not np.all(np.isfinite(d)):
        return (_BIG, _BIG, False)
    dilation = int(d.max())

    # walk every path back from dst to src in lockstep
    cur = dsts.copy()
    codes: List = []
    active = cur != srcs
    while active.any():
        prev = pred[srcs[active], cur[active]]
        codes.append(prev.astype(np.int64) * topo.n + cur[active])
        nxt = cur.copy()
        nxt[active] = prev
        cur = nxt
        active = cur != srcs
    all_codes = np.concatenate(codes)
    _, counts = np.unique(all_codes, return_counts=True)
    return (dilation, int(counts.max()), True)


@dataclass(frozen=True)
class StructureStats:
    """Hit/miss accounting for :class:`StructureTable`.  ``misses`` is the
    number of actual routing computations (the quantity the planner
    benchmarks report as *routing calls*); ``bytes`` is the table's current
    estimated key+value footprint (what size-aware eviction charges
    against)."""

    hits: int
    misses: int
    size: int
    evictions: int = 0
    bytes: int = 0

    @property
    def routing_calls(self) -> int:
        return self.misses


class StructureTable:
    """Cache of size-independent routing factors (the planner's *structure*
    phase).

    Keyed by ``(topology edge-set, round pair-multiset)``: dilation and
    congestion are integers that depend only on the candidate topology and
    which pairs a round routes, never on α/β/w.  A buffer-size sweep
    therefore prices every size from one routing pass, and ring/bucket
    schedules — whose rounds share a single pair set — collapse to one
    routing query per candidate topology.

    Lock-guarded bounded LRU (same discipline as ``_SP_CACHE``): sessions
    may plan from multiple threads, and eviction drops only the
    least-recently-used entry.  Eviction is *size-aware*: each entry is
    charged by the estimated bytes of its key (the dominant cost — a key
    holds a topology edge-set plus a round pair-multiset, both O(n) tuples
    of tuples), so an n=1024 structure phase whose keys are ~100 KiB each
    cannot pin gigabytes behind an entry-count limit sized for n=16.
    """

    # key footprint ≈ per-element tuple/int overhead × (edges + pairs) + slack
    _CHARGE_PER_ELEM = 120
    _CHARGE_BASE = 512

    def __init__(
        self, max_entries: int = 65536, max_bytes: int = 128 * 1024 * 1024
    ) -> None:
        if max_entries < 1:
            raise ValueError(f"max_entries must be >= 1, got {max_entries}")
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self._table: "OrderedDict[Tuple, Tuple[int, int, bool]]" = OrderedDict()
        self.max_entries = max_entries
        self.max_bytes = max_bytes
        self._lock = threading.Lock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._bytes = 0

    @classmethod
    def _charge(cls, full_key: Tuple) -> int:
        _, edges, pair_key = full_key
        return cls._CHARGE_PER_ELEM * (len(edges) + len(pair_key)) + cls._CHARGE_BASE

    def lookup(
        self, topo: Topology, key: PairKey
    ) -> Optional[Tuple[int, int, bool]]:
        """Cached factors or None; counts a hit or a miss (a miss means the
        caller is about to route — ``misses`` tallies routing computations)."""
        full_key = (topo.n, topo.edges, key)
        with self._lock:
            hit = self._table.get(full_key)
            if hit is not None:
                self._hits += 1
                self._table.move_to_end(full_key)
            else:
                self._misses += 1
            return hit

    def store(
        self, topo: Topology, key: PairKey, factors: Tuple[int, int, bool]
    ) -> None:
        full_key = (topo.n, topo.edges, key)
        with self._lock:
            if full_key not in self._table:
                self._bytes += self._charge(full_key)
            self._table[full_key] = factors
            self._table.move_to_end(full_key)
            while len(self._table) > 1 and (
                len(self._table) > self.max_entries or self._bytes > self.max_bytes
            ):
                victim, _ = self._table.popitem(last=False)
                self._bytes -= self._charge(victim)
                self._evictions += 1

    def store_many(
        self,
        topo: Topology,
        items: Sequence[Tuple[PairKey, Tuple[int, int, bool]]],
    ) -> None:
        """Bulk :meth:`store` for one topology under a single lock round —
        batch routers deposit a whole schedule's worth of rounds at once."""
        n, edges = topo.n, topo.edges
        with self._lock:
            for key, factors in items:
                full_key = (n, edges, key)
                if full_key not in self._table:
                    self._bytes += self._charge(full_key)
                self._table[full_key] = factors
                self._table.move_to_end(full_key)
            while len(self._table) > 1 and (
                len(self._table) > self.max_entries or self._bytes > self.max_bytes
            ):
                victim, _ = self._table.popitem(last=False)
                self._bytes -= self._charge(victim)
                self._evictions += 1

    def factors(
        self,
        topo: Topology,
        pairs: Sequence[Tuple[int, int]],
        key: Optional[PairKey] = None,
        pair_arrays=None,
    ) -> Tuple[int, int, bool]:
        """(dilation, congestion, feasible) for routing ``pairs`` on
        ``topo``, computing at most once per (edge-set, pair-multiset).
        ``key``/``pair_arrays`` let bulk callers amortize key and index
        construction across topologies."""
        if not pairs:
            return (0, 0, True)
        if key is None:
            key = round_structure_key(pairs)
        hit = self.lookup(topo, key)
        if hit is not None:
            return hit
        factors = _route_pairs(topo, pairs, pair_arrays=pair_arrays)
        self.store(topo, key, factors)
        return factors

    def clear(self) -> None:
        with self._lock:
            self._table.clear()
            self._hits = 0
            self._misses = 0
            self._evictions = 0
            self._bytes = 0

    @property
    def stats(self) -> StructureStats:
        with self._lock:
            return StructureStats(
                self._hits, self._misses, len(self._table), self._evictions,
                self._bytes,
            )


#: Process-wide structure table; all ``round_factors`` queries go through it.
STRUCTURE_TABLE = StructureTable()


def round_factors(topo: Topology, rnd: Round) -> Tuple[int, int, bool]:
    """Algorithm 2 lines 1–14: (dilation, congestion, feasible), cached by
    ``(topology edge-set, round pair-multiset)`` in :data:`STRUCTURE_TABLE`."""
    return STRUCTURE_TABLE.factors(topo, pairs_of(rnd))


def clear_structure_caches(keep_shortest_paths: bool = False) -> None:
    """Drop the routing caches in this module.  Benchmarks call this to
    time cold planning; ``keep_shortest_paths=True`` retains ``_SP_CACHE``
    (which predates the structure table and persists across ``plan()``
    calls), for baselines that model the pre-split planner faithfully."""
    STRUCTURE_TABLE.clear()
    if not keep_shortest_paths:
        with _SP_CACHE_LOCK:
            _SP_CACHE.clear()
    with _LINEAR_CACHE_LOCK:
        _LINEAR_CACHE.clear()
    with _BIDI_CACHE_LOCK:
        _BIDI_CACHE.clear()
    with _EDGE_LOAD_CACHE_LOCK:
        _EDGE_LOAD_CACHE.clear()


def round_cost_from_factors(
    dilation: int, congestion: int, feasible: bool, size: float, hw: HardwareParams
) -> RoundCost:
    """Price routing factors at one size: α·dilation + β·congestion·w.

    The single source of the Alg. 2 arithmetic — :func:`comm_cost_round` and
    the planner's batched numeric phase both use it, so per-size plans and
    ``plan_sweep`` agree bit-for-bit."""
    if not feasible:
        return RoundCost(LARGE_PENALTY, dilation, congestion, 0, 0, 0, 0, False)
    if dilation == 0:  # empty round
        return RoundCost(0.0, 0, 0, 0.0, 0.0, 0.0, 0.0, True)
    alpha_base = hw.alpha
    beta_base = hw.beta * size
    dil_extra = (dilation - 1) * hw.alpha
    con_extra = (congestion - 1) * hw.beta * size
    total = hw.alpha * dilation + hw.beta * congestion * size
    return RoundCost(total, dilation, congestion, alpha_base, beta_base, dil_extra, con_extra, True)


def comm_cost_round(
    topo: Topology, rnd: Round, w: Optional[float], hw: HardwareParams
) -> RoundCost:
    """Algorithm 2: α·dilation + β·congestion·w, or the large penalty."""
    size = rnd.size if w is None else w
    dilation, congestion, feasible = round_factors(topo, rnd)
    return round_cost_from_factors(dilation, congestion, feasible, size, hw)


@dataclass(frozen=True)
class ScheduleCost:
    """Fixed-topology cost of a whole schedule (baseline algorithms, Eq. 1)."""

    total: float
    rounds: Tuple[RoundCost, ...]

    @property
    def alpha_base(self) -> float:
        return sum(r.alpha_base for r in self.rounds)

    @property
    def beta_base(self) -> float:
        return sum(r.beta_base for r in self.rounds)

    @property
    def dilation_extra(self) -> float:
        return sum(r.dilation_extra for r in self.rounds)

    @property
    def congestion_extra(self) -> float:
        return sum(r.congestion_extra for r in self.rounds)

    def breakdown(self) -> Dict[str, float]:
        return {
            "alpha": self.alpha_base,
            "beta": self.beta_base,
            "dilation": self.dilation_extra,
            "congestion": self.congestion_extra,
            "reconfig": 0.0,
            "total": self.total,
        }


def schedule_cost_fixed(topo: Topology, schedule: Schedule, hw: HardwareParams) -> ScheduleCost:
    """Eq. 1: Σ_i (α·d_i + β·c_i·w_i) on a topology that never changes."""
    per = tuple(comm_cost_round(topo, rnd, None, hw) for rnd in schedule.rounds)
    return ScheduleCost(sum(r.total for r in per), per)


def ideal_cost(schedule: Schedule, hw: HardwareParams) -> float:
    """Textbook α–β cost: every round on its perfectly matched topology."""
    return sum(hw.alpha + hw.beta * r.size for r in schedule.rounds if r.transfers)


def lower_bound_reduce_scatter(n: int, d: float, hw: HardwareParams) -> float:
    """β lower bound (each rank must move (n-1)/n·d) + α lower bound (log2 n)."""
    import math

    return hw.alpha * math.ceil(math.log2(n)) + hw.beta * d * (n - 1) / n


def compressed_ef_error_bound(n: int) -> float:
    """Documented accuracy bound of the ``ring_ef8`` all-reduce wire format.

    ``ring_ef8`` runs the ring all-reduce with every hop's payload
    quantized to int8 + one fp32 scale (``scale = max|payload| / 127``, see
    ``repro_torch.comm.fusion.execute_compiled_quantized``), which is what lets
    the schedule price each round at ``size / 4``.  The quantize→dequantize
    round trip errs at most ``scale / 2`` per element per hop, every
    payload (partial sums while reduce-scattering, final sums while
    gathering) is bounded in magnitude by ``n · A`` where
    ``A = max_i ||x_i||_inf``, and one output element transits at most
    ``2(n-1)`` quantizing hops — so to first order

        ``|out - exact| <= 2(n-1) · (n·A)/254  =  bound(n) · n · A``

    elementwise, with ``bound(n) = (n-1)/127``.  This is the *relative*
    bound (w.r.t. the exact result's maximum representable magnitude
    ``n·A``) that arbitration gates on: ``ring_ef8`` only enters the
    candidate set when the caller declares ``rel_error_tol >= bound(n)``
    (see :func:`repro_torch.core.pccl.candidate_algorithms`).  First-order:
    quantization error feeding later hops' payload maxima is second-order
    small and deliberately ignored; callers needing exactness simply leave
    ``rel_error_tol`` unset.
    """
    if n < 2:
        raise ValueError(f"collective needs n >= 2 ranks, got {n}")
    return (n - 1) / 127.0
