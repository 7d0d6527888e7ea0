"""Topology zoo for PCCL.

A :class:`Topology` is the *logical* circuit graph of a scale-up domain: nodes
are accelerators, a directed edge ``(u, v)`` is a unidirectional circuit (one
Tx at ``u``, one Rx at ``v``).  Physical links on electrical fabrics are
full-duplex, so all standard constructors emit both directions; congestion is
counted per *direction* (paper Fig. 6 measures per-direction overlap).

The planner (Algorithm 1) draws candidate topologies from three places:

* ``G0``            — the initial fabric state (any constructor below),
* ``S``             — a set of standard connected graphs (§4.1 "Managing
                      disconnected graphs"),
* ``ideal(round)``  — the graph whose edges are exactly one round's transfers
                      (:func:`from_transfers`), i.e. the circuit set PCCL would
                      program for that round.

All-pairs shortest path (BFS, unweighted) is cached per topology because
Algorithm 2 queries it once per transfer per candidate topology per round.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

Edge = Tuple[int, int]

_BIG = 10 ** 9  # "large penalty" hop count for disconnected pairs (Alg. 2 line 10)


@dataclass(frozen=True)
class Topology:
    """Immutable directed graph over ``n`` accelerators."""

    n: int
    edges: FrozenSet[Edge]
    name: str = "custom"

    # ------------------------------------------------------------------ utils
    def __post_init__(self) -> None:
        for u, v in self.edges:
            if not (0 <= u < self.n and 0 <= v < self.n):
                raise ValueError(f"edge {(u, v)} out of range for n={self.n}")
            if u == v:
                raise ValueError(f"self-loop {(u, v)} not allowed")

    def __hash__(self) -> int:  # frozen dataclass already hashes; keep explicit
        return hash((self.n, self.edges))

    def adjacency(self) -> List[List[int]]:
        adj: List[List[int]] = [[] for _ in range(self.n)]
        for u, v in self.edges:
            adj[u].append(v)
        return adj

    def out_degree(self, u: int) -> int:
        return sum(1 for (a, _) in self.edges if a == u)

    def in_degree(self, v: int) -> int:
        return sum(1 for (_, b) in self.edges if b == v)

    def has_edge(self, u: int, v: int) -> bool:
        return (u, v) in self.edges

    # ------------------------------------------------------ shortest paths
    def shortest_path(self, src: int, dst: int) -> Optional[List[int]]:
        """BFS shortest path (list of nodes) or None if disconnected."""
        if src == dst:
            return [src]
        parents = _bfs_parents(self, src)
        if parents[dst] is None and dst != src:
            return None
        path = [dst]
        while path[-1] != src:
            p = parents[path[-1]]
            if p is None:
                return None
            path.append(p)
        path.reverse()
        return path

    def hop_count(self, src: int, dst: int) -> int:
        """Shortest-path hops; _BIG if disconnected (Alg. 2 penalty)."""
        dists = _apsp(self)[src]
        return dists[dst]

    def is_connected(self) -> bool:
        dists = _apsp(self)[0]
        return all(d < _BIG for d in dists)

    def undirected_link_count(self) -> int:
        return len({tuple(sorted(e)) for e in self.edges})


# Caches keyed by (n, edges) so equal topologies share work.
_BFS_CACHE: Dict[Tuple[int, FrozenSet[Edge], int], List[Optional[int]]] = {}
_APSP_CACHE: Dict[Tuple[int, FrozenSet[Edge]], List[List[int]]] = {}


def _bfs_parents(t: Topology, src: int) -> List[Optional[int]]:
    key = (t.n, t.edges, src)
    hit = _BFS_CACHE.get(key)
    if hit is not None:
        return hit
    adj = t.adjacency()
    parents: List[Optional[int]] = [None] * t.n
    seen = [False] * t.n
    seen[src] = True
    q = deque([src])
    while q:
        u = q.popleft()
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                parents[v] = u
                q.append(v)
    _BFS_CACHE[key] = parents
    return parents


def _apsp(t: Topology) -> List[List[int]]:
    key = (t.n, t.edges)
    hit = _APSP_CACHE.get(key)
    if hit is not None:
        return hit
    adj = t.adjacency()
    all_d: List[List[int]] = []
    for s in range(t.n):
        dist = [_BIG] * t.n
        dist[s] = 0
        q = deque([s])
        while q:
            u = q.popleft()
            for v in adj[u]:
                if dist[v] >= _BIG:
                    dist[v] = dist[u] + 1
                    q.append(v)
        all_d.append(dist)
    _APSP_CACHE[key] = all_d
    return all_d


def clear_caches() -> None:
    _BFS_CACHE.clear()
    _APSP_CACHE.clear()
    with _DEGRADE_CACHE_LOCK:
        _DEGRADE_CACHE.clear()


# ---------------------------------------------------------------------------
# Constructors — the five baseline fabrics of §5 plus hypercube & ideal graphs.
# ---------------------------------------------------------------------------

def _bidir(pairs: Iterable[Edge]) -> FrozenSet[Edge]:
    out = set()
    for u, v in pairs:
        out.add((u, v))
        out.add((v, u))
    return frozenset(out)


def ring(n: int) -> Topology:
    """1-D torus: i <-> i+1 mod n."""
    if n < 2:
        raise ValueError("ring needs n >= 2")
    return Topology(n, _bidir((i, (i + 1) % n) for i in range(n)), name=f"ring{n}")


def line(n: int) -> Topology:
    """1-D grid (ring without wraparound)."""
    return Topology(n, _bidir((i, i + 1) for i in range(n - 1)), name=f"line{n}")


def _grid_nd(dims: Sequence[int], wrap: bool, name: str) -> Topology:
    n = 1
    for d in dims:
        n *= d
    strides = []
    s = 1
    for d in reversed(dims):
        strides.append(s)
        s *= d
    strides.reverse()  # strides[i] multiplies coordinate i

    def flat(coord: Sequence[int]) -> int:
        return sum(c * st for c, st in zip(coord, strides))

    pairs: List[Edge] = []
    for coord in itertools.product(*[range(d) for d in dims]):
        for axis, d in enumerate(dims):
            c = list(coord)
            if coord[axis] + 1 < d:
                c[axis] = coord[axis] + 1
                pairs.append((flat(coord), flat(c)))
            elif wrap and d > 2:
                c[axis] = 0
                pairs.append((flat(coord), flat(c)))
    return Topology(n, _bidir(pairs), name=name)


def torus2d(a: int, b: int) -> Topology:
    return _grid_nd((a, b), wrap=True, name=f"torus2d_{a}x{b}")


def torus3d(a: int, b: int, c: int) -> Topology:
    return _grid_nd((a, b, c), wrap=True, name=f"torus3d_{a}x{b}x{c}")


def grid2d(a: int, b: int) -> Topology:
    """2-D mesh — torus without wraparound (paper: "Grid is a torus without
    wrap around links", plotted as HC=Grid)."""
    return _grid_nd((a, b), wrap=False, name=f"grid2d_{a}x{b}")


def grid3d(a: int, b: int, c: int) -> Topology:
    return _grid_nd((a, b, c), wrap=False, name=f"grid3d_{a}x{b}x{c}")


def hypercube(n: int) -> Topology:
    if n & (n - 1):
        raise ValueError("hypercube needs power-of-two n")
    pairs = []
    k = n.bit_length() - 1
    for u in range(n):
        for b in range(k):
            v = u ^ (1 << b)
            if u < v:
                pairs.append((u, v))
    return Topology(n, _bidir(pairs), name=f"hypercube{n}")


def fully_connected(n: int) -> Topology:
    return Topology(
        n,
        frozenset((u, v) for u in range(n) for v in range(n) if u != v),
        name=f"full{n}",
    )


def from_transfers(n: int, transfers: Iterable[Edge], name: str = "ideal") -> Topology:
    """The *ideal* (round-matched) topology: one unidirectional circuit per
    transfer — what PCCL programs onto the photonic fabric for that round
    (set ``I`` in Algorithm 1)."""
    return Topology(n, frozenset(transfers), name=name)


# Factorizations used to place N accelerators on 2-D / 3-D fabrics; §5 uses
# 32/64/128-GPU domains.  We choose the most-square factorization.

def square_dims2(n: int) -> Tuple[int, int]:
    a = int(n ** 0.5)
    while n % a:
        a -= 1
    return (a, n // a)


def square_dims3(n: int) -> Tuple[int, int, int]:
    best = (1, 1, n)
    best_score = n * n
    for a in range(1, int(round(n ** (1 / 3))) + 2):
        if n % a:
            continue
        m = n // a
        for b in range(a, int(m ** 0.5) + 1):
            if m % b:
                continue
            c = m // b
            score = (c - a) + (c - b)  # prefer near-cubic
            if score < best_score:
                best_score = score
                best = (a, b, c)
    return best


def standard_topologies(n: int) -> Dict[str, Topology]:
    """The five baseline fabrics of §5 (plus hypercube when n is 2^k)."""
    a2, b2 = square_dims2(n)
    a3, b3, c3 = square_dims3(n)
    topos = {
        "ring": ring(n),
        "torus2d": torus2d(a2, b2),
        "torus3d": torus3d(a3, b3, c3),
        "grid2d": grid2d(a2, b2),
        "grid3d": grid3d(a3, b3, c3),
    }
    if n & (n - 1) == 0 and n >= 2:
        topos["hypercube"] = hypercube(n)
    return topos


def topology_by_name(name: str, n: int) -> Topology:
    std = standard_topologies(n)
    if name not in std:
        raise KeyError(f"unknown topology {name!r}; have {sorted(std)}")
    return std[name]


# ---------------------------------------------------------------------------
# Hierarchical decomposition + fault helpers (used by the two-level planner
# and incremental replanning; see core/planner.py).
# ---------------------------------------------------------------------------


def derive_pods(n: int, pod_size: Optional[int] = None) -> Tuple[Tuple[int, ...], ...]:
    """Partition ``n`` ranks into contiguous equal-size pods.

    ``pod_size`` defaults to the larger factor of the most-square 2-D
    factorization — the column length of the torus the fabric would be laid
    out on — so pods line up with torus tiles / ring segments (16 → 4 pods
    of 4, 128 → 8 pods of 16, 1024 → 32 pods of 32).  A prime ``n`` yields
    a single pod, which the hierarchical planner treats as "no hierarchy"
    and delegates to the flat exact DP.
    """
    if n < 1:
        raise ValueError(f"need n >= 1, got {n}")
    if pod_size is None:
        _, pod_size = square_dims2(n)
    if pod_size < 1 or n % pod_size:
        raise ValueError(f"pod_size {pod_size} does not divide n={n}")
    return tuple(
        tuple(range(p * pod_size, (p + 1) * pod_size))
        for p in range(n // pod_size)
    )


def induced_topology(topo: Topology, ranks: Sequence[int], name: str) -> Topology:
    """The subgraph of ``topo`` induced on ``ranks``, relabelled to local ids
    ``0..len(ranks)-1`` (a pod's view of the fabric)."""
    local = {r: i for i, r in enumerate(ranks)}
    edges = frozenset(
        (local[u], local[v]) for u, v in topo.edges if u in local and v in local
    )
    return Topology(len(ranks), edges, name=name)


def quotient_topology(
    topo: Topology, pods: Sequence[Sequence[int]], name: str = "quotient"
) -> Topology:
    """The super-rank graph: one node per pod, an edge (p, q) iff some
    directed edge of ``topo`` crosses from pod ``p`` into pod ``q``."""
    pod_of: Dict[int, int] = {}
    for p, ranks in enumerate(pods):
        for r in ranks:
            pod_of[r] = p
    edges = frozenset(
        (pod_of[u], pod_of[v])
        for u, v in topo.edges
        if pod_of[u] != pod_of[v]
    )
    return Topology(len(pods), edges, name=name)


_DEGRADE_CACHE: "OrderedDict[Tuple, Topology]" = OrderedDict()
_DEGRADE_CACHE_MAX = 256
_DEGRADE_CACHE_LOCK = threading.Lock()


def degrade_topology(
    topo: Topology,
    failed_edges: Iterable[Edge] = (),
    failed_ranks: Iterable[int] = (),
) -> Topology:
    """``topo`` with the failed directed circuits removed (fault model: a
    dead link can no longer carry a circuit in that direction; a dead rank
    loses every incident circuit).  Edges not present are ignored, so
    callers may pass both directions of a physical link uniformly.  Returns
    ``topo`` itself when nothing changes, keeping cache keys (edge-set
    identity) stable for unaffected topologies.

    Memoized (bounded LRU): a fault event degrades the same topologies in
    the session layer, the planner's replan fast path, and the fault
    runtime — one edge-set filter serves them all."""
    failed = frozenset(failed_edges)
    ranks = frozenset(failed_ranks)
    key = (topo.n, topo.edges, failed, ranks)
    with _DEGRADE_CACHE_LOCK:
        hit = _DEGRADE_CACHE.get(key)
        if hit is not None:
            _DEGRADE_CACHE.move_to_end(key)
            return hit
    kept = frozenset(
        e for e in topo.edges
        if e not in failed and e[0] not in ranks and e[1] not in ranks
    )
    if kept == topo.edges:
        out = topo
    else:
        out = Topology(topo.n, kept, name=f"{topo.name}~degraded")
    with _DEGRADE_CACHE_LOCK:
        _DEGRADE_CACHE[key] = out
        _DEGRADE_CACHE.move_to_end(key)
        while len(_DEGRADE_CACHE) > _DEGRADE_CACHE_MAX:
            _DEGRADE_CACHE.popitem(last=False)
    return out
