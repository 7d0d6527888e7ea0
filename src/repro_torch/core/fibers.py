"""Algorithm 4: inter-server fiber routing with flow conservation (App. B.1).

Servers are nodes of a grid graph; fibers are the edges between them.  A
fiber carries one circuit per wavelength, so the number of fibers that must
be physically attached between two adjacent servers equals the maximum number
of circuits routed across that server-to-server edge.  Algorithm 4 is an ILP:
route every (src, dst) demand with per-route flow conservation while
minimizing ``z``, the maximum per-edge overlap — ``z`` is "the lowest number
of fibers required that can support all the circuit requests".

Two solvers:

* :func:`route_fibers_milp` — the paper's ILP verbatim via scipy/HiGHS
  (binary ``x^i_{u,v}`` per route per directed edge + integer ``z``).  Exact;
  used for small instances and to certify the heuristic in tests.
* :func:`route_fibers` — load-aware successive shortest paths followed by a
  reroute-improvement loop on the argmax edge.  This scales to the paper's
  64-server / 512-circuit workload in seconds and reproduces the headline
  numbers (≤ 7 fibers @ 100 circuits, ≤ 31 @ 512 — §4.2).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .topology import Topology, grid2d

Edge = Tuple[int, int]


@dataclass
class FiberRouting:
    routes: List[List[int]]           # node path per request
    edge_load: Dict[Edge, int]        # directed edge -> circuits crossing it
    z: int                            # max load = fibers needed on worst edge
    elapsed_s: float


def _directed_edges(topo: Topology) -> List[Edge]:
    return sorted(topo.edges)


def _dijkstra_loaded(
    adj: Dict[int, List[int]], load: Dict[Edge, int], src: int, dst: int,
    blocked_above: Optional[int] = None, load_weight: float = 1.0,
) -> Optional[List[int]]:
    """Shortest path where edge weight = 1 + load_weight·load; edges with
    load > blocked_above (if given) are unusable."""
    import heapq

    INF = float("inf")
    dist = {src: 0.0}
    prev: Dict[int, int] = {}
    heap = [(0.0, src)]
    seen = set()
    while heap:
        d, u = heapq.heappop(heap)
        if u in seen:
            continue
        seen.add(u)
        if u == dst:
            break
        for v in adj[u]:
            l = load.get((u, v), 0)
            if blocked_above is not None and l > blocked_above:
                continue
            nd = d + 1.0 + load_weight * l
            if nd < dist.get(v, INF):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, v))
    if dst not in dist:
        return None
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    path.reverse()
    return path


def route_fibers(
    topo: Topology,
    demands: Sequence[Edge],
    existing: Optional[Dict[Edge, int]] = None,
    improve_iters: int = 2000,
) -> FiberRouting:
    """Heuristic min-max routing: greedy load-aware paths + argmax rerouting."""
    t0 = time.perf_counter()
    adj: Dict[int, List[int]] = {u: [] for u in range(topo.n)}
    for u, v in topo.edges:
        adj[u].append(v)
    load: Dict[Edge, int] = dict(existing or {})
    routes: List[List[int]] = []

    for s, d in demands:
        path = _dijkstra_loaded(adj, load, s, d, load_weight=1.0)
        if path is None:
            raise RuntimeError(f"no path {s}->{d}")
        for a, b in zip(path[:-1], path[1:]):
            load[(a, b)] = load.get((a, b), 0) + 1
        routes.append(path)

    def zmax() -> int:
        return max(load.values(), default=0)

    # improvement: pull one route off the worst edge if a sub-z path exists
    for _ in range(improve_iters):
        z = zmax()
        if z <= 1:
            break
        worst = max(load, key=lambda e: load[e])
        moved = False
        for ri, path in enumerate(routes):
            pairs = list(zip(path[:-1], path[1:]))
            if worst not in pairs:
                continue
            for a, b in pairs:  # remove this route's load
                load[(a, b)] -= 1
            alt = _dijkstra_loaded(
                adj, load, path[0], path[-1], blocked_above=z - 2, load_weight=0.25
            )
            if alt is not None and max(
                load.get((a, b), 0) for a, b in zip(alt[:-1], alt[1:])
            ) <= z - 2:
                routes[ri] = alt
                for a, b in zip(alt[:-1], alt[1:]):
                    load[(a, b)] = load.get((a, b), 0) + 1
                moved = True
                break
            for a, b in pairs:  # restore
                load[(a, b)] += 1
        if not moved:
            break
    load = {e: c for e, c in load.items() if c > 0}
    return FiberRouting(routes, load, max(load.values(), default=0), time.perf_counter() - t0)


def route_fibers_milp(
    topo: Topology,
    demands: Sequence[Edge],
    existing: Optional[Dict[Edge, int]] = None,
) -> FiberRouting:
    """Algorithm 4 as written: minimize z s.t. per-route unit flow."""
    from scipy.optimize import LinearConstraint, milp
    from scipy.sparse import lil_matrix

    t0 = time.perf_counter()
    edges = _directed_edges(topo)
    ne = len(edges)
    eidx = {e: i for i, e in enumerate(edges)}
    nreq = len(demands)
    existing = existing or {}

    # variables: x[i, e] for i in routes, e in edges; then z
    nv = nreq * ne + 1
    zvar = nreq * ne

    def x(i: int, e: int) -> int:
        return i * ne + e

    c = np.zeros(nv)
    c[zvar] = 1.0

    rows: List[Tuple[Dict[int, float], float, float]] = []
    for i, (s, d) in enumerate(demands):
        for v in range(topo.n):
            out_edges = [eidx[e] for e in edges if e[0] == v]
            in_edges = [eidx[e] for e in edges if e[1] == v]
            coeffs: Dict[int, float] = {}
            for e in out_edges:
                coeffs[x(i, e)] = coeffs.get(x(i, e), 0.0) + 1.0
            for e in in_edges:
                coeffs[x(i, e)] = coeffs.get(x(i, e), 0.0) - 1.0
            if v == s:
                rows.append((coeffs, 1.0, 1.0))     # src: one net outflow
            elif v == d:
                rows.append((coeffs, -1.0, -1.0))   # dst: one net inflow
            else:
                rows.append((coeffs, 0.0, 0.0))     # conservation
        # forbid flow back into src / out of dst (paper's extra constraints)
        for e in [eidx[e] for e in edges if e[1] == s]:
            rows.append(({x(i, e): 1.0}, 0.0, 0.0))
        for e in [eidx[e] for e in edges if e[0] == d]:
            rows.append(({x(i, e): 1.0}, 0.0, 0.0))

    for e in range(ne):
        coeffs = {x(i, e): 1.0 for i in range(nreq)}
        coeffs[zvar] = -1.0
        rows.append((coeffs, -np.inf, -float(existing.get(edges[e], 0))))

    A = lil_matrix((len(rows), nv))
    lb = np.empty(len(rows))
    ub = np.empty(len(rows))
    for k, (coeffs, lo, hi) in enumerate(rows):
        for var, coef in coeffs.items():
            A[k, var] = coef
        lb[k] = lo
        ub[k] = hi

    integrality = np.ones(nv)
    lo_b = np.zeros(nv)
    hi_b = np.ones(nv)
    hi_b[zvar] = np.inf
    from scipy.optimize import Bounds

    res = milp(
        c=c,
        constraints=LinearConstraint(A.tocsr(), lb, ub),
        integrality=integrality,
        bounds=Bounds(lo_b, hi_b),
    )
    if not res.success:
        raise RuntimeError(f"fiber MILP failed: {res.message}")
    xs = np.round(res.x[:zvar]).astype(int).reshape(nreq, ne)
    routes = []
    for i, (s, d) in enumerate(demands):
        nxt = {edges[e][0]: edges[e][1] for e in range(ne) if xs[i, e]}
        path = [s]
        guard = 0
        while path[-1] != d:
            path.append(nxt[path[-1]])
            guard += 1
            if guard > topo.n:
                raise RuntimeError("cyclic MILP route")
        routes.append(path)
    load: Dict[Edge, int] = dict(existing)
    for e in range(ne):
        tot = int(xs[:, e].sum())
        if tot:
            load[edges[e]] = load.get(edges[e], 0) + tot
    return FiberRouting(routes, load, int(round(res.fun)), time.perf_counter() - t0)


def random_demands(topo: Topology, k: int, seed: int = 0) -> List[Edge]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        s, d = rng.choice(topo.n, size=2, replace=False)
        out.append((int(s), int(d)))
    return out


def server_grid(n_servers: int) -> Topology:
    """The paper's evaluation substrate: a square-ish server grid (64 → 8×8)."""
    from .topology import square_dims2

    a, b = square_dims2(n_servers)
    return grid2d(a, b)
