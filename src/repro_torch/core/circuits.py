"""Algorithm 3: routing optical circuits on the MZI mesh (paper §4.2, App. B).

The interposer's optical fabric is modeled as a grid graph whose nodes are
MZI switches and whose edges are waveguide segments.  A circuit request is
``(src_node, dst_node, wavelength)``; a route is valid iff no waveguide on it
already carries a circuit of the same wavelength (one circuit per λ per
waveguide).  Routing is shortest-path with edge penalization: occupied
same-λ edges are made expensive, an invalid candidate path penalizes its
conflicted edges further, and the search retries up to TRIALS times
(Algorithm 3 verbatim, with the Dijkstra inner loop done by
``scipy.sparse.csgraph.dijkstra`` so a 256×256 mesh with 65 K MZIs routes in
well under the paper's 2.5 s budget — Fig. 19a).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

_BLOCK = 1.0e7  # weight that effectively forbids an edge for this search


@dataclass
class MZIMesh:
    """rows × cols grid of MZI nodes; 4-neighbour waveguide edges."""

    rows: int
    cols: int

    def __post_init__(self) -> None:
        n = self.rows * self.cols
        heads: List[int] = []
        tails: List[int] = []
        for r in range(self.rows):
            for c in range(self.cols):
                u = r * self.cols + c
                if c + 1 < self.cols:
                    heads.append(u)
                    tails.append(u + 1)
                if r + 1 < self.rows:
                    heads.append(u)
                    tails.append(u + self.cols)
        # store undirected edges once; expand to symmetric CSR on demand
        self._eu = np.asarray(heads, dtype=np.int64)
        self._ev = np.asarray(tails, dtype=np.int64)
        self.n_nodes = n
        self.n_edges = len(heads)
        self._edge_index: Dict[Tuple[int, int], int] = {}
        for i, (u, v) in enumerate(zip(heads, tails)):
            self._edge_index[(u, v)] = i
            self._edge_index[(v, u)] = i

    def edge_id(self, u: int, v: int) -> int:
        return self._edge_index[(u, v)]

    def graph(self, weights: np.ndarray) -> csr_matrix:
        row = np.concatenate([self._eu, self._ev])
        col = np.concatenate([self._ev, self._eu])
        dat = np.concatenate([weights, weights])
        return csr_matrix((dat, (row, col)), shape=(self.n_nodes, self.n_nodes))


@dataclass
class CircuitRequest:
    src: int
    dst: int
    wavelength: int = 0


@dataclass
class RoutingResult:
    routes: Dict[int, List[int]]             # request index -> node path
    edge_counts: Dict[int, np.ndarray]       # wavelength -> per-edge circuit count
    failed: List[int]
    elapsed_s: float

    @property
    def max_edge_load(self) -> int:
        if not self.edge_counts:
            return 0
        return int(max(int(c.max()) for c in self.edge_counts.values()))


def route_circuits(
    mesh: MZIMesh,
    requests: Sequence[CircuitRequest],
    max_overlap: int = 0,
    trials: int = 6,
    penalize_factor: float = 4.0,
    rip_up: bool = True,
    restarts: int = 2,
) -> RoutingResult:
    """Algorithm 3: Mesh Routing with Edge Reuse Constraint.

    ``rip_up=True`` adds a bounded rip-up-and-reroute fallback beyond the
    paper's greedy loop: when a request cannot find a conflict-free path, the
    circuits blocking its cheapest path are torn out, the request is placed,
    and the victims are re-routed.  This fixes greedy ordering artefacts
    (e.g. an early circuit turning at a mesh corner consumes both corner
    waveguides) without changing the algorithm's validity invariant.

    ``restarts`` retries the whole placement with failed requests promoted to
    the front of the order (negotiated-congestion style): a request that lost
    to earlier greedy choices claims its waveguides first on the next pass.
    Passes with no failures never restart, so routable instances pay nothing.
    """
    t0 = time.perf_counter()
    order = list(range(len(requests)))
    routes, counts, failed = _route_pass(
        mesh, requests, order, max_overlap, trials, penalize_factor, rip_up
    )
    for _ in range(restarts):
        if not failed:
            break
        order = failed + [i for i in order if i not in failed]
        r2, c2, f2 = _route_pass(
            mesh, requests, order, max_overlap, trials, penalize_factor, rip_up
        )
        if len(f2) >= len(failed):
            # passes are deterministic: the same failed-first order would
            # just repeat this result — stop instead of re-running it
            break
        routes, counts, failed = r2, c2, f2
    return RoutingResult(
        routes, counts, sorted(failed), time.perf_counter() - t0
    )


def _route_pass(
    mesh: MZIMesh,
    requests: Sequence[CircuitRequest],
    order: Sequence[int],
    max_overlap: int,
    trials: int,
    penalize_factor: float,
    rip_up: bool,
):
    """One greedy placement pass over ``requests`` in ``order``."""
    base = np.ones(mesh.n_edges)
    counts: Dict[int, np.ndarray] = {}
    penalties: Dict[int, np.ndarray] = {}
    routes: Dict[int, List[int]] = {}
    failed: List[int] = []

    def edges_of(path: List[int]) -> List[int]:
        return [mesh.edge_id(a, b) for a, b in zip(path[:-1], path[1:])]

    def try_route(req: CircuitRequest) -> Optional[List[int]]:
        """The paper's trials loop: penalized Dijkstra until conflict-free."""
        lam = req.wavelength
        cnt = counts.setdefault(lam, np.zeros(mesh.n_edges, dtype=np.int64))
        pen = penalties.setdefault(lam, np.ones(mesh.n_edges))
        for _ in range(trials):
            # ``max_overlap`` same-λ circuits are tolerated per waveguide;
            # default 0 → an occupied waveguide is (soft-)blocked for this λ.
            w = np.where(cnt > max_overlap, _BLOCK, base * pen)
            g = mesh.graph(w)
            dist, pred = dijkstra(
                g, directed=False, indices=req.src, return_predecessors=True
            )
            if not np.isfinite(dist[req.dst]):
                return None
            path = _extract_path(pred, req.src, req.dst)
            conflicted = [e for e in edges_of(path) if cnt[e] > max_overlap]
            if not conflicted and dist[req.dst] < _BLOCK:
                return path
            for e in conflicted or edges_of(path):
                pen[e] *= penalize_factor  # Alg. 3 line 11
        return None

    def commit(ridx: int, req: CircuitRequest, path: List[int]) -> None:
        routes[ridx] = path
        cnt = counts[req.wavelength]
        pen = penalties[req.wavelength]
        for e in edges_of(path):
            cnt[e] += 1
            pen[e] *= 1.05  # mild load-balancing for later searches

    def uncommit(ridx: int, req: CircuitRequest) -> None:
        cnt = counts[req.wavelength]
        for e in edges_of(routes.pop(ridx)):
            cnt[e] -= 1

    for ridx in order:
        req = requests[ridx]
        path = try_route(req)
        if path is not None:
            commit(ridx, req, path)
            continue
        if rip_up:
            path = _rip_up_place(mesh, requests, ridx, req, routes, counts,
                                 max_overlap, try_route, commit, uncommit)
            if path is not None:
                continue
        failed.append(ridx)
    return routes, counts, failed


def _rip_up_place(mesh, requests, ridx, req, routes, counts, max_overlap,
                  try_route, commit, uncommit) -> Optional[List[int]]:
    """Tear out the circuits blocking `req`'s cheapest path, place it, then
    re-route the victims (single level; victims may not rip further)."""
    lam = req.wavelength
    cnt = counts[lam]
    # cheapest path counting conflicts as a (finite) cost
    w = np.where(cnt > max_overlap, 1000.0, 1.0)
    g = mesh.graph(w)
    dist, pred = dijkstra(g, directed=False, indices=req.src, return_predecessors=True)
    if not np.isfinite(dist[req.dst]):
        return None
    path = _extract_path(pred, req.src, req.dst)
    want = {mesh.edge_id(a, b) for a, b in zip(path[:-1], path[1:])}
    victims = []
    for other_idx, other_path in list(routes.items()):
        if requests[other_idx].wavelength != lam:
            continue
        oe = {mesh.edge_id(a, b) for a, b in zip(other_path[:-1], other_path[1:])}
        if oe & want:
            victims.append(other_idx)
    for v in victims:
        uncommit(v, requests[v])
    if any(cnt[e] > max_overlap for e in want):
        # still conflicted (other-λ or shared victims) — restore and give up
        for v in victims:
            p = try_route(requests[v])
            if p is not None:
                commit(v, requests[v], p)
        return None
    commit(ridx, req, path)
    lost = []
    for v in victims:
        p = try_route(requests[v])
        if p is not None:
            commit(v, requests[v], p)
        else:
            lost.append(v)
    if lost:
        # placing `req` stranded a victim — undo everything
        uncommit(ridx, req)
        for v in victims:
            if v in routes:
                uncommit(v, requests[v])
        for v in victims:
            p = try_route(requests[v])
            if p is not None:
                commit(v, requests[v], p)
        return None
    return path


def _extract_path(pred: np.ndarray, src: int, dst: int) -> List[int]:
    path = [dst]
    while path[-1] != src:
        p = int(pred[path[-1]])
        if p < 0:
            raise RuntimeError("broken predecessor chain")
        path.append(p)
    path.reverse()
    return path


def random_requests(
    mesh: MZIMesh, k: int, n_wavelengths: int = 1, seed: int = 0
) -> List[CircuitRequest]:
    """Random (src, dst) pairs on distinct nodes — the Fig. 19a workload."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(k):
        s, d = rng.choice(mesh.n_nodes, size=2, replace=False)
        reqs.append(CircuitRequest(int(s), int(d), int(rng.integers(n_wavelengths))))
    return reqs


def validate_routes(mesh: MZIMesh, result: RoutingResult,
                    requests: Sequence[CircuitRequest], max_overlap: int = 0) -> None:
    """Check signal-integrity invariant: per λ, per waveguide, ≤ 1+max_overlap
    circuits; and each route actually connects its endpoints."""
    per_lam: Dict[int, np.ndarray] = {}
    for ridx, path in result.routes.items():
        req = requests[ridx]
        assert path[0] == req.src and path[-1] == req.dst, "route endpoints wrong"
        cnt = per_lam.setdefault(req.wavelength, np.zeros(mesh.n_edges, dtype=np.int64))
        for a, b in zip(path[:-1], path[1:]):
            cnt[mesh.edge_id(a, b)] += 1
    for lam, cnt in per_lam.items():
        assert cnt.max() <= 1 + max_overlap, (
            f"wavelength {lam} has {int(cnt.max())} overlapping circuits"
        )
