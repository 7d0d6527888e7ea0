"""Collective communication schedules (the algorithm zoo of §5).

A :class:`Schedule` is the paper's ``R = {R_0 … R_{n-1}}``: an ordered list of
:class:`Round`s, each a set of transfers ``(src, dst)`` plus the per-transfer
payload size for that round (``w_i``).  Schedules are the single source of
truth shared by

* the analytical cost model / planner (which only needs ``(src, dst, w)``),
* the chunk-level semantic simulator (``core/simulate.py``) that proves every
  schedule satisfies its collective's post-condition, and
* the executable JAX collectives (``comm/primitives.py``) that interpret every
  round as one ``jax.lax.ppermute`` + local reduce/concat step.

To serve all three, transfers carry chunk metadata: ``chunks`` is the tuple of
logical chunk ids moved, and ``reduce`` says whether the receiver accumulates
(reduce-scatter-like) or stores (all-gather / all-to-all-like).

Implemented algorithms (paper §5 "Algorithms"):

* ``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_all_reduce`` — NCCL's
  bandwidth-optimal ring.
* ``rhd_reduce_scatter`` / ``rhd_all_gather`` / ``rhd_all_reduce`` — recursive
  halving/doubling (Thakur et al.), the paper's default PCCL input schedule.
* ``bucket_reduce_scatter`` / ``…all_gather`` / ``…all_reduce`` — the
  multi-dimensional torus "Bucket" algorithm (TPU-style, per-dimension rings).
* ``swing_reduce_scatter`` — Swing (De Sensi et al., NSDI'24) distance pattern.
* ``dex_all_to_all`` — hypercube direct-exchange AllToAll (Foster, ch. 11),
  latency-optimal log2(N) steps; the paper's AllToAll input (Fig. 10a).
* ``direct_all_to_all`` — N-1 round pairwise exchange (bandwidth-optimal).
* ``p2p`` — single point-to-point transfer (§6 PEER-TO-PEER nodes).

Chunk-id conventions
--------------------
Reduce-scatter / all-gather over ``N`` ranks split the buffer into ``N`` equal
chunks; chunk ``c`` "belongs" to rank ``c`` (RS post-condition: rank c holds
the fully reduced chunk c; AG pre-condition: rank c contributes chunk c).
All-to-all uses chunk id ``src * N + dst`` for the block rank ``src`` sends to
rank ``dst``.
"""

from __future__ import annotations

import hashlib
import math
import threading
from collections import OrderedDict
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .topology import Topology, from_transfers

# --------------------------------------------------------------------------- data


@dataclass(frozen=True, slots=True)
class Transfer:
    # slots: schedules at n=1024 hold millions of transfers; dropping the
    # per-instance dict roughly halves their footprint
    src: int
    dst: int
    chunks: Tuple[int, ...] = ()
    reduce: bool = False  # receiver accumulates (True) or stores (False)

    def pair(self) -> Tuple[int, int]:
        return (self.src, self.dst)


@dataclass(frozen=True)
class Round:
    transfers: Tuple[Transfer, ...]
    size: float  # bytes sent per transfer in this round (w_i)

    def pairs(self) -> List[Tuple[int, int]]:
        return [t.pair() for t in self.transfers]

    def max_fanout(self) -> int:
        out: Dict[int, int] = {}
        inn: Dict[int, int] = {}
        for t in self.transfers:
            out[t.src] = out.get(t.src, 0) + 1
            inn[t.dst] = inn.get(t.dst, 0) + 1
        return max(max(out.values(), default=0), max(inn.values(), default=0))

    def is_permutation(self) -> bool:
        """True iff every rank sends <=1 and receives <=1 — one circuit set."""
        return self.max_fanout() <= 1

    def ideal_topology(self, n: int) -> Topology:
        return from_transfers(n, [t.pair() for t in self.transfers], name="ideal")


@dataclass(frozen=True)
class Schedule:
    collective: str  # reduce_scatter | all_gather | all_reduce | all_to_all | p2p
    algorithm: str
    n: int
    buffer_bytes: float  # per-rank buffer size d
    rounds: Tuple[Round, ...]

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    def fingerprint(self) -> str:
        """Stable content hash of everything *execution* depends on.

        Covers ``(collective, algorithm, n)`` and every round's transfer
        tuples ``(src, dst, chunks, reduce)`` — i.e. the per-round
        permutations and chunk tables.  The encoding is injective: rounds
        are delimited by ``#R``, transfers by ``|``, fields by ``>``/``:``/
        ``,``, none of which can occur inside the integer fields — so
        distinct permutation or chunk tables collide only if blake2b
        itself does (regression-tested in ``tests/test_exec_engine.py``).

        Byte sizes (``buffer_bytes``, ``Round.size``) are **deliberately
        excluded**: they price the schedule (planner/cost-model inputs)
        but do not change what the executor does, so a buffer-size sweep
        over one rescaled template shares a single compiled executable.
        Never key size-dependent data (costs, plans) by fingerprint alone.

        Memoized on first use (cheap blake2b over a canonical encoding;
        the frozen dataclass stores it via ``object.__setattr__``).
        """
        fp = self.__dict__.get("_fingerprint")
        if fp is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(f"{self.collective}|{self.algorithm}|{self.n}".encode())
            for rnd in self.rounds:
                h.update(b"#R")
                for t in rnd.transfers:
                    chunks = ",".join(map(str, t.chunks))
                    h.update(f"|{t.src}>{t.dst}:{int(t.reduce)}:{chunks}".encode())
            fp = h.hexdigest()
            object.__setattr__(self, "_fingerprint", fp)
        return fp

    def total_bytes_per_rank(self) -> float:
        """Max bytes any single rank sends across the schedule (β proxy)."""
        sent: Dict[int, float] = {}
        for r in self.rounds:
            for t in r.transfers:
                sent[t.src] = sent.get(t.src, 0.0) + r.size
        return max(sent.values(), default=0.0)

    def round_sizes(self) -> List[float]:
        return [r.size for r in self.rounds]


# --------------------------------------------------------------------- helpers


Groups = Tuple[Tuple[int, ...], ...]


def mesh_groups(tp: int, dp: int) -> Tuple[Groups, Groups]:
    """(TP groups, DP groups) of a row-major ``tp×dp`` 2-D mesh placement:
    rank = d·tp + t, TP groups are the rows, DP groups the columns.  The
    canonical process-group layout for concurrent TP∥DP planning."""
    tp_groups = tuple(tuple(range(d * tp, (d + 1) * tp)) for d in range(dp))
    dp_groups = tuple(tuple(d * tp + t for d in range(dp)) for t in range(tp))
    return tp_groups, dp_groups


def replicate_groups(sched: Schedule, groups: Groups, n_axis: int) -> Schedule:
    """Replicate a group-local schedule across all groups of an axis.

    The input schedule is over ``m = len(group)`` local ranks; the output is
    over the full ``n_axis`` ranks with every group's transfers composed into
    each round — the process-group pattern (TP rows / DP columns of a 2-D
    mesh) used by ``Communicator.split`` and the concurrent-group arbiter.
    Chunk ids stay group-local (every rank holds ``m`` chunks), which is
    exactly what the ppermute interpreter indexes with.
    """
    rounds = []
    for rnd in sched.rounds:
        transfers = tuple(
            replace(t, src=g[t.src], dst=g[t.dst])
            for g in groups
            for t in rnd.transfers
        )
        rounds.append(Round(transfers, rnd.size))
    return Schedule(
        sched.collective, sched.algorithm, n_axis, sched.buffer_bytes, tuple(rounds)
    )


def _require_pow2(n: int, algo: str) -> int:
    if n < 2 or n & (n - 1):
        raise ValueError(f"{algo} requires power-of-two ranks, got {n}")
    return n.bit_length() - 1


def _chunk(d: float, n: int) -> float:
    return d / n


# ------------------------------------------------------------------------ ring


def ring_reduce_scatter(n: int, d: float) -> Schedule:
    """N-1 rounds; round t: rank i sends the partial of chunk (i - t - 1)
    mod N to i+1, receiver accumulates.  Chunk ids are born canonical: after
    N-1 rounds rank i holds the fully reduced chunk i (the naive "(i - t)
    mod N" labelling would leave rank i owning chunk i+1 and need an O(n²)
    relabelling pass — at n=1024 that pass doubled generation time)."""
    size = _chunk(d, n)
    ctup = [(c,) for c in range(n)]  # chunk tuples shared across rounds
    rounds = []
    for t in range(n - 1):
        transfers = tuple(
            Transfer(i, (i + 1) % n, chunks=ctup[(i - t - 1) % n], reduce=True)
            for i in range(n)
        )
        rounds.append(Round(transfers, size))
    return Schedule("reduce_scatter", "ring", n, d, tuple(rounds))


def ring_all_gather(n: int, d: float) -> Schedule:
    """N-1 rounds; round t: rank i forwards chunk (i - t) mod N to i+1."""
    size = _chunk(d, n)
    ctup = [(c,) for c in range(n)]  # chunk tuples shared across rounds
    rounds = []
    for t in range(n - 1):
        transfers = tuple(
            Transfer(i, (i + 1) % n, chunks=ctup[(i - t) % n], reduce=False)
            for i in range(n)
        )
        rounds.append(Round(transfers, size))
    return Schedule("all_gather", "ring", n, d, tuple(rounds))


def ring_all_reduce(n: int, d: float) -> Schedule:
    rs = ring_reduce_scatter(n, d)
    ag = ring_all_gather(n, d)
    return Schedule("all_reduce", "ring", n, d, rs.rounds + ag.rounds)


def ring_ef8_all_reduce(n: int, d: float) -> Schedule:
    """Ring all-reduce with int8-on-the-wire payloads (algorithm ``ring_ef8``).

    Same transfers and chunk metadata as :func:`ring_all_reduce` — the
    dataflow verifier proves the identical postcondition — but every
    round's wire size is ``/4``: payloads travel as int8 plus one fp32
    scale (amortized away for the chunk sizes the planner prices), so the
    cost model automatically prices bytes/4 serialization from
    ``Round.size`` with no special-casing.  Execution routes through
    :func:`repro_torch.comm.fusion.all_reduce_quantized`; the result is *lossy*,
    bounded by :func:`repro_torch.core.cost_model.compressed_ef_error_bound`, so
    arbitration only considers this algorithm when the caller declares a
    tolerance at least that large (``rel_error_tol``).
    """
    base = ring_all_reduce(n, d)
    rounds = tuple(Round(r.transfers, r.size * 0.25) for r in base.rounds)
    return Schedule("all_reduce", "ring_ef8", n, d, rounds)


# ------------------------------------------------------------------------- RHD


def _block_of(rank: int, bit: int, n: int) -> Tuple[int, ...]:
    """Chunk ids in rank's half w.r.t. the given bit position."""
    return tuple(c for c in range(n) if ((c >> bit) & 1) == ((rank >> bit) & 1))


def rhd_reduce_scatter(n: int, d: float) -> Schedule:
    """Recursive halving: log2(N) rounds, round k pairs ranks differing in bit
    (log2 N - 1 - k); each sends the half of the (still-needed) chunk range
    that belongs to the partner's side.  Sizes d/2, d/4, …, d/N."""
    k = _require_pow2(n, "rhd")
    rounds = []
    for step in range(k):
        bit = k - 1 - step
        transfers = []
        half = 1 << bit
        for i in range(n):
            partner = i ^ half
            # chunks still live for i form the aligned 2^(bit+1)-block around
            # i; the half sent is the partner's side of that block.
            block_start = (i >> (bit + 1)) << (bit + 1)
            send_start = block_start + (half if (partner >> bit) & 1 else 0)
            send = tuple(range(send_start, send_start + half))
            transfers.append(Transfer(i, partner, chunks=send, reduce=True))
        rounds.append(Round(tuple(transfers), d / (2 ** (step + 1))))
    return Schedule("reduce_scatter", "rhd", n, d, tuple(rounds))


def rhd_all_gather(n: int, d: float) -> Schedule:
    """Recursive doubling: round k pairs ranks differing in bit k; each sends
    everything it currently holds.  Sizes d/N, 2d/N, …, d/2 (paper Fig. 5)."""
    k = _require_pow2(n, "rhd")
    rounds = []
    for step in range(k):
        bit = step
        size = 1 << bit
        transfers = []
        for i in range(n):
            partner = i ^ size
            # holds the aligned 2^bit block containing its own chunk
            start = (i >> bit) << bit
            held = tuple(range(start, start + size))
            transfers.append(Transfer(i, partner, chunks=held, reduce=False))
        rounds.append(Round(tuple(transfers), d * (2 ** step) / n))
    return Schedule("all_gather", "rhd", n, d, tuple(rounds))


def rhd_all_reduce(n: int, d: float) -> Schedule:
    rs = rhd_reduce_scatter(n, d)
    ag = rhd_all_gather(n, d)
    return Schedule("all_reduce", "rhd", n, d, rs.rounds + ag.rounds)


# ---------------------------------------------------------------------- bucket


def _axis_ring_groups(dims: Sequence[int], axis: int) -> List[List[int]]:
    """Node groups forming rings along `axis` of a row-major multidim layout."""
    import itertools as it

    strides = []
    s = 1
    for dsz in reversed(dims):
        strides.append(s)
        s *= dsz
    strides.reverse()
    groups = []
    other_axes = [a for a in range(len(dims)) if a != axis]
    for other in it.product(*[range(dims[a]) for a in other_axes]):
        base = sum(c * strides[a] for c, a in zip(other, other_axes))
        groups.append([base + j * strides[axis] for j in range(dims[axis])])
    return groups


def bucket_reduce_scatter(dims: Sequence[int], d: float) -> Schedule:
    """Multi-dimensional bucket (TPU torus) reduce-scatter: per-dimension ring
    reduce-scatters over successively smaller shards.  All transfers are
    nearest-neighbour rings along one torus axis, so the schedule is
    congestion/dilation-free on a matching torus."""
    n = math.prod(dims)
    rounds: List[Round] = []
    shard = d  # bytes each rank still owns before this phase
    # chunk bookkeeping: chunk ids are flat ranks; at each phase the chunks a
    # rank is responsible for narrow to those sharing its coordinates on all
    # completed axes.
    import itertools as it

    strides = []
    s = 1
    for dsz in reversed(dims):
        strides.append(s)
        s *= dsz
    strides.reverse()

    def coord(r: int) -> Tuple[int, ...]:
        return tuple((r // strides[a]) % dims[a] for a in range(len(dims)))

    for axis, dsz in enumerate(dims):
        if dsz == 1:
            continue
        groups = _axis_ring_groups(dims, axis)
        per_round = shard / dsz
        for t in range(dsz - 1):
            transfers = []
            for grp in groups:
                for idx, node in enumerate(grp):
                    nxt = grp[(idx + 1) % dsz]
                    # chunks whose axis-coordinate equals (idx - t - 1) mod dsz
                    # travel this round (ring RS canonical rotation), and must
                    # agree with `node` on all previous axes' coordinates.
                    cc = coord(node)
                    sel = []
                    for c in range(n):
                        ccc = coord(c)
                        if any(ccc[a] != cc[a] for a in range(axis)):
                            continue
                        if ccc[axis] == (cc[axis] - t - 1) % dsz:
                            sel.append(c)
                    transfers.append(
                        Transfer(node, nxt, chunks=tuple(sel), reduce=True)
                    )
            rounds.append(Round(tuple(transfers), per_round))
        shard = shard / dsz
    return Schedule("reduce_scatter", f"bucket{len(dims)}d", n, d, tuple(rounds))


def bucket_all_gather(dims: Sequence[int], d: float) -> Schedule:
    """Mirror of bucket RS: per-dimension ring all-gathers, last axis first."""
    n = math.prod(dims)
    rs = bucket_reduce_scatter(dims, d)
    rounds: List[Round] = []
    for rnd in reversed(rs.rounds):
        rounds.append(
            Round(
                tuple(
                    Transfer(t.dst, t.src, chunks=t.chunks, reduce=False)
                    for t in rnd.transfers
                ),
                rnd.size,
            )
        )
    return Schedule("all_gather", f"bucket{len(dims)}d", n, d, tuple(rounds))


def bucket_all_reduce(dims: Sequence[int], d: float) -> Schedule:
    rs = bucket_reduce_scatter(dims, d)
    ag = bucket_all_gather(dims, d)
    return Schedule("all_reduce", f"bucket{len(dims)}d", len(ag.rounds) and rs.n or rs.n, d, rs.rounds + ag.rounds)


# ----------------------------------------------------------------------- swing


def swing_distance(step: int) -> int:
    """δ_s = (1 - (-2)^{s+1}) / 3 → 1, -1, 3, -5, 11, -21, …"""
    return (1 - (-2) ** (step + 1)) // 3


def swing_reduce_scatter(n: int, d: float) -> Schedule:
    """Swing (NSDI'24): log2(N) rounds; rank r talks to
    ρ(r, s) = r + (-1)^r · δ_s (mod N).  Halving sizes like RHD.  We model the
    communication pattern (src, dst, w) — chunk routing follows Swing's block
    permutation which the semantic simulator does not need to replay (the
    planner and figures use only the pattern; see tests for the permutation
    property)."""
    k = _require_pow2(n, "swing")
    rounds = []
    for step in range(k):
        delta = swing_distance(step)
        transfers = []
        for r in range(n):
            peer = (r + delta) % n if r % 2 == 0 else (r - delta) % n
            transfers.append(Transfer(r, peer, chunks=(), reduce=True))
        rounds.append(Round(tuple(transfers), d / (2 ** (step + 1))))
    return Schedule("reduce_scatter", "swing", n, d, tuple(rounds))


def swing_all_reduce(n: int, d: float) -> Schedule:
    rs = swing_reduce_scatter(n, d)
    mirror = tuple(
        Round(
            tuple(Transfer(t.dst, t.src, chunks=(), reduce=False) for t in r.transfers),
            r.size,
        )
        for r in reversed(rs.rounds)
    )
    return Schedule("all_reduce", "swing", n, d, rs.rounds + mirror)


# ------------------------------------------------------------------- all-to-all


def dex_all_to_all(n: int, d: float) -> Schedule:
    """Hypercube direct-exchange: log2(N) rounds; round k partner = r ^ 2^k;
    send every held block whose final destination differs in bit k.  Each
    round moves d/2 bytes per rank (α-optimal, β pays (d/2)·log N)."""
    k = _require_pow2(n, "dex")
    # track where blocks live: blocks[(origin, dest)] = current holder
    holder = {(o, t): o for o in range(n) for t in range(n)}
    rounds = []
    for step in range(k):
        bit = step
        transfers_by_pair: Dict[Tuple[int, int], List[int]] = {}
        for (o, t), h in holder.items():
            if ((t >> bit) & 1) != ((h >> bit) & 1):
                p = h ^ (1 << bit)
                transfers_by_pair.setdefault((h, p), []).append(o * n + t)
        transfers = tuple(
            Transfer(src, dst, chunks=tuple(sorted(chs)), reduce=False)
            for (src, dst), chs in sorted(transfers_by_pair.items())
        )
        for tr in transfers:
            for ch in tr.chunks:
                holder[(ch // n, ch % n)] = tr.dst
        rounds.append(Round(transfers, d / 2))
    assert all(h == t for (o, t), h in holder.items())
    return Schedule("all_to_all", "dex", n, d, tuple(rounds))


def direct_all_to_all(n: int, d: float) -> Schedule:
    """N-1 rounds; round t rank i sends its block for (i+t+1) mod n directly."""
    rounds = []
    for t in range(n - 1):
        transfers = tuple(
            Transfer(i, (i + t + 1) % n, chunks=(i * n + (i + t + 1) % n,), reduce=False)
            for i in range(n)
        )
        rounds.append(Round(transfers, _chunk(d, n)))
    return Schedule("all_to_all", "direct", n, d, tuple(rounds))


def ring_all_to_all(n: int, d: float) -> Schedule:
    """Ring-based AllToAll: blocks hop neighbour-to-neighbour; round t moves
    every block that still needs to travel ≥1 more hop one step forward.
    N-1 rounds, round t carries (n-1-t)/n · d bytes per rank."""
    rounds = []
    for t in range(n - 1):
        remaining = n - 1 - t
        chunks_by_pair: Dict[Tuple[int, int], List[int]] = {}
        for o in range(n):
            for dst in range(n):
                hops = (dst - o) % n
                if hops > t:  # still in flight; currently at (o + t) % n
                    cur = (o + t) % n
                    chunks_by_pair.setdefault((cur, (cur + 1) % n), []).append(o * n + dst)
        transfers = tuple(
            Transfer(s, r, chunks=tuple(sorted(c)), reduce=False)
            for (s, r), c in sorted(chunks_by_pair.items())
        )
        rounds.append(Round(transfers, d * remaining / n))
    return Schedule("all_to_all", "ring", n, d, tuple(rounds))


# ------------------------------------------------------------------------- p2p


def p2p(n: int, src: int, dst: int, d: float) -> Schedule:
    return Schedule(
        "p2p",
        "p2p",
        n,
        d,
        (Round((Transfer(src, dst, chunks=(0,), reduce=False),), d),),
    )


# ------------------------------------------------------- Tx/Rx-limit splitting


def split_for_fanout(schedule: Schedule, tx_limit: int) -> Schedule:
    """§4.2: if a round needs more simultaneous circuits per GPU than the tile
    has transmitters, split it into sub-rounds until every sub-round fits."""
    if tx_limit < 1:
        raise ValueError("tx_limit must be >= 1")
    new_rounds: List[Round] = []
    for rnd in schedule.rounds:
        if rnd.max_fanout() <= tx_limit:
            new_rounds.append(rnd)
            continue
        # greedy colouring: repeatedly peel a sub-round respecting the limit
        pending = list(rnd.transfers)
        while pending:
            out_cnt: Dict[int, int] = {}
            in_cnt: Dict[int, int] = {}
            take, rest = [], []
            for t in pending:
                if out_cnt.get(t.src, 0) < tx_limit and in_cnt.get(t.dst, 0) < tx_limit:
                    take.append(t)
                    out_cnt[t.src] = out_cnt.get(t.src, 0) + 1
                    in_cnt[t.dst] = in_cnt.get(t.dst, 0) + 1
                else:
                    rest.append(t)
            new_rounds.append(Round(tuple(take), rnd.size))
            pending = rest
    return replace(schedule, rounds=tuple(new_rounds))


# ------------------------------------------------- hierarchical decomposition


def pod_subschedules(
    schedule: Schedule, pods: Sequence[Sequence[int]]
) -> Tuple[
    Tuple[Schedule, ...],
    Tuple[int, ...],
    Tuple[Tuple[Tuple[Tuple[int, int], int], ...], ...],
]:
    """Split a schedule into per-pod intra-pod schedules plus the cross-pod
    boundary traffic (the two-level planner's inputs).

    Returns ``(intra, rep, boundary)``:

    * ``intra[p]`` — a planning-only :class:`Schedule` over pod ``p``'s local
      rank ids with exactly the global round count (rounds with no intra-pod
      transfers stay as empty rounds, keeping round indices aligned for
      stitching).  Chunk metadata is dropped: these schedules price
      communication, they are never executed.
    * ``rep[p]`` — the representative pod whose Schedule object ``intra[p]``
      *is*.  Pods with identical local round structure (same local pair
      multisets every round, same size) share one object, so structurally
      identical pods are planned once.
    * ``boundary[i]`` — round ``i``'s cross-pod traffic as sorted
      ``((src_pod, dst_pod), multiplicity)`` pairs.

    The decomposition is conservative: every transfer of every round appears
    either in exactly one pod's intra round or (as its pod pair) in the
    boundary multiset — ``analysis/invariants.py`` replays this containment.
    Rounds are deduplicated by pair multiset before any per-pod work, so
    e.g. a ring schedule's n−1 identical rounds decompose once.
    """
    import numpy as np

    n = schedule.n
    pods = tuple(tuple(p) for p in pods)
    pod_of = np.full(n, -1, dtype=np.int64)
    local_of = np.zeros(n, dtype=np.int64)
    for p, ranks in enumerate(pods):
        for j, r in enumerate(ranks):
            if not 0 <= r < n:
                raise ValueError(f"pod {p} rank {r} outside [0,{n})")
            if pod_of[r] != -1:
                raise ValueError(f"rank {r} appears in two pods")
            pod_of[r] = p
            local_of[r] = j
    if (pod_of == -1).any():
        raise ValueError("pods must cover every rank exactly once")
    P = len(pods)
    sizes = [len(p) for p in pods]
    mmax = max(sizes)

    # One decomposition per distinct round structure, deduplicated by the
    # pair *sequence* (cheap: a tuple of existing ints, no array build) —
    # slightly finer than the pair multiset, but generator-built schedules
    # emit repeated rounds in identical order, so e.g. a ring schedule's
    # 2(n−1) rounds still collapse to one entry.  Only distinct rounds pay
    # the numpy conversion; this pass is the only place in the planner that
    # touches every transfer of every round.
    from itertools import chain
    from operator import attrgetter

    get_sd = attrgetter("src", "dst")
    R = len(schedule.rounds)
    round_keys: List[int] = []
    key_index: Dict[Tuple, int] = {}
    distinct: List[Round] = []
    d_arrays: List = []                # [distinct] -> (srcs, dsts) or None
    for rnd in schedule.rounds:
        prs = tuple(map(get_sd, rnd.transfers))
        kidx = key_index.get(prs)
        if kidx is None:
            kidx = len(distinct)
            key_index[prs] = kidx
            distinct.append(rnd)
            if prs:
                arr = np.fromiter(
                    chain.from_iterable(prs), dtype=np.int64, count=2 * len(prs)
                ).reshape(-1, 2)
                arr = arr[arr[:, 0] != arr[:, 1]]
            if prs and len(arr):
                d_arrays.append((arr[:, 0], arr[:, 1]))
            else:
                d_arrays.append(None)
        round_keys.append(kidx)

    # per distinct round: boundary pairs + a per-pod signature of the local
    # pair multiset (sorted local codes as raw bytes — cheap to compare)
    d_boundary: List[Tuple[Tuple[Tuple[int, int], int], ...]] = []
    d_sigs: List[List[bytes]] = []     # [distinct][pod] -> signature
    d_local: List[Tuple] = []          # [distinct] -> (pod-sorted arrays) for pass 2
    for k, rnd in enumerate(distinct):
        if d_arrays[k] is None:
            d_boundary.append(())
            d_sigs.append([b""] * P)
            d_local.append(None)
            continue
        srcs, dsts = d_arrays[k]
        pu, pv = pod_of[srcs], pod_of[dsts]
        cross = pu != pv
        codes = pu[cross] * P + pv[cross]
        uniq, cnt = np.unique(codes, return_counts=True)
        d_boundary.append(tuple(
            ((int(c) // P, int(c) % P), int(k))
            for c, k in zip(uniq.tolist(), cnt.tolist())
        ))
        intra = ~cross
        ip = pu[intra]
        lcode = local_of[srcs[intra]] * mmax + local_of[dsts[intra]]
        order = np.lexsort((lcode, ip))
        ip_s, lcode_s = ip[order], lcode[order]
        bounds = np.searchsorted(ip_s, np.arange(P + 1))
        d_sigs.append([
            lcode_s[bounds[p]:bounds[p + 1]].tobytes() for p in range(P)
        ])
        d_local.append((ip_s, lcode_s, bounds))

    # pod classes: identical size + identical signature on every distinct round
    class_of: Dict[Tuple, int] = {}
    rep = [0] * P
    for p in range(P):
        ckey = (sizes[p], tuple(d_sigs[k][p] for k in range(len(distinct))))
        rep[p] = class_of.setdefault(ckey, p)

    # build intra schedules for representatives only
    rep_scheds: Dict[int, Schedule] = {}
    for p in set(rep):
        m = sizes[p]
        d_rounds: List[Round] = []
        for k, rnd in enumerate(distinct):
            if d_local[k] is None:
                d_rounds.append(Round((), rnd.size))
                continue
            ip_s, lcode_s, bounds = d_local[k]
            codes = lcode_s[bounds[p]:bounds[p + 1]]
            d_rounds.append(Round(
                tuple(
                    Transfer(int(c) // mmax, int(c) % mmax)
                    for c in codes.tolist()
                ),
                rnd.size,
            ))
        # rounds sharing a pair structure share the Round object unless
        # their payloads differ (then only the size is swapped out)
        rep_scheds[p] = Schedule(
            schedule.collective,
            f"{schedule.algorithm}@pod{p}",
            m,
            schedule.buffer_bytes,
            tuple(
                base if base.size == rnd.size else Round(base.transfers, rnd.size)
                for rnd, base in (
                    (schedule.rounds[i], d_rounds[round_keys[i]])
                    for i in range(R)
                )
            ),
        )
    intra = tuple(rep_scheds[rep[p]] for p in range(P))
    boundary = tuple(d_boundary[round_keys[i]] for i in range(R))
    return intra, tuple(rep), boundary


# ----------------------------------------------------------------- registries

ScheduleFn = Callable[[int, float], Schedule]

# Bounded LRU over (collective, algorithm, n, d, dims) → Schedule.  Schedules
# are deterministic in their key and immutable (frozen dataclasses; the lazy
# ``fingerprint`` memo is idempotent), so sharing one object across planner /
# session / bench callers is safe.  Generation is the single most expensive
# artifact at scale — an n=1024 ring all-reduce is ~2M Transfer objects —
# and unlike the planner's routing caches it does not depend on fabric state
# or hardware params, so ``planner.clear_planner_caches`` deliberately leaves
# this memo alone (cold *planning* never includes re-deriving the schedule).
# Capacity is small: entries are hundreds of MB at n=1024.
_SCHEDULE_CACHE: "OrderedDict[Tuple, Schedule]" = OrderedDict()
_SCHEDULE_CACHE_MAX = 8
_SCHEDULE_CACHE_LOCK = threading.Lock()


def clear_schedule_cache() -> None:
    """Drop every memoized ``get_schedule`` result (tests / memory pressure)."""
    with _SCHEDULE_CACHE_LOCK:
        _SCHEDULE_CACHE.clear()


def get_schedule(collective: str, algorithm: str, n: int, d: float,
                 dims: Optional[Sequence[int]] = None) -> Schedule:
    """Uniform constructor used by the planner facade and benchmarks.

    Memoized: repeated lookups of the same (collective, algorithm, n, d,
    dims) return one shared immutable Schedule object."""
    cache_key = (
        collective, algorithm, n, float(d),
        tuple(dims) if dims is not None else None,
    )
    with _SCHEDULE_CACHE_LOCK:
        hit = _SCHEDULE_CACHE.get(cache_key)
        if hit is not None:
            _SCHEDULE_CACHE.move_to_end(cache_key)
            return hit
    sched = _build_schedule(collective, algorithm, n, d, dims)
    with _SCHEDULE_CACHE_LOCK:
        _SCHEDULE_CACHE[cache_key] = sched
        _SCHEDULE_CACHE.move_to_end(cache_key)
        while len(_SCHEDULE_CACHE) > _SCHEDULE_CACHE_MAX:
            _SCHEDULE_CACHE.popitem(last=False)
    return sched


def _build_schedule(collective: str, algorithm: str, n: int, d: float,
                    dims: Optional[Sequence[int]] = None) -> Schedule:
    key = (collective, algorithm)
    if algorithm.startswith("bucket"):
        if dims is None:
            raise ValueError("bucket algorithms need torus dims")
        fn = {
            "reduce_scatter": bucket_reduce_scatter,
            "all_gather": bucket_all_gather,
            "all_reduce": bucket_all_reduce,
        }[collective]
        return fn(dims, d)
    table: Dict[Tuple[str, str], ScheduleFn] = {
        ("reduce_scatter", "ring"): ring_reduce_scatter,
        ("reduce_scatter", "rhd"): rhd_reduce_scatter,
        ("reduce_scatter", "swing"): swing_reduce_scatter,
        ("all_gather", "ring"): ring_all_gather,
        ("all_gather", "rhd"): rhd_all_gather,
        ("all_reduce", "ring"): ring_all_reduce,
        ("all_reduce", "ring_ef8"): ring_ef8_all_reduce,
        ("all_reduce", "rhd"): rhd_all_reduce,
        ("all_reduce", "swing"): swing_all_reduce,
        ("all_to_all", "dex"): dex_all_to_all,
        ("all_to_all", "direct"): direct_all_to_all,
        ("all_to_all", "ring"): ring_all_to_all,
    }
    if key not in table:
        raise KeyError(f"no schedule for {key}")
    return table[key](n, d)
