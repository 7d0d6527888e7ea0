"""Static chunk-dataflow verifier for collective schedules.

Abstract interpretation over a :class:`~repro_torch.core.schedules.Schedule`'s
rounds: per rank we track a lattice of chunk states —

* **absent** — the rank holds no live copy of the chunk;
* **partial** — a copy reduced over a *contribution mask* (bitmask of source
  ranks whose data has been folded in);
* **complete** — mask == all n ranks;
* **retired** — the rank held a copy but handed it off via a ``reduce``
  send; the physical buffer slot still contains the *stale* bytes.

This is deliberately stronger than the dynamic oracle in
``core/simulate.py``, whose mask-union semantics cannot distinguish a
double-counted contribution from an idempotent re-delivery.  The static
semantics here mirror what the executable interpreter actually does
(``comm/primitives.py``): a ``reduce`` receive is ``buf.at[slot].add(...)``
(so overlapping contributions double-count and adding into a retired slot
folds in stale data), and a store receive is ``buf.at[slot].set(...)``
(overwrite, so a partial store on top of a complete copy *loses* data).

Postconditions proven per collective (chunk-id conventions of
``core/schedules.py``):

* ``reduce_scatter`` — rank ``i`` holds chunk ``i`` reduced over all n
  contributions *exactly once* (disjointness of every merge is checked
  en route, so "exactly once" is structural, not just final-state).
* ``all_gather``    — every rank holds every chunk complete.
* ``all_reduce``    — every rank holds every chunk reduced over all n.
* ``all_to_all``    — rank ``t`` holds block ``s*n + t`` from origin ``s``
  for every ``s`` (origin→destination delivery).
* ``p2p``           — the destination holds the payload.

Failures are attributable: every :class:`Violation` carries the round
index, rank, chunk, a machine-readable ``kind``, and expected vs. actual
abstract state.  Schedules without chunk metadata (e.g. ``swing``, which
models only the (src, dst, w) pattern) raise
:class:`UnverifiableScheduleError` rather than vacuously passing.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ..core.schedules import Schedule

Mask = int  # bitmask of contributing ranks

#: Violation kinds emitted by the verifier (stable identifiers for tests).
KINDS = (
    "send-absent",  # rank sends a chunk it holds no live copy of
    "send-retired",  # rank sends a chunk it already handed off (stale bytes)
    "duplicate-contribution",  # reduce merge with overlapping masks
    "stale-slot-reduce",  # reduce lands in a retired slot (adds stale data)
    "reduce-into-absent",  # reduce lands in a slot that was never populated
    "conflicting-store",  # two same-round stores of one chunk disagree
    "mixed-reduce-store",  # one (rank, chunk) gets reduce + store in a round
    "postcondition",  # final abstract state misses the collective's goal
    "bad-rank",  # transfer endpoint outside [0, n)
    "self-transfer",  # src == dst
    "cross-group-transfer",  # transfer crosses a process-group boundary
    "bad-groups",  # groups overlap / rank outside every group
)


def _full_mask(n: int) -> Mask:
    return (1 << n) - 1


def _mask_str(mask: Mask) -> str:
    return "{" + ",".join(str(r) for r in range(mask.bit_length()) if mask >> r & 1) + "}"


class ScheduleVerificationError(AssertionError):
    """Raised by :func:`assert_verified` when a schedule fails verification."""

    def __init__(self, result: "VerificationResult"):
        self.result = result
        super().__init__(str(result))


class UnverifiableScheduleError(ScheduleVerificationError):
    """The schedule carries no chunk metadata, so dataflow cannot be checked."""

    def __init__(self, result: "VerificationResult"):
        super().__init__(result)


@dataclass(frozen=True)
class Violation:
    """One attributable verification failure."""

    kind: str
    round_index: Optional[int]  # None for postcondition violations
    rank: Optional[int]
    chunk: Optional[int]
    expected: str = ""
    actual: str = ""
    group: Optional[int] = None

    def __str__(self) -> str:
        where = "post" if self.round_index is None else f"round {self.round_index}"
        loc = f"{where}: rank {self.rank} chunk {self.chunk}"
        if self.group is not None:
            loc += f" (group {self.group})"
        msg = f"{loc} [{self.kind}]"
        if self.expected or self.actual:
            msg += f" expected {self.expected}, got {self.actual}"
        return msg


@dataclass(frozen=True)
class VerificationResult:
    """Outcome of verifying one schedule."""

    collective: str
    algorithm: str
    n: int
    ok: bool
    verifiable: bool
    violations: Tuple[Violation, ...] = ()
    rounds_checked: int = 0

    def __str__(self) -> str:
        head = f"{self.collective}/{self.algorithm} n={self.n}"
        if not self.verifiable:
            return f"{head}: unverifiable (no chunk metadata)"
        if self.ok:
            return f"{head}: verified over {self.rounds_checked} rounds"
        lines = [f"{head}: {len(self.violations)} violation(s)"]
        lines += [f"  {v}" for v in self.violations]
        return "\n".join(lines)


@dataclass
class _RankState:
    """Abstract per-rank chunk state."""

    held: Dict[int, Mask] = field(default_factory=dict)
    retired: Dict[int, Mask] = field(default_factory=dict)


def _initial_states(schedule: Schedule) -> List[_RankState]:
    n = schedule.n
    states = [_RankState() for _ in range(n)]
    if schedule.collective in ("reduce_scatter", "all_reduce"):
        for r in range(n):
            for c in range(n):
                states[r].held[c] = 1 << r
    elif schedule.collective == "all_gather":
        for r in range(n):
            states[r].held[r] = _full_mask(n)  # AG input is already reduced
    elif schedule.collective == "all_to_all":
        for s in range(n):
            for t in range(n):
                states[s].held[s * n + t] = 1 << s
    elif schedule.collective == "p2p":
        for rnd in schedule.rounds:
            for t in rnd.transfers:
                states[t.src].held[0] = 1 << t.src
                return states
    else:
        raise ValueError(f"unknown collective {schedule.collective!r}")
    return states


def _check_postcondition(
    schedule: Schedule, states: List[_RankState], out: List[Violation], limit: int
) -> None:
    n = schedule.n
    full = _full_mask(n)

    def fail(rank: int, chunk: int, expected: str, actual: str) -> None:
        if len(out) < limit:
            out.append(Violation("postcondition", None, rank, chunk, expected, actual))

    def actual_of(rank: int, chunk: int) -> str:
        st = states[rank]
        if chunk in st.held:
            return f"mask {_mask_str(st.held[chunk])}"
        if chunk in st.retired:
            return f"retired (stale mask {_mask_str(st.retired[chunk])})"
        return "absent"

    if schedule.collective == "reduce_scatter":
        for r in range(n):
            if states[r].held.get(r, 0) != full:
                fail(r, r, f"sum over all {n} contributions", actual_of(r, r))
    elif schedule.collective in ("all_gather", "all_reduce"):
        what = "complete copy" if schedule.collective == "all_gather" else (
            f"sum over all {n} contributions"
        )
        for r in range(n):
            for c in range(n):
                if states[r].held.get(c, 0) != full:
                    fail(r, c, what, actual_of(r, c))
    elif schedule.collective == "all_to_all":
        for t in range(n):
            for s in range(n):
                c = s * n + t
                if states[t].held.get(c, 0) != (1 << s):
                    fail(t, c, f"block {s}->{t} from origin {s}", actual_of(t, c))
    elif schedule.collective == "p2p":
        tr = next((t for rnd in schedule.rounds for t in rnd.transfers), None)
        if tr is None:
            fail(None, 0, "a point-to-point delivery", "empty schedule")
        elif states[tr.dst].held.get(0, 0) != (1 << tr.src):
            fail(tr.dst, 0, f"payload from rank {tr.src}", actual_of(tr.dst, 0))


def _verify_flat(schedule: Schedule, max_violations: int) -> Tuple[List[Violation], int]:
    """Interpret a group-free schedule; returns (violations, rounds checked)."""
    n = schedule.n
    states = _initial_states(schedule)
    out: List[Violation] = []

    def emit(v: Violation) -> None:
        if len(out) < max_violations:
            out.append(v)

    for ri, rnd in enumerate(schedule.rounds):
        # Phase 1: read every send against the pre-round state.
        # incoming[(dst, chunk)] = list of (src, mask, reduce)
        incoming: Dict[Tuple[int, int], List[Tuple[int, Mask, bool]]] = {}
        for t in rnd.transfers:
            if not (0 <= t.src < n and 0 <= t.dst < n):
                emit(Violation("bad-rank", ri, t.src, None,
                               f"ranks in [0,{n})", f"{t.src}->{t.dst}"))
                continue
            if t.src == t.dst:
                emit(Violation("self-transfer", ri, t.src, None,
                               "distinct endpoints", f"{t.src}->{t.dst}"))
                continue
            st = states[t.src]
            for c in t.chunks:
                if c in st.held:
                    incoming.setdefault((t.dst, c), []).append(
                        (t.src, st.held[c], t.reduce)
                    )
                elif c in st.retired:
                    emit(Violation("send-retired", ri, t.src, c,
                                   "live copy",
                                   f"retired (stale mask {_mask_str(st.retired[c])})"))
                else:
                    emit(Violation("send-absent", ri, t.src, c, "live copy", "absent"))

        # Phase 2: apply receives, then retire reduce-sent copies.
        reduce_sent: List[Tuple[int, int]] = []  # (src, chunk) handed off
        for (dst, c), arrivals in incoming.items():
            reduces = [(s, m) for s, m, red in arrivals if red]
            stores = [(s, m) for s, m, red in arrivals if not red]
            if reduces and stores:
                emit(Violation("mixed-reduce-store", ri, dst, c,
                               "a single receive mode",
                               f"{len(reduces)} reduce + {len(stores)} store"))
                continue
            st = states[dst]
            if reduces:
                if c in st.held:
                    acc = st.held[c]
                elif c in st.retired:
                    emit(Violation("stale-slot-reduce", ri, dst, c,
                                   "reduce into a live slot",
                                   f"retired (stale mask {_mask_str(st.retired[c])})"))
                    acc = 0
                else:
                    emit(Violation("reduce-into-absent", ri, dst, c,
                                   "reduce into a populated slot", "absent"))
                    acc = 0
                for s, m in reduces:
                    if acc & m:
                        emit(Violation("duplicate-contribution", ri, dst, c,
                                       "disjoint contribution masks",
                                       f"overlap {_mask_str(acc & m)} from rank {s}"))
                    acc |= m
                st.held[c] = acc
                st.retired.pop(c, None)
                for s, _ in reduces:
                    reduce_sent.append((s, c))
            else:
                masks = {m for _, m in stores}
                if len(masks) > 1:
                    emit(Violation("conflicting-store", ri, dst, c,
                                   "identical same-round stores",
                                   " vs ".join(_mask_str(m) for m in sorted(masks))))
                # overwrite semantics: the slot takes the incoming bytes,
                # whatever was there before (live, retired or absent).
                st.held[c] = stores[-1][1]
                st.retired.pop(c, None)
        for s, c in reduce_sent:
            st = states[s]
            if c in st.held:  # may have been refreshed by a same-round receive
                recv_here = (s, c) in incoming
                if not recv_here:
                    st.retired[c] = st.held.pop(c)

    _check_postcondition(schedule, states, out, max_violations)
    return out, len(schedule.rounds)


def _split_groups(
    schedule: Schedule, groups: Sequence[Sequence[int]], max_violations: int
) -> Tuple[List[Violation], int]:
    """Verify a ``replicate_groups`` composition: each group's sub-schedule is
    checked independently (group-local chunk ids, per the ``Communicator.split``
    convention); transfers crossing a group boundary are violations."""
    from ..core.schedules import Round, Transfer

    out: List[Violation] = []
    rank_to_group: Dict[int, int] = {}
    for gi, g in enumerate(groups):
        for r in g:
            if r in rank_to_group or not 0 <= r < schedule.n:
                out.append(Violation("bad-groups", None, r, None,
                                     "disjoint groups within [0,n)", f"rank {r}"))
                return out, 0
            rank_to_group[r] = gi
    if len(rank_to_group) != schedule.n:
        missing = sorted(set(range(schedule.n)) - set(rank_to_group))
        out.append(Violation("bad-groups", None, missing[0] if missing else None,
                             None, "groups cover every rank",
                             f"{len(missing)} uncovered"))
        return out, 0

    rounds_checked = 0
    for gi, g in enumerate(groups):
        local = {r: i for i, r in enumerate(g)}
        local_rounds: List[Round] = []
        for ri, rnd in enumerate(schedule.rounds):
            transfers = []
            for t in rnd.transfers:
                gs, gd = rank_to_group.get(t.src), rank_to_group.get(t.dst)
                if gs == gi or gd == gi:
                    if gs != gd:
                        if len(out) < max_violations:
                            out.append(Violation(
                                "cross-group-transfer", ri, t.src, None,
                                f"transfer within group {gi}",
                                f"{t.src}(g{gs})->{t.dst}(g{gd})", group=gi))
                        continue
                    if gs == gi:
                        transfers.append(Transfer(local[t.src], local[t.dst],
                                                  t.chunks, t.reduce))
            local_rounds.append(Round(tuple(transfers), rnd.size))
        sub = Schedule(schedule.collective, schedule.algorithm, len(g),
                       schedule.buffer_bytes, tuple(local_rounds))
        sub_viol, checked = _verify_flat(sub, max_violations - len(out))
        rounds_checked = max(rounds_checked, checked)
        for v in sub_viol:
            rank = g[v.rank] if v.rank is not None and v.rank < len(g) else v.rank
            out.append(Violation(v.kind, v.round_index, rank, v.chunk,
                                 v.expected, v.actual, group=gi))
    return out, rounds_checked


def verify_schedule(
    schedule: Schedule,
    *,
    groups: Optional[Sequence[Sequence[int]]] = None,
    max_violations: int = 50,
) -> VerificationResult:
    """Statically verify a schedule's collective postcondition.

    ``groups`` handles :func:`~repro_torch.core.schedules.replicate_groups`
    compositions: each group is verified as an independent ``m``-rank
    sub-collective with group-local chunk ids.

    Returns a :class:`VerificationResult`; never raises on mere violations
    (use :func:`assert_verified` for raise-on-failure semantics).
    """
    has_chunks = any(t.chunks for rnd in schedule.rounds for t in rnd.transfers)
    has_transfers = any(rnd.transfers for rnd in schedule.rounds)
    if has_transfers and not has_chunks:
        return VerificationResult(schedule.collective, schedule.algorithm,
                                  schedule.n, ok=False, verifiable=False)
    if groups is not None:
        violations, checked = _split_groups(schedule, groups, max_violations)
    else:
        violations, checked = _verify_flat(schedule, max_violations)
    return VerificationResult(
        schedule.collective, schedule.algorithm, schedule.n,
        ok=not violations, verifiable=True,
        violations=tuple(violations), rounds_checked=checked,
    )


def assert_verified(
    schedule: Schedule, *, groups: Optional[Sequence[Sequence[int]]] = None
) -> VerificationResult:
    """Verify and raise :class:`ScheduleVerificationError` on any failure.

    Schedules with no chunk metadata raise :class:`UnverifiableScheduleError`
    (a subclass), so "cannot check" is never silently reported as "correct".
    """
    result = verify_schedule(schedule, groups=groups)
    if not result.verifiable:
        raise UnverifiableScheduleError(result)
    if not result.ok:
        raise ScheduleVerificationError(result)
    return result
