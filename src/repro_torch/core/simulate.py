"""Chunk-level semantic simulator for collective schedules.

Executes a :class:`~repro_torch.core.schedules.Schedule`'s rounds on symbolic chunk
state and checks the collective's post-condition (§3, Fig. 4).  This is the
oracle that proves a schedule is *correct* independent of its cost, and it is
exercised by unit + hypothesis property tests for every generator.

Semantics
---------
* reduce-scatter / all-reduce reductions are tracked as *contribution masks*:
  each rank's copy of chunk ``c`` is the set of source ranks whose data has
  been folded in.  Sending with ``reduce=True`` unions masks at the receiver;
  the sender retires its copy (it transferred responsibility).
* all-gather / all-to-all track chunk *presence* (masks are just replicated).

Post-conditions verified
------------------------
* reduce_scatter: rank c holds chunk c with mask == all ranks.
* all_gather:     every rank holds every chunk.
* all_reduce:     every rank holds every chunk fully reduced.
* all_to_all:     rank t holds block (s → t) for every s.
* p2p:            dst holds the payload.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .schedules import Schedule

Mask = int  # bitmask of contributing ranks


def _full_mask(n: int) -> Mask:
    return (1 << n) - 1


class SimulationError(AssertionError):
    pass


def simulate(schedule: Schedule) -> List[Dict[int, Mask]]:
    """Run the schedule; returns final per-rank {chunk_id: contribution mask}."""
    n = schedule.n
    state: List[Dict[int, Mask]] = [dict() for _ in range(n)]

    if schedule.collective in ("reduce_scatter", "all_reduce"):
        for r in range(n):
            for c in range(n):
                state[r][c] = 1 << r
    elif schedule.collective == "all_gather":
        for r in range(n):
            state[r][r] = _full_mask(n)  # AG input is already reduced
    elif schedule.collective == "all_to_all":
        for s in range(n):
            for t in range(n):
                state[s][s * n + t] = 1 << s
    elif schedule.collective == "p2p":
        src = schedule.rounds[0].transfers[0].src
        state[src][0] = 1 << src
    else:
        raise ValueError(f"unknown collective {schedule.collective}")

    for ri, rnd in enumerate(schedule.rounds):
        # two-phase: read all sends against pre-round state, then apply
        sends: List[Tuple[int, int, int, Mask, bool]] = []  # (src,dst,chunk,mask,reduce)
        for t in rnd.transfers:
            for c in t.chunks:
                if c not in state[t.src]:
                    raise SimulationError(
                        f"round {ri}: rank {t.src} sends chunk {c} it does not hold"
                    )
                sends.append((t.src, t.dst, c, state[t.src][c], t.reduce))
        for src, dst, c, mask, reduce in sends:
            if reduce:
                state[dst][c] = state[dst].get(c, 0) | mask
                # sender hands off its partial — mirrors in-place RS buffers
                del state[src][c]
            else:
                state[dst][c] = state[dst].get(c, 0) | mask
    return state


def verify(schedule: Schedule) -> None:
    """Raise SimulationError unless the post-condition holds."""
    n = schedule.n
    full = _full_mask(n)
    state = simulate(schedule)

    if schedule.collective == "reduce_scatter":
        for r in range(n):
            if state[r].get(r, 0) != full:
                raise SimulationError(
                    f"rank {r} chunk {r} mask={state[r].get(r, 0):b}, want full"
                )
    elif schedule.collective == "all_gather":
        for r in range(n):
            for c in range(n):
                if state[r].get(c, 0) != full:
                    raise SimulationError(f"rank {r} missing chunk {c}")
    elif schedule.collective == "all_reduce":
        # composition schedules (rs rounds then ag rounds): ag rounds replicate
        for r in range(n):
            for c in range(n):
                if state[r].get(c, 0) != full:
                    raise SimulationError(f"rank {r} chunk {c} not fully reduced")
    elif schedule.collective == "all_to_all":
        for t in range(n):
            for s in range(n):
                if state[t].get(s * n + t, 0) != (1 << s):
                    raise SimulationError(f"rank {t} missing block {s}->{t}")
    elif schedule.collective == "p2p":
        tr = schedule.rounds[0].transfers[0]
        if state[tr.dst].get(0, 0) != (1 << tr.src):
            raise SimulationError("p2p payload not delivered")
    else:
        raise ValueError(schedule.collective)
