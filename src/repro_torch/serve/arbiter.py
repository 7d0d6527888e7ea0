"""Online fabric arbiter: SLA-aware serving control plane over one fabric.

A copy of ``repro.serve.arbiter`` (a numpy control plane over the copied
planner; its clock is virtual, so its outcomes equal the reference's).

A serving deployment multiplexes three collective streams onto the same
photonic fabric: **prefill** tensor-parallel all-reduces (full prompt
activations, bandwidth-bound), **decode** data-parallel all-gathers
(per-token activations, latency-bound), and **KV-cache migrations**
(all-to-all reshuffles when sequences move between replicas).  The paper's
planner answers "what is the cheapest joint execution *right now*"
(:meth:`PcclSession.plan_concurrent`); this module adds the *online*
control plane around it:

* **Admission** — a bounded queue ordered by deadline (EDF).  A full queue
  sheds the *latest-deadline* request with an attributable outcome
  (``queue_full``), never silently.
* **Batched joint planning** — each :meth:`FabricArbiter.tick` coalesces
  queued work into per-stream collectives (sizes bucketed to powers of two
  so repeat shapes hit the session's two-level plan cache — admission of a
  familiar ``(collective, n, nbytes)`` shape is O(1)), and prices them as
  one :class:`~repro_torch.api.ConcurrentPlanRequest` with arrival-round
  ``offsets``: prefill's first all-reduce trails its compute lead, so
  decode starts immediately and prefill pre-positions its circuits during
  the idle prefix.
* **Preemption** — when the joint round would blow the earliest decode
  deadline, decode steals the fabric: the round is re-planned without
  prefill (the preempted stream's structures stay cached, so resuming it
  next round pays only the numeric phase).  A preemption that lands during
  an in-flight fused dispatch falls back to unfused execution and is
  counted (``fused_fallbacks``).
* **Load shedding** — queued requests whose deadline passed are dropped
  with ``deadline_expired`` outcomes before every planning round, keeping
  tail latency of *admitted* work bounded under overload.
* **Fault survival** — :meth:`FabricArbiter.on_fault` turns a
  :class:`~repro_torch.runtime.fault.LinkFailure` into a warm incremental replan
  (:meth:`PcclSession.replan`); the stream continues on the degraded
  fabric with no cold restart.

Time is *virtual*: the arbiter advances its clock by each planned round's
cost (plus an optional fixed overhead), so behavior is deterministic and
benchmarks replay identical traces.  The JAX package's
``benchmarks/serve_bench.py`` compares the arbiter with FIFO; README.md §
"Serving control plane" has the lifecycle diagram.
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.api import (
    ConcurrentCollectiveRequest,
    ConcurrentPcclPlan,
    ConcurrentPlanRequest,
    PcclSession,
)
from repro_torch.core.schedules import mesh_groups
from repro_torch.runtime.fault import LinkFailure, replan_after_failure

PREFILL = "prefill"
DECODE = "decode"
KV_MIGRATION = "kv_migration"
KINDS = (PREFILL, DECODE, KV_MIGRATION)

SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline_expired"


def _bucket(x: int) -> int:
    """Round up to a power of two so repeat shapes share plan-cache keys."""
    return 1 << max(0, int(x - 1).bit_length()) if x > 1 else 1


@dataclass(frozen=True)
class SlaTarget:
    """Latency targets used to derive admission deadlines (seconds of
    virtual fabric time from arrival)."""

    prefill_s: float = 2e-3
    decode_s: float = 2e-4
    kv_migration_s: float = 5e-3

    def deadline(self, kind: str) -> float:
        try:
            return {
                PREFILL: self.prefill_s,
                DECODE: self.decode_s,
                KV_MIGRATION: self.kv_migration_s,
            }[kind]
        except KeyError:
            raise ValueError(
                f"unknown request kind {kind!r}; one of {KINDS}"
            ) from None


@dataclass(frozen=True)
class ServeRequest:
    """One unit of collective work admitted to the arbiter.

    ``context_len`` scales the payload (prompt tokens for prefill, cached
    tokens for a KV migration; ignored for decode, which always moves one
    token's activation per sequence).  ``deadline_s`` is absolute virtual
    time; build requests with :meth:`FabricArbiter.make_request` to derive
    it from the SLA target.
    """

    rid: int
    kind: str
    context_len: int
    arrival_s: float
    deadline_s: float

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown request kind {self.kind!r}; one of {KINDS}")
        if self.context_len < 1:
            raise ValueError(f"context_len must be >= 1, got {self.context_len}")


@dataclass
class RequestOutcome:
    """Per-request attributable outcome: every admitted or rejected request
    ends in exactly one of these."""

    rid: int
    kind: str
    status: str                    # "completed" | "shed"
    reason: str = ""               # shed reason; empty for completed
    arrival_s: float = 0.0
    finish_s: float = math.nan     # virtual completion time (completed only)
    latency_s: float = math.nan    # finish - arrival (completed only)
    preemptions: int = 0           # times this request's round was preempted


@dataclass(frozen=True)
class ArbiterConfig:
    """Control-plane policy knobs (planning inputs live on the session)."""

    queue_bound: int = 64          # admission queue capacity (EDF-ordered)
    max_batch: int = 8             # per-kind requests coalesced per round
    sla: SlaTarget = field(default_factory=SlaTarget)
    preemption: bool = True        # decode may steal circuits from prefill
    fused_dispatch: bool = False   # rounds dispatch through fused kernels
    prefill_lead_rounds: int = 1   # compute lead before prefill's first AR
    round_overhead_s: float = 0.0  # fixed per-round control overhead
    serialize_rounds: bool = False  # charge rounds at the sequential
    # (one-collective-at-a-time) cost — models a fabric-unaware scheduler;
    # the FIFO baseline of the JAX package's benchmarks/serve_bench.py sets this

    def __post_init__(self) -> None:
        if self.queue_bound < 1:
            raise ValueError(f"queue_bound must be >= 1, got {self.queue_bound}")
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.prefill_lead_rounds < 0:
            raise ValueError(
                f"prefill_lead_rounds must be >= 0, got {self.prefill_lead_rounds}"
            )


class FabricArbiter:
    """SLA-aware online arbiter for one ``tp × dp`` serving fabric.

    Args:
      session: the planning session (owns caches + fabric state).
      tp / dp: tensor- and data-parallel degrees; the fabric domain is
        ``n = tp * dp`` ranks (TP rows, DP columns, as in
        :func:`repro_torch.core.schedules.mesh_groups`).
      d_model: activation width — sets collective payload sizes.
      cfg: control-plane policy (:class:`ArbiterConfig`).
    """

    def __init__(
        self,
        session: PcclSession,
        *,
        tp: int,
        dp: int,
        d_model: int,
        cfg: Optional[ArbiterConfig] = None,
    ) -> None:
        if tp < 2:
            raise ValueError(f"arbiter needs tp >= 2 (got {tp}): prefill "
                             "all-reduces span TP groups")
        if dp < 2:
            raise ValueError(f"arbiter needs dp >= 2 (got {dp}): decode "
                             "all-gathers span DP groups")
        self.session = session
        self.tp, self.dp, self.n = tp, dp, tp * dp
        self.d_model = d_model
        self.cfg = cfg or ArbiterConfig()
        self.tp_groups, self.dp_groups = mesh_groups(tp, dp)
        self.clock = 0.0
        self.outcomes: List[RequestOutcome] = []
        self.preempted_rids: Dict[int, int] = {}   # rid -> preemption count
        self._queue: List[Tuple[float, int, ServeRequest]] = []  # EDF heap
        self._seq = 0
        self._busy_s = 0.0
        self.rounds = 0
        self.admitted = 0
        self.preemptions = 0
        self.fused_fallbacks = 0
        self.faults = 0

    # ---------------------------------------------------------- admission
    def make_request(
        self, kind: str, context_len: int = 1, *, arrival_s: Optional[float] = None
    ) -> ServeRequest:
        """Build a request with its deadline derived from the SLA target."""
        t = self.clock if arrival_s is None else float(arrival_s)
        self._seq += 1
        return ServeRequest(
            rid=self._seq, kind=kind, context_len=int(context_len),
            arrival_s=t, deadline_s=t + self.cfg.sla.deadline(kind),
        )

    def submit(self, req: ServeRequest) -> bool:
        """Admit ``req`` into the EDF queue; False = shed (``queue_full``).

        A full queue sheds the request holding the *latest* deadline —
        which may be the incumbent, not the newcomer — so overload never
        evicts urgent work in favor of slack work.
        """
        entry = (req.deadline_s, req.rid, req)
        if len(self._queue) >= self.cfg.queue_bound:
            worst = max(self._queue)
            if entry < worst:
                self._queue.remove(worst)
                heapq.heapify(self._queue)
                self._shed(worst[2], SHED_QUEUE_FULL)
            else:
                self._shed(req, SHED_QUEUE_FULL)
                return False
        heapq.heappush(self._queue, entry)
        self.admitted += 1
        return True

    def _shed(self, req: ServeRequest, reason: str) -> None:
        self.outcomes.append(RequestOutcome(
            rid=req.rid, kind=req.kind, status="shed", reason=reason,
            arrival_s=req.arrival_s,
            preemptions=self.preempted_rids.pop(req.rid, 0),
        ))

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------ planning
    def _collective_for(
        self, kind: str, batch: Sequence[ServeRequest]
    ) -> ConcurrentCollectiveRequest:
        """Map one kind's batch to a bucketed collective request."""
        count = _bucket(len(batch))
        if kind == PREFILL:
            # full prompt activation, reduced within each replica's TP row
            ctx = _bucket(max(r.context_len for r in batch))
            return ConcurrentCollectiveRequest(
                "all_reduce", 4.0 * count * ctx * self.d_model,
                groups=self.tp_groups, algorithm="auto",
            )
        if kind == DECODE:
            # one token's activation per sequence, gathered across replicas
            return ConcurrentCollectiveRequest(
                "all_gather", 4.0 * count * self.d_model,
                groups=self.dp_groups, algorithm="auto",
            )
        # KV migration: K and V cache pages reshuffled across the domain
        ctx = _bucket(max(r.context_len for r in batch))
        return ConcurrentCollectiveRequest(
            "all_to_all", 2 * 4.0 * ctx * self.d_model,
            groups=None, algorithm="auto",
        )

    def _offsets_for(self, kinds: Sequence[str]) -> Optional[Tuple[int, ...]]:
        """Arrival-round offsets: prefill's first all-reduce trails its
        compute lead, so decode/KV rounds start at joint round 0 and
        prefill pre-positions circuits during the idle prefix."""
        lead = self.cfg.prefill_lead_rounds
        if not lead or PREFILL not in kinds or len(kinds) < 2:
            return None
        return tuple(lead if k == PREFILL else 0 for k in kinds)

    def _plan(
        self,
        reqs: Sequence[ConcurrentCollectiveRequest],
        offsets: Optional[Tuple[int, ...]],
    ) -> ConcurrentPcclPlan:
        return self.session.submit(ConcurrentPlanRequest(
            tuple(reqs), n=self.n, offsets=offsets,
        ))

    def price_joint(
        self, prefill_bytes: float, decode_bytes: float
    ) -> ConcurrentPcclPlan:
        """Price one prefill-TP ∥ decode-DP step at explicit byte sizes
        (the :meth:`ServeEngine.concurrent_report` entry point; cached)."""
        return self._plan(
            (
                ConcurrentCollectiveRequest(
                    "all_reduce", prefill_bytes,
                    groups=self.tp_groups, algorithm="auto",
                ),
                ConcurrentCollectiveRequest(
                    "all_gather", decode_bytes,
                    groups=self.dp_groups, algorithm="auto",
                ),
            ),
            None,
        )

    # ---------------------------------------------------------------- tick
    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Run one arbiter round at virtual time ``max(clock, now)``.

        Expires overdue queue entries, coalesces up to ``max_batch``
        requests per kind (EDF order), plans them jointly with arrival
        offsets, applies decode preemption if the round would miss the
        earliest decode deadline, advances the clock by the executed
        round's cost, and completes the executed requests.  An empty queue
        is a no-op tick (clock still advances to ``now``).
        """
        if now is not None and now > self.clock:
            self.clock = float(now)
        self._expire()
        if not self._queue:
            return {"executed": 0, "round_s": 0.0, "preempted": False,
                    "queue_depth": 0}
        batches = self._take_batches()
        kinds = [k for k in KINDS if batches[k]]
        reqs = [self._collective_for(k, batches[k]) for k in kinds]
        cp = self._plan(reqs, self._offsets_for(kinds))
        preempted = False
        if (
            self.cfg.preemption
            and PREFILL in kinds
            and DECODE in kinds
            and self._misses_decode_deadline(batches[DECODE], cp.cost)
        ):
            preempted = True
            self.preemptions += 1
            if self.cfg.fused_dispatch:
                # the fused comm/compute stream for this round is already
                # specialized to the joint schedule; abandoning prefill
                # mid-dispatch falls back to plain (unfused) execution
                self.fused_fallbacks += 1
            for r in batches[PREFILL]:
                self.preempted_rids[r.rid] = self.preempted_rids.get(r.rid, 0) + 1
                heapq.heappush(self._queue, (r.deadline_s, r.rid, r))
            batches[PREFILL] = []
            kinds = [k for k in KINDS if batches[k]]
            reqs = [self._collective_for(k, batches[k]) for k in kinds]
            cp = self._plan(reqs, self._offsets_for(kinds))
        executed_s = cp.sequential_cost if self.cfg.serialize_rounds else cp.cost
        round_s = executed_s + self.cfg.round_overhead_s
        self.clock += round_s
        self._busy_s += round_s
        self.rounds += 1
        executed = 0
        for k in kinds:
            for r in batches[k]:
                executed += 1
                self.outcomes.append(RequestOutcome(
                    rid=r.rid, kind=r.kind, status="completed",
                    arrival_s=r.arrival_s, finish_s=self.clock,
                    latency_s=self.clock - r.arrival_s,
                    preemptions=self.preempted_rids.pop(r.rid, 0),
                ))
        return {
            "executed": executed,
            "round_s": round_s,
            "joint_s": cp.cost,
            "sequential_s": cp.sequential_cost,
            "speedup": cp.speedup,
            "preempted": preempted,
            "kinds": tuple(kinds),
            "queue_depth": len(self._queue),
        }

    def _expire(self) -> None:
        keep: List[Tuple[float, int, ServeRequest]] = []
        for entry in self._queue:
            if entry[2].deadline_s <= self.clock:
                self._shed(entry[2], SHED_DEADLINE)
            else:
                keep.append(entry)
        if len(keep) != len(self._queue):
            heapq.heapify(keep)
            self._queue = keep

    def _take_batches(self) -> Dict[str, List[ServeRequest]]:
        batches: Dict[str, List[ServeRequest]] = {k: [] for k in KINDS}
        deferred: List[Tuple[float, int, ServeRequest]] = []
        while self._queue:
            entry = heapq.heappop(self._queue)
            batch = batches[entry[2].kind]
            if len(batch) < self.cfg.max_batch:
                batch.append(entry[2])
            else:
                deferred.append(entry)
        for entry in deferred:
            heapq.heappush(self._queue, entry)
        return batches

    def _misses_decode_deadline(
        self, decode_batch: Sequence[ServeRequest], round_s: float
    ) -> bool:
        earliest = min(r.deadline_s for r in decode_batch)
        return self.clock + round_s + self.cfg.round_overhead_s > earliest

    # --------------------------------------------------------------- fault
    def on_fault(self, failure: LinkFailure) -> None:
        """Survive a mid-stream fabric fault: warm-replan a representative
        collective so the session's fabric/standard views degrade and the
        refreshed structures cache under the new fingerprint; subsequent
        ticks plan on the surviving links with no cold restart."""
        replan_after_failure(
            self.session, failure, "all_reduce",
            4.0 * self.cfg.max_batch * self.d_model, n=self.n,
        )
        self.faults += 1

    # --------------------------------------------------------------- stats
    def report(self) -> Dict[str, Any]:
        """Control-plane accounting over the arbiter's lifetime."""
        completed = [o for o in self.outcomes if o.status == "completed"]
        shed = [o for o in self.outcomes if o.status == "shed"]
        total = len(self.outcomes)
        lat = sorted(o.latency_s for o in completed)

        def pct(p: float) -> float:
            if not lat:
                return math.nan
            return lat[min(len(lat) - 1, int(p * len(lat)))]

        return {
            "tp": self.tp,
            "dp": self.dp,
            "n": self.n,
            "rounds": self.rounds,
            "admitted": self.admitted,
            "completed": len(completed),
            "shed": len(shed),
            "shed_rate": (len(shed) / total) if total else 0.0,
            "shed_reasons": {
                reason: sum(1 for o in shed if o.reason == reason)
                for reason in (SHED_QUEUE_FULL, SHED_DEADLINE)
            },
            "preemptions": self.preemptions,
            "fused_fallbacks": self.fused_fallbacks,
            "faults": self.faults,
            "queue_depth": len(self._queue),
            "clock_s": self.clock,
            "utilization": (self._busy_s / self.clock) if self.clock else 0.0,
            "latency_p50_s": pct(0.50),
            "latency_p99_s": pct(0.99),
            "plan_cache": {
                "hits": self.session.stats.hits,
                "misses": self.session.stats.misses,
            },
        }
