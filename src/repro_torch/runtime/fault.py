"""Fault tolerance: failure injection, link failures, straggler detection.

A port of ``repro.runtime.fault``.  On a real fleet these hooks attach to
the coordinator's heartbeat service; here the *policies* are implemented
and tested against simulated signals.  The elastic half of the reference,
``shrink_mesh`` and ``reshard_tree`` (a smaller device mesh without the
failed slices, and the live tree re-sharded onto it), waits for the
port's multi-device group (ROADMAP, Queue 1).
"""

from __future__ import annotations

import collections
import statistics
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Dict, List, Sequence, Tuple

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.api.session import PcclSession
    from repro_torch.core.pccl import PcclPlan


# ----------------------------------------------------------- failure inject
class InjectedFailure(RuntimeError):
    pass


@dataclass(frozen=True)
class LinkFailure:
    """A fabric fault event: physical links (both directions die) and/or
    whole ranks (every incident link dies).  The unit handed to
    :func:`replan_after_failure` by whoever detects the fault — the
    heartbeat service on a real fleet, :class:`FailureInjector` in tests."""

    edges: Tuple[Tuple[int, int], ...] = ()
    ranks: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if not self.edges and not self.ranks:
            raise ValueError("LinkFailure needs at least one edge or rank")


def replan_after_failure(
    session: "PcclSession",
    failure: LinkFailure,
    collective: str,
    nbytes: float,
    *,
    n: int = None,
    algorithm: str = "paper_default",
) -> "PcclPlan":
    """Turn a fault event into a warm replan: the session re-prices only
    the states the failure touched (O(affected), bit-identical to a cold
    plan of the degraded fabric) and permanently drops the dead links from
    its fabric/standard views.  See :meth:`PcclSession.replan`."""
    return session.replan(
        collective,
        nbytes,
        n=n,
        algorithm=algorithm,
        failed_edges=failure.edges,
        failed_ranks=failure.ranks,
    )


def fail_link(target: Any, u: int, v: int, *, n: int = None) -> LinkFailure:
    """Kill the physical link ``u — v`` (both directions) mid-stream.

    ``target`` is either a :class:`~repro_torch.serve.arbiter.FabricArbiter`
    (anything with ``on_fault``) — the serving control plane warm-replans
    and keeps ticking on the degraded fabric — or a bare
    :class:`~repro_torch.api.PcclSession`, which is degraded via
    :func:`replan_after_failure` on a representative all-reduce.  Returns
    the injected :class:`LinkFailure` so tests can assert on it.
    """
    failure = LinkFailure(edges=((u, v),))
    on_fault = getattr(target, "on_fault", None)
    if on_fault is not None:
        on_fault(failure)
    else:
        replan_after_failure(target, failure, "all_reduce", 4096.0, n=n)
    return failure


@dataclass
class FailureInjector:
    """Deterministic failure schedule: raise at the given steps (tests) —
    stands in for hardware events the trainer must survive."""

    fail_at_steps: Sequence[int] = ()
    fired: set = field(default_factory=set)

    def check(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


# --------------------------------------------------------------- stragglers
@dataclass
class StragglerConfig:
    window: int = 20              # rolling window of step times
    threshold: float = 2.0        # flag hosts slower than τ × median
    min_samples: int = 5


class StragglerDetector:
    """Per-host step-time tracking with τ×median flagging.

    Mitigation is the caller's choice (the trainer supports: rebalance data
    grains toward fast hosts, or evict + elastic re-mesh)."""

    def __init__(self, cfg: StragglerConfig, n_hosts: int):
        self.cfg = cfg
        self.times: Dict[int, collections.deque] = {
            h: collections.deque(maxlen=cfg.window) for h in range(n_hosts)
        }

    def record(self, host: int, step_time: float) -> None:
        self.times[host].append(step_time)

    def host_medians(self) -> Dict[int, float]:
        return {
            h: statistics.median(ts) for h, ts in self.times.items() if len(ts) >= self.cfg.min_samples
        }

    def stragglers(self) -> List[int]:
        med = self.host_medians()
        if len(med) < 2:
            return []
        global_med = statistics.median(med.values())
        return [h for h, m in med.items() if m > self.cfg.threshold * global_med]

    def rebalance_grains(self, total_grains: int) -> Dict[int, int]:
        """Assign data grains inversely proportional to median step time —
        the soft mitigation that keeps stragglers in the job."""
        med = self.host_medians()
        if not med:
            n = len(self.times)
            return {h: total_grains // n for h in range(n)}
        inv = {h: 1.0 / m for h, m in med.items()}
        z = sum(inv.values())
        alloc = {h: max(1, int(round(total_grains * w / z))) for h, w in inv.items()}
        # fix rounding drift
        drift = total_grains - sum(alloc.values())
        for h in sorted(alloc, key=lambda h: -inv[h]):
            if drift == 0:
                break
            alloc[h] += 1 if drift > 0 else -1
            drift += -1 if drift > 0 else 1
        return alloc
