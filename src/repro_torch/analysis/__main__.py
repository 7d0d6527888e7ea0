"""The static passes' command line: ``python -m repro_torch.analysis [--quick | --kernels]``.

A copy of ``repro.analysis.__main__``: the same sections, cases, printed
lines and exit code.

Runs the static passes over the built-in generator zoo and the planner:

1. chunk-dataflow verification of every schedule generator across the
   n-sweep (plus ``split_for_fanout`` / ``replicate_groups`` compositions);
2. round feasibility + Alg. 3/4 circuit realizability for representative
   schedules;
3. Alg. 1 plan accounting, reconfig-mode monotonicity, and concurrent
   joint-plan accounting on planner output.

Prints one line per section and exits non-zero on any violation.
``--quick`` caps the realizability sweep at n=8 (it dominates runtime).

``--kernels`` runs the kernel lint (:mod:`repro_torch.analysis.kernel_lint`)
over every route of the port's kernels at edge shapes and at the main
paths' shapes: one ``clean`` line per case, exit 0 when all are.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Iterable, List, Tuple

from ..core import schedules as S
from ..core import planner as P
from ..core.cost_model import H100_DGX
from ..core.topology import ring, standard_topologies
from .invariants import (
    check_circuit_realizability,
    check_concurrent_plan,
    check_mode_monotonicity,
    check_plan,
    check_round_feasibility,
)
from .verify import verify_schedule

_D = float(1 << 20)


def _generator_cases() -> Iterable[Tuple[str, S.Schedule, object]]:
    """(label, schedule, groups-or-None) for every verifiable generator."""
    for n in (2, 3, 4, 6, 8, 16):
        yield f"ring_rs n={n}", S.ring_reduce_scatter(n, _D), None
        yield f"ring_ag n={n}", S.ring_all_gather(n, _D), None
        yield f"ring_ar n={n}", S.ring_all_reduce(n, _D), None
        yield f"ring_ef8_ar n={n}", S.ring_ef8_all_reduce(n, _D), None
        yield f"direct_a2a n={n}", S.direct_all_to_all(n, _D), None
        yield f"ring_a2a n={n}", S.ring_all_to_all(n, _D), None
    for n in (2, 4, 8, 16):
        yield f"rhd_rs n={n}", S.rhd_reduce_scatter(n, _D), None
        yield f"rhd_ag n={n}", S.rhd_all_gather(n, _D), None
        yield f"rhd_ar n={n}", S.rhd_all_reduce(n, _D), None
        yield f"dex_a2a n={n}", S.dex_all_to_all(n, _D), None
    for dims in ((2, 2), (2, 3), (2, 4), (3, 3), (2, 2, 2), (4, 4), (2, 3, 4)):
        yield f"bucket_rs {dims}", S.bucket_reduce_scatter(dims, _D), None
        yield f"bucket_ag {dims}", S.bucket_all_gather(dims, _D), None
        yield f"bucket_ar {dims}", S.bucket_all_reduce(dims, _D), None
    yield "p2p 1->3", S.p2p(4, 1, 3, _D), None
    # compositions
    for n, tx in ((8, 1), (16, 2)):
        yield (f"split_fanout rhd_rs n={n} tx={tx}",
               S.split_for_fanout(S.rhd_reduce_scatter(n, _D), tx), None)
    tp_groups, dp_groups = S.mesh_groups(4, 2)
    yield ("replicate tp ring_ar",
           S.replicate_groups(S.ring_all_reduce(4, _D), tp_groups, 8), tp_groups)
    yield ("replicate dp rhd_rs",
           S.replicate_groups(S.rhd_reduce_scatter(2, _D), dp_groups, 8), dp_groups)


def _section(name: str, failures: List[str], t0: float) -> bool:
    status = "ok" if not failures else f"{len(failures)} FAILURE(S)"
    print(f"[verify] {name}: {status} ({time.perf_counter() - t0:.1f}s)")
    for f in failures:
        print(f"  {f}")
    return not failures


def run_kernels() -> int:
    """Kernel-lint section: analyze every shipped case and main-path shape."""
    from .kernel_lint import run_shipped

    t0 = time.perf_counter()
    failures = run_shipped(verbose=True)
    ok = _section("kernel lint (the port's CUDA and Triton launches)",
                  [f"{failures} failing case(s)"] if failures else [], t0)
    print(f"[verify] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def run(quick: bool = False) -> int:
    ok = True

    t0 = time.perf_counter()
    failures: List[str] = []
    n_cases = 0
    for label, sched, groups in _generator_cases():
        n_cases += 1
        res = verify_schedule(sched, groups=groups)
        if not res.verifiable or not res.ok:
            failures.append(f"{label}: {res}")
    ok &= _section(f"dataflow ({n_cases} schedules)", failures, t0)

    t0 = time.perf_counter()
    failures = []
    feas_cases = [S.ring_reduce_scatter(8, _D), S.rhd_all_reduce(8, _D),
                  S.dex_all_to_all(8, _D), S.direct_all_to_all(6, _D),
                  S.bucket_all_reduce((2, 4), _D)]
    for sched in feas_cases:
        for v in check_round_feasibility(sched, H100_DGX):
            failures.append(f"{sched.algorithm}/{sched.collective}: {v}")
    ok &= _section(f"round feasibility ({len(feas_cases)} schedules)", failures, t0)

    t0 = time.perf_counter()
    failures = []
    realiz = [S.rhd_reduce_scatter(8, _D), S.direct_all_to_all(8, _D),
              S.ring_all_reduce(8, _D)]
    if not quick:
        realiz += [S.dex_all_to_all(16, _D), S.ring_all_to_all(16, _D)]
    for sched in realiz:
        for v in check_circuit_realizability(sched):
            failures.append(f"{sched.algorithm}/{sched.collective} "
                            f"n={sched.n}: {v}")
    ok &= _section(f"circuit realizability ({len(realiz)} schedules)", failures, t0)

    t0 = time.perf_counter()
    failures = []
    n = 8
    g0 = ring(n)
    std = list(standard_topologies(n).values())
    plan_cases = [
        (S.rhd_reduce_scatter(n, _D), H100_DGX),
        (S.dex_all_to_all(n, _D), H100_DGX),
        (S.ring_all_reduce(n, _D),
         H100_DGX.with_link_reconfig(H100_DGX.reconfig_delay / 8)),
        (S.rhd_all_reduce(n, _D),
         H100_DGX.with_link_reconfig(H100_DGX.reconfig_delay / 8, overlap=True)),
    ]
    for sched, hw in plan_cases:
        p = P.plan(g0, std, sched, hw)
        for v in check_plan(p, g0, std):
            failures.append(f"plan {sched.algorithm}/{sched.collective} "
                            f"[{hw.reconfig_mode}]: {v}")
    for v in check_mode_monotonicity(g0, std, S.rhd_reduce_scatter(n, _D), H100_DGX):
        failures.append(f"monotonicity: {v}")
    ok &= _section(f"plan accounting ({len(plan_cases)} plans + modes)", failures, t0)

    t0 = time.perf_counter()
    failures = []
    tp_groups, dp_groups = S.mesh_groups(4, 2)
    s_tp = S.replicate_groups(S.ring_all_reduce(4, _D), tp_groups, n)
    s_dp = S.replicate_groups(S.ring_all_reduce(2, _D), dp_groups, n)
    cp = P.plan_concurrent(g0, std, [s_tp, s_dp], H100_DGX)
    for v in check_concurrent_plan(cp, g0, std):
        failures.append(f"concurrent: {v}")
    ok &= _section("concurrent accounting (1 joint plan)", failures, t0)

    print(f"[verify] {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--quick", action="store_true",
                    help="skip the n=16 realizability cases")
    ap.add_argument("--kernels", action="store_true",
                    help="the kernel lint over the port's CUDA and Triton launches")
    args = ap.parse_args(argv)
    if args.kernels:
        return run_kernels()
    return run(quick=args.quick)


if __name__ == "__main__":
    sys.exit(main())
