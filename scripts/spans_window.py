"""One benchmark cell's window with the program's spans on and the profiler
off: how much the profiler adds to a call's host time.

    python scripts/spans_window.py --workload mistral123b-tp8.layer --seed 7 --seconds 10

from the root of a checkout, on a card.  It sets the cell up as
``pcclbench/run.py`` does, runs whole steps for ``--seconds`` inside
``repro_torch.spans.tracing()`` (no ``torch.profiler``), and prints one JSON
line: the window's steps and collective GB/s, the readings of
``api_host_ms.coll`` (the benchmark's own host spans around each call) and
of the four metrics that read the program's spans, and under ``by_op`` the
spans of each kind of top-level call: its host µs, its ``plan`` spans' µs,
a round's host and device µs (means), and the lead of its first and last
``round`` or ``tile`` span (ms, means).
"""

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("coll_GBps", "api_host_ms.coll", "plan_us.coll", "enqueue_us.round",
           "round_GBps.coll", "lead_ms.mm_rs")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    t0 = time.time()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from pcclbench import harness
    from repro_torch import spans

    device = torch.device("cuda", 0)
    _, _, cell, runner = harness.make_cell(ROOT, args.workload, args.seed, device, False)
    runner.setup()
    harness.sync(device)
    setup_s = time.time() - t0
    cell.spans.call_s.clear()
    work, steps = defaultdict(float), 0
    with spans.tracing():
        start = time.perf_counter()
        while True:
            for k, v in runner.step().items():
                work[k] += v
            harness.sync(device)
            steps += 1
            if time.perf_counter() - start >= args.seconds:
                break
        window_s = time.perf_counter() - start
    reading = harness.Reading(setup_s, window_s, dict(work), dict(cell.spans.call_s))
    runner.release()
    out = {"workload": args.workload, "seed": args.seed, "steps": steps, "window_s": window_s,
           "device": harness.nvidia_smi()}
    for name in METRICS:
        reader = harness.load(ROOT / "pcclbench" / "metrics" / f"{name}.py", f"metric_{name}")
        out[name] = reader.read(reading)
    out["by_op"] = by_op(spans.records())
    print(json.dumps(out), flush=True)
    return 0


def by_op(recs) -> dict:
    """Per kind of top-level ``collective`` span, the means of its calls."""
    mean = statistics.fmean
    calls = defaultdict(list)
    for i, s in enumerate(recs):
        if s.name == "collective" and s.parent is None:
            calls[(s.attrs["op"], s.attrs.get("algorithm"))].append(i)
    inside = defaultdict(list)
    for s in recs:
        if s.parent is not None:
            inside[s.root].append(s)
    out = {}
    for (op, alg), tops in calls.items():
        plans, rounds, first, last = [], [], [], []
        for i in tops:
            kids = inside[i]
            plans.append(sum(s.end_ns - s.start_ns for s in kids if s.name == "plan") / 1e3)
            rounds += [s for s in kids if s.name == "round"]
            leaves = [s for s in kids if s.name in ("round", "tile")
                      and s.device_start_ns is not None]
            if leaves:
                first.append((leaves[0].device_start_ns - leaves[0].start_ns) / 1e6)
                last.append((leaves[-1].device_start_ns - leaves[-1].start_ns) / 1e6)
        timed = [s for s in rounds if s.device_start_ns is not None]
        out[f"{op}/{alg}"] = {
            "calls": len(tops),
            "call_us": mean((recs[i].end_ns - recs[i].start_ns) / 1e3 for i in tops),
            "plan_us": mean(plans),
            "round_us": mean((s.end_ns - s.start_ns) / 1e3 for s in rounds) if rounds else None,
            "round_device_us": mean((s.device_end_ns - s.device_start_ns) / 1e3
                                    for s in timed) if timed else None,
            "lead_first_ms": mean(first) if first else None,
            "lead_last_ms": mean(last) if last else None,
        }
    return out


if __name__ == "__main__":
    sys.exit(main())
