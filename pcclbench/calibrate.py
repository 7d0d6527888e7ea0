"""The readings a cell's correctness limits are set from, on the chip.

    python3 pcclbench/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 101,102,103 [--out readings.jsonl]

For each seed of ``--seeds`` the program's set-up and one step of the timed
path, at the cell's own sizes, then the numbers ``correct`` compares: the
lower readings.  For each of ``--control-seeds`` the control, the plain
reference computed in float8 (e4m3) in the program's place, held to the
same numbers: the upper readings.  One JSON line per seed and side, and
last each number's largest program reading and smallest control reading.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])


def readings(workload: str, seed: int, side: str, device) -> dict:
    import torch

    from pcclbench.harness import make_cell

    _, _, _, runner = make_cell(Path(__file__).resolve().parents[1], workload, seed, device, False)
    t = time.perf_counter()
    if side == "program":
        runner.setup()
        runner.step()
        found = {"program": runner.answers()}
        runner.release()
    else:
        runner.inputs()
        found = {"control": runner.control()}
    out = []
    for name, answers in found.items():
        out.append({"seed": seed, "side": name, "seconds": time.perf_counter() - t,
                    "checks": runner.numbers(answers)})
    del found, runner
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import os

    os.environ["TRITON_CACHE_DIR"] = str(Path(__file__).resolve().parent / ".cache" / "triton")
    import torch

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    rows = []
    for side, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for s in filter(None, seeds.split(",")):
            for row in readings(args.workload, int(s), side, device):
                rows.append(row)
                print(json.dumps(row), flush=True)
    summary = {}
    for name in rows[0]["checks"]:
        summary[name] = {}
        for side in dict.fromkeys(r["side"] for r in rows):
            got = [r["checks"][name] for r in rows if r["side"] == side]
            summary[name][side] = {"max" if side == "program" else "min":
                                   max(got) if side == "program" else min(got), "all": got}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
