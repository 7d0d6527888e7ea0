"""The dry run's cells against the reference's own records.

The reference's roofline (``python -m repro.launch.roofline``: per-rank
FLOPs and collective bytes, two unrolled depths extrapolated) and dry run
(``python -m repro.launch.dryrun --mesh single``: XLA's
``memory_analysis``) write one JSON record per cell under ``results/`` of
the tree they run in.  ``collect`` reads those records into one file of
per-rank numbers per live single-pod cell (the oracle the port's tests and
``PERF.md`` hold the port to); ``compare`` reads the port's records
(``python -m repro_torch.launch.dryrun --mesh single --out DIR``) and
prints, per cell, FLOPs a rank, all-gather bytes, temporaries and
fallbacks, each with its ratio to the reference's.  Nothing here runs
either package's count: it reads their files.

Usage:
  python -m repro_torch.launch.reference_table collect --roofline DIR --dryrun DIR \\
      --out tests/data/reference_single_pod.json
  python -m repro_torch.launch.reference_table compare --port DIR [--port DIR2 ...] \\
      [--reference tests/data/reference_single_pod.json] [--json OUT] [--pair]
"""

from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List

ROOT = pathlib.Path(__file__).resolve().parents[3]
REFERENCE = ROOT / "tests" / "data" / "reference_single_pod.json"
MEMORY_FIELDS = ("argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
                 "alias_size_in_bytes")


def collect(roofline_dir: pathlib.Path, dryrun_dir: pathlib.Path) -> Dict[str, Dict]:
    """``{"<arch>__<shape>": record}`` of every cell both runs counted: the
    roofline's FLOPs and collective bytes by op a rank (its totals over the
    chips divided by them), and the dry run's memory fields a rank."""
    out = {}
    for path in sorted(pathlib.Path(roofline_dir).glob("*.json")):
        roof = json.loads(path.read_text())
        if roof.get("status") != "ok":
            continue
        key = f"{roof['arch']}__{roof['shape']}"
        mem_path = pathlib.Path(dryrun_dir) / f"{key}__single.json"
        if not mem_path.exists():
            continue
        mem = json.loads(mem_path.read_text())
        if mem.get("status") != "ok":
            continue
        chips = roof["chips"]
        out[key] = {
            "arch": roof["arch"], "shape": roof["shape"], "chips": chips,
            "flops": roof["roofline"]["flops"] / chips,
            "hbm_bytes": roof["roofline"]["hbm_bytes"] / chips,
            "bytes_by_op": roof["collective_bytes_by_op"],
            "model_flops": roof["model_flops"],
            **{k: mem["memory"][k] for k in MEMORY_FIELDS},
        }
    return out


def rows(port: Dict[str, Dict], reference: Dict[str, Dict]) -> List[Dict]:
    """Per cell of ``port`` (the port's records by ``<arch>__<shape>``): its
    numbers and their ratios to the reference's."""
    out = []
    for key in sorted(reference):
        rec = port.get(key)
        ref = reference[key]
        row = {"cell": key}
        if rec is None:
            row["status"] = "not counted"
        elif rec.get("status") != "ok":
            row["status"] = rec.get("status")
            row["error"] = rec.get("error", "")[:200]
        else:
            mem = rec["memory_per_rank"]
            gathered = rec["collectives"]["bytes_by_op"].get("all-gather", 0.0)
            peak = mem.get("peak_by_op", {})
            row.update(status="ok", flops=rec["per_rank"]["flops"], all_gather=gathered,
                       peak_op=next(iter(peak), None),
                       temp=mem["temp_size_in_bytes"], arguments=mem["argument_size_in_bytes"],
                       fallbacks=rec["fallbacks"]["count"],
                       speedup=rec["pccl_pricing"]["speedup"],
                       flops_ratio=rec["per_rank"]["flops"] / ref["flops"],
                       all_gather_ratio=(gathered / ref["bytes_by_op"]["all-gather"]
                                         if ref["bytes_by_op"].get("all-gather") else None),
                       temp_ratio=mem["temp_size_in_bytes"] / ref["temp_size_in_bytes"],
                       arguments_ratio=(mem["argument_size_in_bytes"]
                                        / ref["argument_size_in_bytes"]))
        out.append(row)
    return out


def _load_port(directory: pathlib.Path) -> Dict[str, Dict]:
    out = {}
    for path in pathlib.Path(directory).glob("*__single.json"):
        rec = json.loads(path.read_text())
        out[f"{rec['arch']}__{rec['shape']}"] = rec
    return out


def _fmt(x, ratio: bool = False) -> str:
    if x is None:
        return "—"
    return f"{x:.3f}" if ratio else f"{x:.4g}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("collect")
    c.add_argument("--roofline", required=True)
    c.add_argument("--dryrun", required=True)
    c.add_argument("--out", default=str(REFERENCE))
    m = sub.add_parser("compare")
    m.add_argument("--port", action="append", required=True,
                   help="a directory of the port's records (several: one column set each)")
    m.add_argument("--reference", default=str(REFERENCE))
    m.add_argument("--json", default=None, help="write the rows here too")
    m.add_argument("--pair", action="store_true",
                   help="one table of two directories side by side (first / second)")
    args = ap.parse_args(argv)
    if args.cmd == "collect":
        rec = collect(pathlib.Path(args.roofline), pathlib.Path(args.dryrun))
        pathlib.Path(args.out).write_text(json.dumps(rec, indent=1, sort_keys=True) + "\n")
        print(f"{len(rec)} cells -> {args.out}")
        return 0
    reference = json.loads(pathlib.Path(args.reference).read_text())
    tables = {d: rows(_load_port(pathlib.Path(d)), reference) for d in args.port}
    if args.pair:
        first, second = (tables[d] for d in args.port[:2])
        print(f"| cell | FLOPs a rank ÷ ref | all-gather B ÷ ref | temp B ÷ ref | PCCL speedup | "
              f"fallbacks | op holding the peak |   ({args.port[0]} / {args.port[1]})")
        print("|---|---|---|---|---|---|---|")
        for a, b in zip(first, second):
            if a["status"] != "ok" or b["status"] != "ok":
                print(f"| {a['cell']} | {a['status']} / {b['status']} | | | | | |")
                continue
            pair = lambda k: f"{_fmt(a[k], True)} / {_fmt(b[k], True)}"  # noqa: E731
            print(f"| {a['cell']} | {_fmt(a['flops'])}: {pair('flops_ratio')} | "
                  f"{pair('all_gather_ratio')} | {pair('temp_ratio')} | "
                  f"{a['speedup']:.4f} / {b['speedup']:.4f} | "
                  f"{a['fallbacks']} / {b['fallbacks']} | {a['peak_op']} |")
        return 0
    for d, table in tables.items():
        print(f"## {d}")
        print("| cell | FLOPs a rank (÷ ref) | all-gather B (÷ ref) | temp B (÷ ref) | "
              "fallbacks | PCCL speedup |")
        print("|---|---|---|---|---|---|")
        for r in table:
            if r["status"] != "ok":
                print(f"| {r['cell']} | {r['status']} {r.get('error', '')} | | | | |")
                continue
            print(f"| {r['cell']} | {_fmt(r['flops'])} ({_fmt(r['flops_ratio'], True)}) | "
                  f"{_fmt(r['all_gather'])} ({_fmt(r['all_gather_ratio'], True)}) | "
                  f"{_fmt(r['temp'])} ({_fmt(r['temp_ratio'], True)}) | {r['fallbacks']} | "
                  f"{r['speedup']:.4f} |")
    if args.json:
        pathlib.Path(args.json).write_text(json.dumps(tables, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
