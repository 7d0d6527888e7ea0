"""One run of one benchmark cell, from ``BENCHMARK.json`` and the files
that its names point at.

A cell names a configuration (``configs/<name>.json``, its sizes, and
``configs/<name>.py``, its plain reference) and a traffic mix
(``traffic/<name>.json``), whose ``runner`` key names the general code
that runs it (``runners/<runner>.py``).  Each metric is read by
``metrics/<name>.py``.  A new cell, configuration, mix or metric is a new
file and a new entry: nothing here names one.

A run: set-up (inputs from the seed, the program built and every shape
warmed up), then whole steps back to back for ``--seconds`` (the window;
with ``--trace 1`` under ``torch.profiler``), then the check of what the
window produced against the plain reference, and one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

from pcclbench.check import Check

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(path: Path, name: str):
    """Import the module in ``path`` under ``name`` (file names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Spans:
    """The benchmark's spans around each call into the program: the host
    seconds of each call, and with ``traced`` a ``record_function`` label
    that the trace reduction reads."""

    def __init__(self, traced: bool) -> None:
        self.traced = traced
        self.call_s: Dict[str, List[float]] = defaultdict(list)

    def _label(self, label: str):
        if not self.traced:
            return nullcontext()
        from torch.profiler import record_function

        from pcclbench.profiled import PREFIX

        return record_function(PREFIX + label)

    @contextmanager
    def call(self, label: str):
        """A call into the program: timed on the host, labelled in the trace."""
        t = time.perf_counter()
        with self._label(label):
            yield
        self.call_s[label].append(time.perf_counter() - t)

    def mark(self, label: str):
        """A span of the benchmark's own (the window, a wait): labelled only."""
        return self._label(label)


@dataclass
class Cell:
    """What a runner is given."""

    cfg: dict
    traffic: dict
    ref: object           # the configuration's plain reference module
    seed: int
    device: object
    spans: Spans
    limits: Dict[str, float]


@dataclass
class Reading:
    """What a metric reader reads: times, the work the runner counted over
    the window, host seconds of each call, and the trace's summary."""

    setup_s: float
    window_s: float
    work: Dict[str, float]
    call_s: Dict[str, List[float]]
    trace: Optional[object] = None


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def warm_up(step, device, times: int = 2) -> None:
    """Run ``step`` ``times`` over, each to its end, and log each one's
    seconds: the first builds kernels, plans and tables; a second that
    takes as long would show that something still builds."""
    for i in range(times):
        t = time.perf_counter()
        step()
        sync(device)
        log(f"warm-up {i + 1}: {time.perf_counter() - t:.3f} s")


def cell_entries(bench: dict, workload: str):
    """The cell's workload entry and its configuration entry."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return wl, conf


def metrics_of(bench: dict, workload: str, traced: bool) -> list:
    """The cell's metrics: per-layer ones when traced, else end-to-end."""
    group = bench["per_layer" if traced else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def make_cell(root: Path, workload: str, seed: int, device, traced: bool,
              override: Optional[dict] = None) -> tuple:
    """The cell's entries, its files read by name, and its runner.
    ``override`` replaces keys of the configuration, the traffic mix and
    the limits (the CPU tests run a cell at a tiny size)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl, conf = cell_entries(bench, workload)
    cfg = json.loads((root / conf["file"]).read_text())
    folder = root / HERE.name
    traffic = json.loads((folder / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((folder / "limits" / f"{workload}.json").read_text())
    override = override or {}
    cfg.update(override.get("cfg", {}))
    traffic.update(override.get("traffic", {}))
    limits.update(override.get("limits", {}))
    ref = load((root / conf["file"]).with_suffix(".py"), f"pcclbench_ref_{conf['name']}")
    cell = Cell(cfg, traffic, ref, seed % 2**63, device, Spans(traced), limits)
    runner = load(folder / "runners" / f"{traffic['runner']}.py",
                  f"pcclbench_runner_{traffic['runner']}").Runner(cell)
    return bench, wl, cell, runner


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> list:
    """Each number that has a limit, held to it; one without a limit is
    read and not compared (it is logged, before the compared ones)."""
    for name in numbers.keys() - limits.keys():
        log(f"reading {name}: {numbers[name]!r} (not compared)")
    return [Check(name, value, limits[name]) for name, value in numbers.items() if name in limits]


def forbidden(modules) -> list:
    """The top-level names among ``modules`` that are JAX's or the
    reference package's, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def nvidia_smi() -> str:
    try:
        proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi: {exc}"
    return proc.stdout.strip().splitlines()[0] if proc.stdout.strip() else proc.stderr.strip()


def run(argv, *, t0: float, root: Path = ROOT, device=None, override: Optional[dict] = None) -> int:
    """One run; returns the exit code.  ``device`` None looks for the card
    the cell asks for and refuses to run without it; the CPU tests pass a
    device and an ``override`` to drive the rest of a run at a tiny size."""
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = str(HERE / ".cache" / "triton")
    import torch

    log(f"torch imported at {time.time() - t0:.3f} s")

    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl, _ = cell_entries(bench, args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            log(f"{args.workload} needs {wl['chips']} CUDA device(s); "
                f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)
    traced = bool(args.trace)
    bench, wl, cell, runner = make_cell(root, args.workload, args.seed, device, traced, override)
    cuda = device.type == "cuda"
    if cuda:
        log(f"device: {nvidia_smi()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    runner.setup()
    sync(device)
    setup_s = time.time() - t0
    log(f"set-up {setup_s:.3f} s")

    work: Dict[str, float] = defaultdict(float)
    steps, prof = 0, None
    spans = cell.spans
    spans.call_s.clear()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    with prof if prof is not None else nullcontext():
        with spans.mark("window"):
            start = time.perf_counter()
            while True:
                for k, v in runner.step().items():
                    work[k] += v
                with spans.mark("sync"):
                    sync(device)
                steps += 1
                if time.perf_counter() - start >= args.seconds:
                    break
            window_s = time.perf_counter() - start
    log(f"window {window_s:.3f} s, {steps} steps")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": wl["chips"], "memory_peak_bytes": int(peak)}
    reading = Reading(setup_s, window_s, dict(work), dict(spans.call_s))
    if prof is not None:
        from pcclbench.profiled import summarize

        t = time.perf_counter()
        reading.trace = summarize(prof)
        dev["busy_s"] = reading.trace.busy_s
        dev["window_s"] = reading.trace.window_s
        log(f"trace reduced in {time.perf_counter() - t:.1f} s")
        del prof

    answers = runner.answers()
    runner.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge(runner.numbers(answers), cell.limits)
    del answers
    correct = all(c.ok for c in checks)

    metrics = {}
    for m in metrics_of(bench, args.workload, traced):
        reader = load(root / HERE.name / "metrics" / f"{m['name']}.py",
                      f"pcclbench_metric_{m['name']}")
        value = reader.read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": int(work.get("calls", steps)),
              "failed": int(work.get("failed", 0)), "metrics": metrics, "device": dev}
    if reading.trace is not None:
        from pcclbench.profiled import breakdown

        result["breakdown"] = breakdown(reading.trace)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}

    found = forbidden(sys.modules)
    if found:
        log(f"the process holds modules it must not load: {', '.join(found)}")
        return 3
    for c in checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0
