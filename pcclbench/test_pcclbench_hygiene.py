"""What a run may load, and the shape of ``BENCHMARK.json``."""

import json
import re
import subprocess
import sys

import pytest

from pcclbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

LOADED = """
import sys, time, torch
sys.path[:0] = [{root!r}, {src!r}]
from pcclbench import harness
sys.argv = ["run.py"]
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def top_level_modules(body: str) -> set:
    code = LOADED.format(root=str(ROOT), src=str(ROOT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_reference_package():
    # a whole run of a tiny cell on the CPU, the program included
    body = """
import io, contextlib
from pcclbench.conftest import TINY
with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
    harness.run(["--workload", "mistral123b-tp8.colls", "--seed", "3", "--seconds", "0.1"],
                t0=time.time(), device=torch.device("cpu"), override=TINY["mistral123b-tp8.colls"])
"""
    mods = top_level_modules(body)
    assert "repro_torch" in mods  # the program ran
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_the_references_load_nothing_of_the_program():
    body = "\n".join(
        f"harness.load(harness.ROOT / {c['file'][:-5] + '.py'!r}, 'ref{i}')"
        for i, c in enumerate(BENCH["configs"])) + "\nfrom pcclbench import check, arith"
    mods = top_level_modules(body)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden(["repro_torch", "repro_torch.api", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden(["repro.sub", "jax", "jaxlib.xla", "flax", "torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_entries_name_their_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (ROOT / "pcclbench" / "metrics" / f"{m['name']}.py").is_file()
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and (ROOT / c["file"]).with_suffix(".py").is_file()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        assert (ROOT / "pcclbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "pcclbench" / "limits" / f"{w['name']}.json").is_file()
        per_layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert per_layer and any(w["name"] in m.get("workloads", [w["name"]])
                                 for m in BENCH["end_to_end"] if m["name"] != "setup_s")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_keeps_its_published_widths(name):
    conf = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = json.loads((ROOT / conf["file"]).read_text())
    for key in conf["reduced"]:
        assert key in cfg["published"] and not key.endswith(("_size", "_dim", "_rank"))
