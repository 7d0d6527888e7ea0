"""The benchmark's own command: on the card every cell for a second
(marked ``cuda``), and without a card no result at all."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from pcclbench import harness

ROOT = harness.ROOT
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def command(workload, cwd):
    return subprocess.run([sys.executable, "pcclbench/run.py", "--workload", workload,
                           "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_on_the_card(card, workload):
    out = command(workload, ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu", r


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = command(CELLS[0], ROOT)
    assert out.returncode != 0 and not out.stdout.strip()


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """Without the program beside it (only ``BENCHMARK.json`` and the
    benchmark's folder), a run ends without a result line."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pcclbench", tmp_path / "pcclbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = command(CELLS[0], tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()
