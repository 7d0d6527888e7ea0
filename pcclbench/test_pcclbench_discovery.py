"""A cell, a traffic mix and a metric are added by adding files and
entries: in a copy of the benchmark, a new mix of an existing runner and a
new metric reader run with no existing file edited."""

import hashlib
import json
import shutil
import time

import torch

from pcclbench import harness


def digest(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_traffic_and_metric_are_found_by_name(tmp_path, capsys, in_process):
    src = harness.ROOT
    shutil.copytree(src / "pcclbench", tmp_path / "pcclbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    (tmp_path / "src").symlink_to(src / "src")
    before = digest(tmp_path / "pcclbench")

    bench = json.loads((src / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "mistral123b-tp8.small_buckets",
                               "config": "mistral-large-123b-tp8", "traffic": "small_buckets",
                               "chips": 1, "why": "a mix added as data"})
    bench["per_layer"].append({"name": "calls_per_s", "unit": "1/s", "better": "higher",
                               "source": "host_clock", "layer": "API", "moves": "coll_GBps",
                               "workloads": ["mistral123b-tp8.small_buckets"]})
    coll = next(m for m in bench["end_to_end"] if m["name"] == "coll_GBps")
    coll["workloads"].append("mistral123b-tp8.small_buckets")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    folder = tmp_path / "pcclbench"
    (folder / "traffic" / "small_buckets.json").write_text(json.dumps(
        {"runner": "collective_mix", "dtype": "bfloat16", "columns": 64, "buffer_mib": [1],
         "operand_sets": 2, "kinds": ["all_reduce", "all_gather"]}))
    (folder / "limits" / "mistral123b-tp8.small_buckets.json").write_text(
        json.dumps({"all_reduce.row_err": 0.016, "all_gather.max_diff": 0.0}))
    (folder / "metrics" / "calls_per_s.py").write_text(
        "def read(r):\n    return r.work['calls'] / r.window_s\n")

    for trace in (0, 1):
        rc = harness.run(["--workload", "mistral123b-tp8.small_buckets", "--seed", "9",
                          "--seconds", "0.1", "--trace", str(trace)],
                         t0=time.time(), root=tmp_path, device=torch.device("cpu"))
        assert rc == 0
        r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert r["correct"] is True
        assert set(r["checks"]) == {"all_reduce.row_err", "all_gather.max_diff"}
        assert ("calls_per_s" if trace else "coll_GBps") in r["metrics"]

    after = digest(folder)
    assert {k: v for k, v in after.items() if k in before} == before
