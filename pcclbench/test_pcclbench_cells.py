"""Each cell driven end to end on the CPU at a tiny size, the card's look
skipped: its entry held against the frozen reference, its control seen to
fail, and each fault the cell can have seen to make ``correct`` false."""

import json
import time

import pytest
import torch

from pcclbench import harness

CELLS = ["mistral123b-tp8.layer", "mistral123b-tp8.colls"]
SEED = 2**31 + 11  # above 32 signed bits: seeds may be that large


def run_cell(capsys, tiny, workload, trace=0, seed=SEED):
    rc = harness.run(["--workload", workload, "--seed", str(seed), "--seconds", "0.2",
                      "--trace", str(trace)], t0=time.time(), device=torch.device("cpu"),
                     override=tiny[workload])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("workload", CELLS)
def test_cell_matches_the_reference(capsys, tiny, in_process, workload):
    r = run_cell(capsys, tiny, workload)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == {"coll_GBps", "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"  # the compared numbers come last


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_layers(capsys, tiny, in_process, workload):
    r = run_cell(capsys, tiny, workload, trace=1)
    assert r["correct"] is True
    assert {"busy_s", "window_s"} <= set(r["device"])
    # the host's spans and clock; the device's metrics need the card
    assert "api_host_ms.coll" in r["metrics"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(tiny, in_process, workload):
    _, _, _, runner = harness.make_cell(harness.ROOT, workload, SEED, torch.device("cpu"), False,
                                        tiny[workload])
    runner.inputs()
    checks = harness.judge(runner.numbers(runner.control()), runner.cell.limits)
    assert not all(c.ok for c in checks), checks


def _no_exchange(monkeypatch):
    from repro_torch.comm import exec_engine

    monkeypatch.setattr(exec_engine, "apply_round", lambda *a, **k: None)


def _half_the_ranks(monkeypatch):
    """The all-reduce sums the first half of the ranks and doubles it."""
    from repro_torch.comm import primitives

    orig = primitives.all_reduce

    def half(x, schedule, group=None):
        kept = x.clone()
        kept[x.shape[0] // 2:] = 0
        return orig(kept, schedule, group) * 2

    monkeypatch.setattr(primitives, "all_reduce", half)


def _one_row_altered(monkeypatch):
    """The all-gather's result has one token's row negated where it is made."""
    from repro_torch.api.communicator import Communicator

    orig = Communicator.all_gather

    def altered(self, x):
        out = orig(self, x)
        out[1, 3] = -out[1, 3]
        return out

    monkeypatch.setattr(Communicator, "all_gather", altered)


# Each fault a cell can have: the collective cells keep no state between
# steps, so a step that hands its state back unchanged has no place here.
FAULTS = {"exchange_left_out": _no_exchange, "half_the_ranks": _half_the_ranks,
          "answer_altered": _one_row_altered}
CASES = [(w, f) for w in CELLS for f in FAULTS]


@pytest.mark.parametrize("workload, fault", CASES)
def test_fault_makes_the_run_incorrect(capsys, monkeypatch, tiny, in_process, workload, fault):
    FAULTS[fault](monkeypatch)
    r = run_cell(capsys, tiny, workload)
    assert r["correct"] is False, r["checks"]


def _replayed(monkeypatch):
    """The all-gather hands back the first result it made for each shape,
    as a cache of results that ignores the operand would."""
    from repro_torch.api.communicator import Communicator

    orig, seen = Communicator.all_gather, {}

    def replay(self, x):
        return seen.setdefault(tuple(x.shape), orig(self, x))

    monkeypatch.setattr(Communicator, "all_gather", replay)


@pytest.mark.parametrize("workload", CELLS)
def test_steps_take_the_operand_sets_in_turn(tiny, in_process, workload):
    _, _, _, runner = harness.make_cell(harness.ROOT, workload, SEED, torch.device("cpu"), False,
                                        tiny[workload])
    runner.setup()  # the warm-up's steps run on the first sets
    used = []
    for _ in range(runner.sets + 1):
        runner.step()
        used.append(runner.cur)
    assert used == [(2 + i) % runner.sets for i in range(runner.sets + 1)]
    drawn = runner.xs
    assert all(not torch.equal(next(iter(a.values())) if isinstance(a, dict) else a,
                               next(iter(b.values())) if isinstance(b, dict) else b)
               for i, a in enumerate(drawn) for b in drawn[i + 1:])
    checks = harness.judge(runner.numbers(runner.answers()), runner.cell.limits)
    assert all(c.ok for c in checks), checks


@pytest.mark.parametrize("workload", CELLS)
def test_a_replayed_answer_is_not_correct(monkeypatch, tiny, in_process, workload):
    _replayed(monkeypatch)
    _, _, _, runner = harness.make_cell(harness.ROOT, workload, SEED, torch.device("cpu"), False,
                                        tiny[workload])
    runner.setup()
    runner.step()  # a set the first warm-up step did not run on
    checks = harness.judge(runner.numbers(runner.answers()), runner.cell.limits)
    assert not all(c.ok for c in checks), checks
