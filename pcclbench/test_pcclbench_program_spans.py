"""The program's spans as the benchmark reads them: a traced tiny run of
each cell reports the host metrics its spans give and opens one top-level
``collective`` span a call of its window, two traced runs in one process
each read their own spans, and an untraced run records none."""

import pytest

from pcclbench.test_pcclbench_cells import CELLS, run_cell


def top_level_ops():
    from repro_torch import spans

    return [s.attrs["op"] for s in spans.records() if s.name == "collective" and s.parent is None]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_the_program_spans(capsys, tiny, in_process, workload):
    r = run_cell(capsys, tiny, workload, trace=1)
    assert r["correct"] is True
    assert {"plan_us.coll", "enqueue_us.round"} <= set(r["metrics"])
    # the device's own event times need the card
    assert not {"round_GBps.coll", "lead_ms.mm_rs"} & set(r["metrics"])
    assert len(top_level_ops()) == r["attempted"]


def test_two_traced_runs_read_their_own_spans(capsys, tiny, in_process):
    layer = run_cell(capsys, tiny, "mistral123b-tp8.layer", trace=1)
    assert len(top_level_ops()) == layer["attempted"]
    assert set(top_level_ops()) == {"ar_rmsnorm", "mm_rs", "all_gather"}
    colls = run_cell(capsys, tiny, "mistral123b-tp8.colls", trace=1)
    ops = top_level_ops()
    assert len(ops) == colls["attempted"] and set(ops) == {
        "all_reduce", "reduce_scatter", "all_gather", "all_to_all"}


def test_an_untraced_run_records_nothing(capsys, tiny, in_process):
    from repro_torch import spans

    with spans.tracing():
        pass
    r = run_cell(capsys, tiny, "mistral123b-tp8.layer", trace=0)
    assert r["attempted"] > 0 and spans.records() == []
