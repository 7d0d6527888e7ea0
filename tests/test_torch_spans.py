"""The program's spans on the collective path (``repro_torch.spans``), on the
CPU at the benchmark cells' tiny sizes (``pcclbench/conftest.py::TINY``):
the span tree of each collective kind and fused seam, the rounds and their
bytes against the compiled tables, results with tracing on and off,
sessions, and the bound on a session's record."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import PcclSession, spans  # noqa: E402
from repro_torch.api.backends import _eager_nbytes  # noqa: E402
from repro_torch.comm import fusion  # noqa: E402
from repro_torch.comm.exec_engine import compile_schedule  # noqa: E402
from repro_torch.core import cost_model as cm  # noqa: E402

N = 8
COLS, ROWS = 64, 2**20 // (2 * 64)  # the bucket mix's 1 MiB bf16 operand a rank
T, D, K = 64, 256, 1024 // N        # the layer cell's tokens, hidden and columns a rank
KINDS = ["all_reduce", "reduce_scatter", "all_gather", "all_to_all", "all_reduce_ef8",
         "mm_rs", "ar_rmsnorm"]


@pytest.fixture(scope="module")
def case():
    """Each kind's (call, communicator, the collective it plans, an operand
    of the shape it plans for, one chunk's bytes by hand)."""
    sess = PcclSession(cm.H100_DGX, device="cpu")
    comm = sess.communicator("x", N)
    ring = sess.communicator("x", N, algorithm="ring")
    ef8 = sess.communicator("x", N, algorithm="ring_ef8", rel_error_tol=(N - 1) / 127)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((N, ROWS, COLS), generator=g).to(torch.bfloat16)
    shard = torch.randn((N, ROWS // N, COLS), generator=g).to(torch.bfloat16)
    xa = torch.randn((N, T, D), generator=g).to(torch.bfloat16)
    xm = torch.randn((N, T, K), generator=g).to(torch.bfloat16)
    w = (torch.randn((K, D), generator=g) * K ** -0.5).to(torch.bfloat16)
    gamma = torch.randn((D,), generator=g) * 0.1 + 1.0
    buf = ROWS * COLS * 2  # one rank's operand
    return {
        "all_reduce": (lambda: comm.all_reduce(x), comm, "all_reduce", x, buf // N),
        "reduce_scatter": (lambda: comm.reduce_scatter(x), comm, "reduce_scatter", x, buf // N),
        "all_gather": (lambda: comm.all_gather(shard), comm, "all_gather", shard, buf // N),
        "all_to_all": (lambda: comm.all_to_all(x), comm, "all_to_all", x, buf // N),
        "all_reduce_ef8": (lambda: ef8.all_reduce(x), ef8, "all_reduce", x, buf // N),
        "mm_rs": (lambda: fusion.fused_matmul_reduce_scatter(ring, xm, w), ring,
                  "reduce_scatter", torch.empty((N, T, D), dtype=torch.bfloat16), T * D * 2 // N),
        "ar_rmsnorm": (lambda: fusion.fused_all_reduce_rmsnorm(comm, xa, gamma), comm,
                       "all_reduce", xa, T * D * 2 // N),
    }


def traced(call):
    with spans.tracing():
        out = call()
    return out, spans.records()


def tables(comm, collective, operand):
    """The compiled tables of the schedule the call plans for."""
    nbytes = _eager_nbytes(comm, collective, tuple(operand.shape[1:]), operand.element_size())
    return compile_schedule(comm.axis_schedule(collective, nbytes))


@pytest.mark.parametrize("kind", KINDS)
def test_each_kind_gives_its_span_tree(case, kind):
    _, recs = traced(case[kind][0])
    top = [i for i, s in enumerate(recs) if s.parent is None]
    assert top == [0] and recs[0].name == "collective"
    op = {"all_reduce_ef8": "all_reduce"}.get(kind, kind)
    assert recs[0].attrs["op"] == op and recs[0].attrs["n"] == N
    children = recs[1:]
    assert all(s.parent == 0 and s.root == 0 for s in children)  # plans, rounds, tiles are leaves
    assert all(s.end_ns >= s.start_ns >= recs[0].start_ns for s in children)
    assert all(s.end_ns <= recs[0].end_ns for s in children)
    want = {"plan", "round", "tile"} if kind == "mm_rs" else {"plan", "round"}
    assert {s.name for s in children} == want
    if kind == "mm_rs":
        steps = [(s.name, s.attrs.get("step", s.attrs.get("index"))) for s in children
                 if s.name != "plan"]
        assert steps == [("tile", 0)] + [p for s in range(1, N) for p in
                                         (("tile", s), ("round", s - 1))]
    if kind == "all_reduce_ef8":
        assert {s.attrs.get("wire") for s in children if s.name == "round"} == {"int8"}
    assert all(s.device_start_ns is None for s in recs)  # no CUDA events on the CPU


@pytest.mark.parametrize("kind", KINDS)
def test_rounds_and_bytes_match_the_tables(case, kind):
    call, comm, collective, operand, chunk = case[kind]
    _, recs = traced(call)
    rounds = [s for s in recs if s.name == "round"]
    compiled = tables(comm, collective, operand)
    assert recs[0].attrs["algorithm"] == compiled.algorithm
    assert len(rounds) == compiled.num_rounds
    assert [s.attrs["index"] for s in rounds] == list(range(compiled.num_rounds))
    # each round's gather reads every rank's k chunks: send_ids is (rounds, n, k)
    assert sum(s.attrs["bytes"] for s in rounds) == sum(
        g.send_ids.size for g in compiled.groups) * chunk


@pytest.mark.parametrize("kind", KINDS)
def test_results_are_the_same_with_tracing_on_and_off(case, kind):
    call = case[kind][0]
    on, recs = traced(call)
    assert recs
    off = call()
    assert on.dtype == off.dtype and torch.equal(on, off)


def test_tracing_off_records_nothing(case):
    with spans.tracing():
        pass
    assert spans.records() == []
    assert not spans.enabled()
    for kind in KINDS:
        case[kind][0]()
    assert spans.records() == [] and spans.dropped() == 0


def test_a_new_session_drops_the_old_record(case):
    _, first = traced(case["all_reduce"][0])
    _, second = traced(case["all_gather"][0])
    assert first and [s.attrs["op"] for s in second if s.parent is None] == ["all_gather"]
    # under the profiler: a session ends when its record is read with tracing off
    for kind in ("reduce_scatter", "ar_rmsnorm"):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            assert spans.enabled()
            case[kind][0]()
        assert [s.attrs["op"] for s in spans.records() if s.parent is None] == [kind]


def test_the_bound_counts_dropped_spans(case, monkeypatch):
    call = case["all_reduce"][0]
    _, whole = traced(call)
    monkeypatch.setattr(spans, "LIMIT", 5)
    _, kept = traced(call)
    assert [s.name for s in kept] == [s.name for s in whole[:5]]
    assert spans.dropped() == len(whole) - 5
    traced(call)  # a new session counts afresh
    assert spans.dropped() == len(whole) - 5
