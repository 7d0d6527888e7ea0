"""Compiled execution engine: table-level and cache-level unit tests.

Device-level bit-identity against the pre-PR interpreter (4 collectives ×
{ring, rhd, dex, direct} × n ∈ {4, 8}, full-axis and split) runs in
exec_engine_check.py under 8 host devices in a subprocess — XLA locks the
device count at first init, so it cannot share this process.  Everything
here is device-free: fingerprints, compiled tables vs the per-round
reference, round-group folding, the slot-addressed all-to-all compile
(checked by a pure-numpy emulation of the executor), LRU accounting, and
the attributable trace-time errors.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.comm import exec_engine
from repro.comm.errors import ScheduleExecutionError
from repro.core import schedules as S
from repro.core.schedules import Round, Schedule, Transfer

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ------------------------------------------------------------ fingerprint
def test_fingerprint_stable_across_reconstruction():
    a = S.ring_reduce_scatter(8, 4096.0)
    b = S.ring_reduce_scatter(8, 4096.0)
    assert a is not b and a.fingerprint() == b.fingerprint()
    assert a.fingerprint() == a.fingerprint()  # memoized path


def test_fingerprint_ignores_byte_sizes():
    # a buffer-size sweep rescales one template; execution is unchanged, so
    # every size shares one compiled executable
    assert (
        S.ring_reduce_scatter(8, 1024.0).fingerprint()
        == S.ring_reduce_scatter(8, 1 << 30).fingerprint()
    )


def test_fingerprint_distinguishes_structure():
    fps = {
        S.ring_reduce_scatter(8, 1024.0).fingerprint(),
        S.rhd_reduce_scatter(8, 1024.0).fingerprint(),
        S.ring_all_gather(8, 1024.0).fingerprint(),
        S.ring_reduce_scatter(4, 1024.0).fingerprint(),
        S.dex_all_to_all(8, 1024.0).fingerprint(),
        S.direct_all_to_all(8, 1024.0).fingerprint(),
    }
    assert len(fps) == 6


def test_fingerprint_collision_regression():
    """Fingerprints are injective on schedule structure (the docstring of
    Schedule.fingerprint points here).  Sweep the generator zoo plus a
    batch of structurally-adjacent hand variants — every distinct
    (perm, chunk, reduce, round-boundary) table must hash distinctly."""
    zoo = []
    for n in (2, 3, 4, 6, 8, 16):
        zoo += [S.ring_reduce_scatter(n, 1.0), S.ring_all_gather(n, 1.0),
                S.ring_all_reduce(n, 1.0), S.direct_all_to_all(n, 1.0),
                S.ring_all_to_all(n, 1.0)]
    for n in (2, 4, 8, 16):
        zoo += [S.rhd_reduce_scatter(n, 1.0), S.rhd_all_gather(n, 1.0),
                S.rhd_all_reduce(n, 1.0), S.dex_all_to_all(n, 1.0)]
    for dims in ((2, 2), (2, 4), (3, 3), (2, 2, 2)):
        zoo += [S.bucket_reduce_scatter(dims, 1.0),
                S.bucket_all_gather(dims, 1.0)]

    # adjacent variants that a sloppy (non-delimited) encoding would merge:
    base = S.ring_reduce_scatter(4, 1.0)
    flat = Schedule(base.collective, base.algorithm, base.n, 1.0,
                    (Round(tuple(t for r in base.rounds
                                 for t in r.transfers), 1.0),))
    zoo.append(flat)  # same transfers, different round boundaries
    t = base.rounds[0].transfers[0]
    one = Schedule("p2p", "direct", 4, 1.0,
                   (Round((Transfer(t.src, t.dst, t.chunks, t.reduce),), 1.0),))
    two = Schedule("p2p", "direct", 4, 1.0,
                   (Round((Transfer(t.src, t.dst, (1, 2), t.reduce),), 1.0),))
    twelve = Schedule("p2p", "direct", 4, 1.0,
                      (Round((Transfer(t.src, t.dst, (12,), t.reduce),), 1.0),))
    zoo += [one, two, twelve]  # chunks (1,2) vs (12) must not collide

    fps = [s.fingerprint() for s in zoo]
    assert len(set(fps)) == len(fps), "fingerprint collision in sweep"


# ------------------------------------------------------------ PCCL_VERIFY
def _corrupt(sched):
    """Relabel one chunk: the rounds stay valid permutations (so the
    executable compiles), but the dataflow postcondition fails — exactly
    the class of bug only the static verifier catches."""
    rounds = list(sched.rounds)
    tf = list(rounds[0].transfers)
    t = tf[0]
    bad_chunk = (t.chunks[0] + 1) % sched.n
    tf[0] = Transfer(t.src, t.dst, (bad_chunk,) + t.chunks[1:], t.reduce)
    rounds[0] = Round(tuple(tf), rounds[0].size)
    return Schedule(sched.collective, sched.algorithm, sched.n,
                    sched.buffer_bytes, tuple(rounds))


def test_pccl_verify_disabled_compiles_corrupt(monkeypatch):
    monkeypatch.delenv("PCCL_VERIFY", raising=False)
    exec_engine.clear_exec_caches()
    compiled = exec_engine.compile_schedule(_corrupt(S.ring_reduce_scatter(8, 64.0)))
    assert compiled is not None  # off by default: zero-overhead path


def test_pccl_verify_enabled_rejects_corrupt(monkeypatch):
    from repro.analysis.verify import ScheduleVerificationError

    monkeypatch.setenv("PCCL_VERIFY", "1")
    exec_engine.clear_exec_caches()
    with pytest.raises(ScheduleVerificationError):
        exec_engine.compile_schedule(_corrupt(S.ring_reduce_scatter(8, 64.0)))
    # correct schedules still compile with verification on
    assert exec_engine.compile_schedule(S.ring_reduce_scatter(8, 64.0))


def test_pccl_verify_cache_hits_skip_verification(monkeypatch):
    monkeypatch.delenv("PCCL_VERIFY", raising=False)
    exec_engine.clear_exec_caches()
    bad = _corrupt(S.ring_reduce_scatter(8, 64.0))
    exec_engine.compile_schedule(bad)  # populate cache while disabled
    monkeypatch.setenv("PCCL_VERIFY", "1")
    # hit: env is only consulted on compile-cache miss
    assert exec_engine.compile_schedule(bad) is not None
    exec_engine.clear_exec_caches()


# -------------------------------------------------------- compiled tables
def _flat_tables(compiled):
    """(perm, send_row, recv_row, reduce) per round, unstacked."""
    out = []
    for grp in compiled.groups:
        for g in range(grp.rounds):
            out.append((list(grp.perm), grp.send_ids[g], grp.recv_ids[g], grp.reduce))
    return out


@pytest.mark.parametrize(
    "sched",
    [
        S.ring_reduce_scatter(8, 4096.0),
        S.rhd_all_gather(8, 4096.0),
        S.ring_all_reduce(8, 4096.0),
        S.bucket_all_reduce((2, 4), 4096.0),
        S.dex_all_to_all(8, 4096.0),
        S.direct_all_to_all(8, 4096.0),
        S.ring_all_to_all(4, 4096.0),
    ],
    ids=lambda s: f"{s.collective}-{s.algorithm}",
)
def test_compiled_tables_match_reference(sched):
    compiled = exec_engine.compile_schedule(sched)
    assert compiled.num_rounds == sched.num_rounds
    flat = _flat_tables(compiled)
    assert len(flat) == sched.num_rounds
    for i, rnd in enumerate(sched.rounds):
        perm, send, recv, reduce = exec_engine.round_tables(rnd, sched.n)
        cperm, csend, crecv, creduce = flat[i]
        assert cperm == perm and creduce == reduce
        np.testing.assert_array_equal(csend, send)
        np.testing.assert_array_equal(crecv, recv)


def test_round_group_folding():
    # ring RS: n-1 rounds, one perm, one reduce flag -> a single scan group
    rs = exec_engine.compile_schedule(S.ring_reduce_scatter(8, 1.0))
    assert [g.rounds for g in rs.groups] == [7]
    # ring all-reduce: RS phase + AG phase -> exactly two groups
    ar = exec_engine.compile_schedule(S.ring_all_reduce(8, 1.0))
    assert [g.rounds for g in ar.groups] == [7, 7]
    assert [g.reduce for g in ar.groups] == [True, False]
    # RHD pairs a different bit each round -> per-round fallback groups
    rhd = exec_engine.compile_schedule(S.rhd_reduce_scatter(8, 1.0))
    assert [g.rounds for g in rhd.groups] == [1, 1, 1]
    # bucket: every torus-axis phase folds into one group
    b = exec_engine.compile_schedule(S.bucket_reduce_scatter((2, 4), 1.0))
    assert sum(g.rounds for g in b.groups) == b.num_rounds
    assert len(b.groups) < b.num_rounds
    # ring all-to-all shares the perm but k shrinks per round -> no folding
    ra = exec_engine.compile_schedule(S.ring_all_to_all(4, 1.0))
    assert [g.rounds for g in ra.groups] == [1] * ra.num_rounds


def test_compiled_cache_accounting():
    exec_engine.clear_exec_caches()
    sched = S.ring_reduce_scatter(16, 512.0)
    c1 = exec_engine.compile_schedule(sched)
    s = exec_engine.exec_stats()
    assert s.compiled_misses == 1 and s.compiled_hits == 0
    c2 = exec_engine.compile_schedule(S.ring_reduce_scatter(16, 512.0))
    s = exec_engine.exec_stats()
    assert s.compiled_hits == 1 and c2 is c1  # the cached object, same id
    # a rescaled sweep template is the same executable (size-free fingerprint)
    c3 = exec_engine.compile_schedule(S.ring_reduce_scatter(16, 2048.0))
    assert c3 is c1


def test_lru_bound_and_eviction():
    lru = exec_engine._LruCache(max_entries=2)
    lru.put("a", 1)
    lru.put("b", 2)
    assert lru.get("a") == 1  # refreshes a
    lru.put("c", 3)  # evicts b (LRU)
    assert lru.get("b") is None and lru.get("a") == 1 and lru.get("c") == 3
    assert lru.evictions == 1 and len(lru) == 2


# ----------------------------------------------- slot-addressed all-to-all
def _emulate_compiled(compiled, m, local_of):
    """Pure-numpy replay of execute_compiled over integer chunk ids."""
    n_rows = compiled.n
    buf = np.array(
        [[local_of[r] * m + t for t in range(m)] for r in range(n_rows)],
        dtype=np.int64,
    )
    for grp in compiled.groups:
        dst_of = dict(grp.perm)
        for g in range(grp.rounds):
            payload = {r: buf[r, grp.send_ids[g, r]].copy() for r in range(n_rows)}
            for r in range(n_rows):
                d = dst_of[r]
                buf[d, grp.recv_ids[g, d]] = payload[r]
    return buf


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("algo", ["dex", "direct", "ring"])
def test_slot_compile_satisfies_post_condition(n, algo):
    sched = S.get_schedule("all_to_all", algo, n, 4096.0)
    local_of = tuple(range(n))
    compiled = exec_engine.compile_all_to_all(sched, n, local_of)
    assert compiled is not None, f"{algo} n={n} must be slot-addressable"
    assert compiled.final_slots.shape == (n, n)
    buf = _emulate_compiled(compiled, n, local_of)
    # rank r ends holding block (o -> r) at final_slots[r, o], for every o
    for r in range(n):
        for o in range(n):
            assert buf[r, compiled.final_slots[r, o]] == o * n + r


def test_slot_compile_grouped_local_ids():
    """Composed split schedule: group-local chunk ids, global ranks."""
    from repro.api import subgroup_schedule

    m, n_axis = 4, 8
    groups = ((0, 2, 4, 6), (1, 3, 5, 7))
    local_of = [0] * n_axis
    for g in groups:
        for i, r in enumerate(g):
            local_of[r] = i
    sched = subgroup_schedule(S.direct_all_to_all(m, 1024.0), groups, n_axis)
    compiled = exec_engine.compile_all_to_all(sched, m, tuple(local_of))
    assert compiled is not None and compiled.final_slots.shape == (n_axis, m)
    buf = _emulate_compiled(compiled, m, tuple(local_of))
    for r in range(n_axis):
        for o in range(m):
            assert buf[r, compiled.final_slots[r, o]] == o * m + local_of[r]


def test_slot_compile_rejects_unheld_chunk():
    # rank 0 claims to send block (1 -> 1), which it never held -> dense path
    n = 2
    rounds = (
        Round(
            (
                Transfer(0, 1, chunks=(3,), reduce=False),
                Transfer(1, 0, chunks=(2,), reduce=False),
            ),
            1.0,
        ),
    )
    bad = Schedule("all_to_all", "bad", n, 4.0, rounds)
    assert exec_engine.compile_all_to_all(bad, n, (0, 1)) is None
    # the verdict (and the sentinel) is memoized
    assert exec_engine.compile_all_to_all(bad, n, (0, 1)) is None


def test_slot_compile_rejects_reduce_rounds():
    bad = Schedule(
        "all_to_all",
        "bad",
        2,
        4.0,
        (
            Round(
                (
                    Transfer(0, 1, chunks=(1,), reduce=True),
                    Transfer(1, 0, chunks=(2,), reduce=True),
                ),
                1.0,
            ),
        ),
    )
    assert exec_engine.compile_all_to_all(bad, 2, (0, 1)) is None


# ------------------------------------------------------ attributable errors
def test_round_table_errors_name_round_and_schedule():
    good = S.ring_all_gather(4, 1024.0)
    # break round 1: rank 0 sends twice (not a permutation)
    r1 = good.rounds[1]
    broken = Round(r1.transfers + (Transfer(0, 2, chunks=(0,)),), r1.size)
    bad = Schedule(
        good.collective, good.algorithm, good.n, good.buffer_bytes,
        (good.rounds[0], broken, good.rounds[2]),
    )
    with pytest.raises(ScheduleExecutionError, match=r"all_gather/ring round 1/3"):
        exec_engine.compile_schedule(bad)

    # chunkless schedules stay attributable too
    swing = S.swing_reduce_scatter(8, 1024.0)
    with pytest.raises(
        ScheduleExecutionError, match=r"reduce_scatter/swing round 0/3.*chunk"
    ):
        exec_engine.compile_schedule(swing)


def test_legacy_round_tables_signature():
    from repro.comm import primitives as prim

    rnd = S.ring_all_gather(4, 64.0).rounds[0]
    perm, send, recv, reduce = prim._round_tables(rnd, 4)
    assert len(perm) == 4 and send.shape == (4, 1) and reduce is False


# ------------------------------------------------------ communicator bits
def test_local_index_table_cached_and_correct():
    from repro.api import PcclSession
    from repro.core import cost_model as cm

    session = PcclSession(cm.H100_DGX, thread_fabric=False)
    root = session.communicator("x", 8, backend="sim")
    sub = root.split([r % 2 for r in range(8)])
    t1 = sub.local_index_table()
    np.testing.assert_array_equal(t1, [0, 0, 1, 1, 2, 2, 3, 3])
    assert sub.local_index_table() is t1  # built once, cached
    assert not t1.flags.writeable
    np.testing.assert_array_equal(root.local_index_table(), np.arange(8))
    assert root.group_fingerprint() == ("full", 8)
    assert sub.group_fingerprint() == ("split", ((0, 2, 4, 6), (1, 3, 5, 7)))


def test_sim_all_gather_preserves_array_namespace():
    from repro.api import PcclSession
    from repro.core import cost_model as cm

    session = PcclSession(cm.H100_DGX, thread_fabric=False)
    comm = session.communicator("x", 4, backend="sim")
    xnp = np.ones((2, 3), np.float16)
    out = comm.all_gather(xnp)
    assert isinstance(out, np.ndarray) and out.dtype == np.float16
    assert out.shape == (8, 3)

    jnp = pytest.importorskip("jax.numpy")
    xj = jnp.ones((2, 3), jnp.bfloat16)
    outj = comm.all_gather(xj)
    assert not isinstance(outj, np.ndarray)  # stayed a jax array
    assert outj.dtype == jnp.bfloat16 and outj.shape == (8, 3)


def test_session_exec_stats_surface():
    from repro.api import PcclSession
    from repro.core import cost_model as cm

    exec_engine.clear_exec_caches()
    s = PcclSession(cm.H100_DGX, thread_fabric=False)
    stats = s.exec_stats()
    assert stats.executable_hits == 0 and stats.traces == 0
    exec_engine.compile_schedule(S.ring_all_gather(4, 64.0))
    assert s.exec_stats().compiled_misses == 1


# ------------------------------------- the port: the round kernel's tables

# The port's engine (repro_torch) runs a rank-stacked round on a contiguous
# CUDA buffer as one pass of its round kernel, or two through a scratch
# buffer where a round is "staged"; on the CPU, and on the int8 wire, as
# PyTorch's indexing.  The kernel itself runs only on the card
# (tests/test_torch_cuda.py); here the tables it reads, the staged flags
# and the dispatch are held to the index path, with the kernel replaced by a
# CPU stand-in that moves one pair's row at a time, last pair first.

from repro_torch.comm import exec_engine as port  # noqa: E402
from repro_torch.comm import primitives as port_prims  # noqa: E402
from repro_torch.core import schedules as PS  # noqa: E402
from repro_torch.kernels.build import LAUNCHES  # noqa: E402
from repro_torch.kernels.rounds import ops as round_ops  # noqa: E402

REAL_ON_CARD = round_ops.on_card

PORT_CASES = {  # (collective, algorithm) at n = 8: the schedule and whether every round is staged
    ("all_reduce", "bucket2d"): (lambda: PS.bucket_all_reduce((2, 4), 4096.0), False),
    ("reduce_scatter", "bucket2d"): (lambda: PS.bucket_reduce_scatter((2, 4), 4096.0), False),
    ("all_gather", "bucket2d"): (lambda: PS.bucket_all_gather((2, 4), 4096.0), False),
    ("all_reduce", "ring"): (lambda: PS.ring_all_reduce(8, 4096.0), False),
    ("reduce_scatter", "ring"): (lambda: PS.ring_reduce_scatter(8, 4096.0), False),
    ("all_gather", "ring"): (lambda: PS.ring_all_gather(8, 4096.0), False),
    ("all_to_all", "dex"): (lambda: PS.dex_all_to_all(8, 4096.0), True),
    ("all_to_all", "direct"): (lambda: PS.direct_all_to_all(8, 4096.0), True),
}
PORT_IDS = [f"{c}-{a}" for c, a in PORT_CASES]


def _port_compiled(sched):
    if sched.collective == "all_to_all":
        return port.compile_all_to_all(sched, sched.n, tuple(range(sched.n)))
    return port.compile_schedule(sched)


def _operand(sched, dtype, chunk=(3, 2), seed=0):
    """A rank-stacked operand of the collective, values from numpy."""
    n = sched.n
    lead = 2 if sched.collective == "all_gather" else 2 * n
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, lead) + chunk).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("case", list(PORT_CASES), ids=PORT_IDS)
def test_port_staged_flag_at_compile(case):
    """A round is staged exactly where some rank's send and receive slots
    meet: none for bucket2d and ring, every round for the compact dex and
    direct all-to-all (its slot compile reuses a slot freed in the round)."""
    make, every = PORT_CASES[case]
    compiled = _port_compiled(make())
    flags = [bool(f) for g in compiled.groups for f in g.staged]
    assert len(flags) == compiled.num_rounds
    assert flags == [every] * compiled.num_rounds
    for g in compiled.groups:
        for i in range(g.rounds):
            meet = any(set(g.send_ids[i, r].tolist()) & set(g.recv_ids[i, r].tolist())
                       for r in range(compiled.n))
            assert bool(g.staged[i]) == meet


def _index_path(buf, rows, rnd):
    """The engine's round before the kernel, as it was written."""
    got = buf[rnd.src_rows, rnd.src_ids]
    if rnd.reduce:
        got = buf[rows, rnd.recv_ids] + got
    buf[rows, rnd.recv_ids] = got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=lambda d: str(d).rsplit(".", 1)[1])
@pytest.mark.parametrize("case", list(PORT_CASES), ids=PORT_IDS)
def test_port_plain_round_equals_the_index_path(case, dtype):
    """``ops.round_reference``, and the engine's ``apply_round`` on a CPU
    buffer, are the index path bit for bit, round after round; every round
    takes route ``torch`` and nothing launches."""
    compiled = _port_compiled(PORT_CASES[case][0]())
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.standard_normal((8, 8, 3, 2)).astype(np.float32)).to(dtype)
    tables = port.device_tables(compiled, buf.device)
    a, b, c = buf.clone(), buf.clone(), buf.clone()
    before = LAUNCHES.by_route("round")
    for rnd in tables.rounds:
        _index_path(a, tables.rows, rnd)
        round_ops.round_reference(b, tables.rows, rnd)
        assert port.apply_round(c, tables.rows, rnd) == "torch"
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        assert torch.equal(a.view(torch.uint8), c.view(torch.uint8))
    assert LAUNCHES.by_route("round") == before


def _pairs(src_ranks, src_ids, dst_ids, n, k):
    """The kernel's rows, pair by pair: ((sending rank, slot), receive slot)."""
    ranks = list(range(n)) if src_ranks is None else src_ranks.reshape(-1).tolist()
    sent = None if src_ids is None else src_ids.reshape(-1).tolist()
    recv = None if dst_ids is None else dst_ids.reshape(-1).tolist()
    for d in range(n):
        for j in range(k):
            p = d * k + j
            yield d, (ranks[d], j if sent is None else sent[p]), j if recv is None else recv[p]


def _stand_in(calls):
    """The round kernel's contract on the CPU: pair by pair, last first, each
    reads its source row and adds it into or stores it over its destination
    row at once, so a round run in place that needed staging would show."""
    def fake(src, src_ranks, src_ids, dst_ids, n, k, *, out, reduce=False, route="copy"):
        calls.append(route)
        assert src.ndim == out.ndim == 3 and src.is_contiguous() and out.is_contiguous()
        for d, (r, s), t in reversed(list(_pairs(src_ranks, src_ids, dst_ids, n, k))):
            row = src[r, s].clone()
            out[d, t] = out[d, t] + row if reduce else row
        return out
    return fake


@pytest.fixture
def kernel_stand_in(monkeypatch):
    calls = []
    monkeypatch.setattr(round_ops, "stacked_round_cuda", _stand_in(calls))
    monkeypatch.setattr(round_ops, "on_card", lambda t: True)
    monkeypatch.setattr(port, "on_card", lambda t: True)
    port.clear_exec_caches()
    yield calls
    port.clear_exec_caches()


def _expected_launches(compiled):
    flags = [bool(f) for g in compiled.groups for f in g.staged]
    routes = [r for f in flags for r in (("staged", "staged") if f else ("inplace",))]
    if compiled.collective in ("reduce_scatter", "all_to_all"):
        routes.append("copy")  # the diagonal gather, the final slots' gather
    if compiled.collective == "all_gather":
        routes.insert(0, "copy")  # the diagonal store
    return routes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=lambda d: str(d).rsplit(".", 1)[1])
@pytest.mark.parametrize("case", list(PORT_CASES), ids=PORT_IDS)
def test_port_kernel_path_equals_the_reference(case, dtype, kernel_stand_in):
    """Every collective through the kernel's path (its flat tables, the
    staged rounds' scratch, the copies), with the kernel's contract run on
    the CPU, is bit for bit the per-round reference interpreter, with the
    launches the compiled flags predict."""
    sched = PORT_CASES[case][0]()
    x = _operand(sched, dtype, seed=1)
    got = getattr(port_prims, sched.collective)(x, sched)
    want = port_prims.run_reference(sched.collective, x, sched)
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert kernel_stand_in == _expected_launches(_port_compiled(sched))


@pytest.mark.parametrize("case", [c for c in PORT_CASES if PORT_CASES[c][1]],
                         ids=[i for i, c in zip(PORT_IDS, PORT_CASES) if PORT_CASES[c][1]])
def test_port_staged_rounds_need_their_scratch(case, kernel_stand_in, monkeypatch):
    """The staged flag is needed: run every round of the compact all-to-all
    in place, in one order of the pairs or the other, and the result is
    wrong."""
    sched = PORT_CASES[case][0]()
    x = _operand(sched, torch.float32, seed=2)
    want = port_prims.run_reference("all_to_all", x, sched)
    wrong = []
    for order in (lambda p: p, lambda p: p[::-1]):
        def in_place(src, src_ranks, src_ids, dst_ids, n, k, *, out, reduce=False, route="copy",
                     order=order):
            for d, (r, s), t in order(list(_pairs(src_ranks, src_ids, dst_ids, n, k))):
                out[d, t] = src[r, s]
            return out

        monkeypatch.setattr(round_ops, "stacked_round_cuda", in_place)
        compiled = _port_compiled(sched)
        for g in compiled.groups:
            object.__setattr__(g, "staged", np.zeros_like(g.staged))
        got = port_prims.all_to_all(x, sched)
        wrong.append(not torch.equal(got, want))
        port.clear_exec_caches()
    assert any(wrong)


def test_port_transform_and_cpu_take_the_plain_path(kernel_stand_in, monkeypatch):
    """A round with a wire ``transform`` never reaches the kernel, and a CPU
    buffer never does (the real ``on_card``); a card buffer does (here a
    CPU one, through the stand-in), and one that is not contiguous is
    refused, by the engine and by the round itself, before anything
    launches."""
    sched = PS.ring_all_reduce(8, 4096.0)
    compiled = port.compile_schedule(sched)
    buf = _operand(sched, torch.float32).reshape(8, 8, -1).clone()
    tables = port.device_tables(compiled, buf.device)
    rnd = tables.rounds[0]
    assert port.apply_round(buf, tables.rows, rnd, transform=lambda p: p) == "torch"
    assert kernel_stand_in == []
    assert port.apply_round(buf, tables.rows, rnd) == "inplace"
    assert kernel_stand_in == ["inplace"]
    strided = buf.transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        port.apply_round(strided, tables.rows, rnd)
    with pytest.raises(port.ScheduleExecutionError, match="contiguous"):
        port.execute_compiled(strided, compiled)
    with pytest.raises(ValueError, match="contiguous"):
        port.take_diagonal(strided, compiled)
    assert kernel_stand_in == ["inplace"]
    # the collectives hand the engine contiguous copies of a strided operand
    x = _operand(sched, torch.float32).transpose(0, 1).contiguous().transpose(0, 1)
    assert not x.is_contiguous()
    got = port_prims.all_reduce(x, sched)
    assert torch.equal(got, port_prims.run_reference("all_reduce", x, sched))
    assert kernel_stand_in == ["inplace"] * (1 + compiled.num_rounds)
    # the real dispatch: a CPU buffer takes torch's indexing
    monkeypatch.setattr(round_ops, "on_card", REAL_ON_CARD)
    assert port.apply_round(buf, tables.rows, rnd) == "torch"
    assert kernel_stand_in == ["inplace"] * (1 + compiled.num_rounds)


def test_port_cpu_collectives_launch_nothing():
    """On the CPU (the real dispatch), the collectives, the compact
    all-to-all and the int8 wire launch no kernel and take route ``torch``."""
    from repro_torch.comm.fusion import all_reduce_quantized
    from repro_torch.kernels.rounds.ops import on_card

    before = LAUNCHES.by_route("round")
    for make, _ in PORT_CASES.values():
        sched = make()
        x = _operand(sched, torch.float32)
        assert not on_card(x)
        getattr(port_prims, sched.collective)(x, sched)
    all_reduce_quantized(_operand(PS.ring_ef8_all_reduce(8, 1.0), torch.float32),
                         PS.ring_ef8_all_reduce(8, 1.0))
    assert LAUNCHES.by_route("round") == before == {
        "inplace": before["inplace"], "staged": before["staged"], "copy": before["copy"]}


@pytest.mark.parametrize("dtype", [torch.int8, torch.bool, torch.complex64],
                         ids=lambda d: str(d).rsplit(".", 1)[1])
def test_port_kernel_refuses_a_reduce_it_cannot_add(dtype):
    """The round kernel adds float32, float64, float16, bfloat16, int32 and
    int64; a reduce in any other dtype raises before anything launches (a
    store moves any dtype: its check passes and the device check raises)."""
    from repro_torch.kernels.rounds.kernel import stacked_round_cuda

    t = torch.zeros((2, 2, 8), dtype=dtype)
    with pytest.raises(ValueError, match="no reduce in"):
        stacked_round_cuda(t, None, None, None, 2, 2, out=t, reduce=True)
    with pytest.raises(ValueError, match="CUDA device"):
        stacked_round_cuda(t, None, None, None, 2, 2, out=t)


@pytest.mark.parametrize("stand_in", [False, True], ids=["cpu", "kernel-stand-in"])
def test_port_round_spans_carry_the_route(stand_in, request):
    """Each ``round`` span names the route its round took: ``torch`` on the
    CPU and on the int8 wire, the kernel's mode where the kernel runs."""
    from repro_torch import spans
    from repro_torch.comm.fusion import all_reduce_quantized

    calls = request.getfixturevalue("kernel_stand_in") if stand_in else None
    runs = [PORT_CASES[("all_reduce", "bucket2d")][0](), PORT_CASES[("all_to_all", "dex")][0]()]
    for sched in runs:
        x = _operand(sched, torch.float32)
        with spans.tracing():
            getattr(port_prims, sched.collective)(x, sched)
        routes = [s.attrs["route"] for s in spans.records() if s.name == "round"]
        flags = [bool(f) for g in _port_compiled(sched).groups for f in g.staged]
        want = [("staged" if f else "inplace") if stand_in else "torch" for f in flags]
        assert routes == want
    ef8 = PS.ring_ef8_all_reduce(8, 1.0)
    with spans.tracing():
        all_reduce_quantized(_operand(ef8, torch.float32), ef8)
    assert {s.attrs["route"] for s in spans.records() if s.name == "round"} == {"torch"}
    if stand_in:
        assert "torch" not in calls


# ------------------------------------------------------- device subprocess
@pytest.mark.slow
@pytest.mark.multidevice
def test_exec_engine_device_checks():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "exec_engine_check.py")],
        capture_output=True,
        text=True,
        env=env,
        timeout=600,
    )
    assert proc.returncode == 0, f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
    assert "ALL-EXEC-ENGINE-OK" in proc.stdout
