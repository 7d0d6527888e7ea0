"""The port's collectives on one process per rank, against the rank-stacked
engine and the JAX package, on the CPU.

Each world size (2, 4 and 8) is one spawn of gloo processes on a
``FileStore`` under ``tmp_path`` (``repro_torch.launch.procs``), which runs
every case of that size and hands back each rank's result.  The cases are
those of ``tests/multidevice_check.py`` (every collective × algorithm,
the communicator at ``auto`` and ``native``, split groups, the compressed
all-reduce with error feedback), plus the planner's forced algorithms,
``ring_ef8``, the two fused seams, and two hand-built schedules: one with
identity pairs (a rank that "sends" to itself copies locally), one whose
round leaves ranks with nothing to receive.

Tolerances: fp32 results are **bit-identical** to the rank-stacked engine
(same payloads, same add order per receiver) and to the reference's
per-round interpreter under ``jax.vmap``; ``native`` (gloo's own sums, in
gloo's order) agrees within 1e-5; the fused seams equal their unfused
compositions bit for bit; a round that leaves a rank with nothing to
receive is refused by all three with the same message.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.api import PcclSession as RefSession
from repro.comm import errors as ref_errors
from repro.comm import fusion as ref_fusion
from repro.comm import pccl_collectives as ref_pc
from repro.comm import primitives as ref_prims
from repro.core import cost_model as ref_cm
from repro.core import schedules as ref_S
from repro_torch.api import PcclSession
from repro_torch.comm import ScheduleExecutionError
from repro_torch.comm import fusion
from repro_torch.comm import pccl_collectives as pc
from repro_torch.comm import primitives as P
from repro_torch.core import cost_model as cm
from repro_torch.core import schedules as S
from repro_torch.launch import procs

NS = (2, 4, 8)
TIMEOUT_S = 240.0


def _identity_rounds(n):
    """A reduce round of a swap of ranks 0 and 1 with every other rank its
    own partner, then a store round rotating ranks 1 … n-1 with rank 0 its
    own partner (at n = 2 every pair is an identity)."""
    r0 = [(0, 1, 0), (1, 0, 1)] + [(r, r, r) for r in range(2, n)]
    r1 = [(r, 0 if r == 0 else 1 + r % (n - 1), (r + 1) % n) for r in range(n)]
    return [(r0, True), (r1, False)]


def _tree_round(n):
    """A binomial broadcast step: the first half sends, the second half
    receives, so half the ranks receive nothing."""
    return [([(r, r + n // 2, r) for r in range(n // 2)], False)]


def _cases(n):
    """``(id, case)`` pairs of one world size; ``case`` is what
    ``procs.collectives_program`` runs."""
    out = []

    def add(name, **case):
        out.append((name, dict(n=n, seed=len(out) + 10 * n, **case)))

    for coll, algos in (("reduce_scatter", ("ring", "rhd")), ("all_gather", ("ring", "rhd")),
                        ("all_reduce", ("ring", "rhd")),
                        ("all_to_all", ("dex", "direct", "ring"))):
        for algo in algos:
            local = (5, 3) if coll == "all_gather" else (6 * n, 3)
            gen = f"{algo}_{coll}"
            add(f"prim-{coll}-{algo}", path="prim", collective=coll, local=local,
                build=(gen, n, "nbytes"))
            add(f"reference-{coll}-{algo}", path="reference", collective=coll, local=local,
                build=(gen, n, "nbytes"))
    if n >= 4:
        add("prim-all_reduce-bucket2d", path="prim", collective="all_reduce", local=(40,),
            build=("bucket_all_reduce", (2, n // 2), "nbytes"))
    for coll in ("all_reduce", "reduce_scatter", "all_gather", "all_to_all"):
        local = (5, 3) if coll == "all_gather" else (6 * n, 3)
        add(f"comm-{coll}-auto", path="comm", collective=coll, local=local, hw="H100_DGX")
        add(f"comm-{coll}-native", path="comm", collective=coll, local=local, hw="H100_DGX",
            backend="native")
        if n >= 4:
            add(f"split-{coll}-interp", path="comm", collective=coll, hw="H100_DGX",
                local=(5, 3) if coll == "all_gather" else (6 * (n // 2), 3),
                colors=[r % 2 for r in range(n)])
            add(f"split-{coll}-native", path="comm", collective=coll, hw="H100_DGX",
                local=(5, 3) if coll == "all_gather" else (6 * (n // 2), 3),
                colors=[r % 2 for r in range(n)], backend="native")
    add("comm-all_reduce-ring_ef8", path="comm", collective="all_reduce", local=(10 * n, 3),
        hw="H100_DGX", algorithm="ring_ef8")
    if n >= 4:
        add("split-all_reduce-ring_ef8", path="comm", collective="all_reduce",
            local=(10 * (n // 2), 3), hw="H100_DGX", algorithm="ring_ef8",
            colors=[r % 2 for r in range(n)])
    add("compressed-ef", path="ef8", local=(n * 12,), steps=3)
    add("schedule-identity-pairs", path="schedule", collective="all_reduce", local=(n, 3),
        rounds=_identity_rounds(n))
    add("schedule-tree-round", path="schedule", collective="all_gather", local=(n, 3),
        rounds=_tree_round(n))
    add("fused-mm-rs", path="fused_mm_rs", local=(8 * n, 16), side=(16, 8), hw="H100_DGX",
        algorithm="ring")
    add("fused-ar-rms", path="fused_ar_rms", local=(6, 16 * n), side=(16 * n,), hw="H100_DGX")
    return out


CASES = {n: _cases(n) for n in NS}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world size's results, spawned once on first use."""
    done = {}

    def get(n):
        if n not in done:
            cases = [c for _, c in CASES[n]]
            done[n] = procs.spawn(procs.collectives_program, n, (cases, "cpu"),
                                  store_dir=str(tmp_path_factory.mktemp(f"store{n}")),
                                  timeout_s=TIMEOUT_S)
        return done[n]

    return get


def _comms(case):
    n, algo = case["n"], case.get("algorithm", "auto")
    ref = RefSession(ref_cm.H100_DGX).communicator("x", n, algorithm=algo)
    port = PcclSession(cm.H100_DGX, device="cpu").communicator(
        "x", n, algorithm=algo, backend=case.get("backend", "interp"))
    if case.get("colors"):
        ref, port = ref.split(case["colors"]), port.split(case["colors"])
    return ref, port


def _vmap(fn, x, jit=False):
    """``fn`` over the rank-stacked ``x`` under ``jax.vmap``; ``jit`` where
    the reference runs compiled inside ``shard_map``, as its int8 wire does
    (XLA folds ``/ 127.0`` into a multiply by the reciprocal, which the
    port copies)."""
    f = jax.vmap(fn, axis_name="x")
    return np.asarray((jax.jit(f) if jit else f)(jnp.asarray(x)))


def _stacked_and_jax(case, X):
    """(the rank-stacked engine's result, the JAX reference's or None)."""
    path, coll = case["path"], case.get("collective")
    x = torch.from_numpy(X)
    if path in ("prim", "reference"):
        # a schedule's chunk tables do not depend on its byte size
        sched, ref_sched = procs.case_schedule(case, S), procs.case_schedule(case, ref_S)
        got = getattr(P, coll)(x, sched) if path == "prim" else P.run_reference(coll, x, sched)
        return got.numpy(), _vmap(lambda xl: ref_prims.run_reference(coll, xl, ref_sched, "x"), X)
    if path == "comm":
        ref, port = _comms(case)
        got = getattr(port, coll)(x).numpy()
        if case.get("backend") == "native":
            return got, None
        ef8 = case.get("algorithm") == "ring_ef8"
        if ef8 and ref.groups is None:
            sched = ref.axis_schedule("all_reduce", X[0].size * 4)
            return got, _vmap(lambda xl: ref_fusion.all_reduce_quantized(xl, sched, "x"), X,
                              jit=True)
        if ref.groups is not None:
            return got, _vmap(getattr(ref, coll), X, jit=ef8)
        nbytes = X[0].size * 4 * (port.n if coll == "all_gather" else 1)
        sched = ref.axis_schedule(coll, nbytes)
        return got, _vmap(lambda xl: ref_prims.run_reference(coll, xl, sched, "x"), X)
    if path == "ef8":
        n = case["n"]
        ef = pc.ErrorFeedbackState.init(x.shape, device="cpu")
        sums = []
        for _ in range(case["steps"]):
            red, ef = pc.compressed_all_reduce_ef(x, ef, n, None)
            sums.append(red)
        got = torch.stack(sums + [ef.residual], dim=1).numpy()
        want = _vmap(lambda xl: ref_pc.compressed_all_reduce(xl, "x", n), X, jit=True)
        return got, want
    if path == "schedule":
        sched, ref_sched = procs.hand_schedule(case, S), procs.hand_schedule(case, ref_S)
        got = P.execute_schedule(x.clone(), sched).numpy()
        return got, _vmap(lambda xl: ref_prims.execute_schedule_reference(xl, ref_sched, "x"), X)
    raise ValueError(path)


def _ids(n):
    return [(n, i) for i in range(len(CASES[n]))]


@pytest.mark.parametrize("n,i", [p for n in NS for p in _ids(n)],
                         ids=[f"n{n}-{name}" for n in NS for name, _ in CASES[n]])
def test_process_group_collective(worlds, n, i):
    name, case = CASES[n][i]
    results = worlds(n)
    outs = [r["cases"][i]["out"] for r in results]
    X = procs.stacked_input(case)
    if name == "schedule-tree-round":
        # every rank refuses the round, as the rank-stacked engine and the
        # reference do, with the same message
        with pytest.raises(ScheduleExecutionError) as stacked:
            P.execute_schedule(torch.from_numpy(X), procs.hand_schedule(case, S))
        with pytest.raises(ref_errors.ScheduleExecutionError) as ref:
            _vmap(lambda xl: ref_prims.execute_schedule_reference(
                xl, procs.hand_schedule(case, ref_S), "x"), X)
        assert str(stacked.value) == str(ref.value)
        assert outs == [f"ScheduleExecutionError: {stacked.value}"] * n
        return
    if case["path"].startswith("fused"):
        _check_fused(case, X, outs)
        return
    got = np.stack(outs)
    if case["path"] == "ef8":  # per rank: the step sums, then the residual
        stacked, want = _stacked_and_jax(case, X)
        np.testing.assert_array_equal(got, stacked)
        np.testing.assert_array_equal(got[:, 0], want)  # the first step: the plain reduce
        return
    stacked, want = _stacked_and_jax(case, X)
    assert got.shape == stacked.shape
    if case.get("backend") == "native":
        np.testing.assert_allclose(got, stacked, rtol=1e-5, atol=1e-5)
        return
    np.testing.assert_array_equal(got, stacked)  # bit-identical to the rank-stacked engine
    np.testing.assert_array_equal(got, want)     # and to the reference


def _check_fused(case, X, outs):
    """Fused equals unfused in every process, and both equal the
    rank-stacked seam on the stacked operand."""
    n = case["n"]
    side = torch.from_numpy(procs.side_input(case))
    for fused, unfused in outs:
        np.testing.assert_array_equal(fused, unfused)
    comm = PcclSession(cm.H100_DGX, device="cpu").communicator(
        "x", n, algorithm=case.get("algorithm", "auto"))
    x = torch.from_numpy(X)
    if case["path"] == "fused_mm_rs":
        stacked = fusion.fused_matmul_reduce_scatter(comm, x, side)
    else:
        stacked = fusion.fused_all_reduce_rmsnorm(comm, x, side)
    np.testing.assert_array_equal(np.stack([f for f, _ in outs]), stacked.numpy())


def test_every_rank_ran_its_rounds_on_the_gloo_route(worlds):
    """The CPU world's rounds all took the ``gloo`` route; nothing was
    staged through host memory (the operands already live there)."""
    for r in worlds(4):
        assert set(r["route_rounds"]) == {"gloo"} and r["route_rounds"]["gloo"] > 0
        assert r["staged_bytes"] == 0


def test_an_unsupported_backend_raises(tmp_path):
    """A process group whose backend has no transport here (a fake group,
    which moves no data) raises instead of running a collective."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        comm = PcclSession(cm.H100_DGX, device="cpu").communicator(dist.group.WORLD)
        assert comm.n == 2 and comm.process_group is dist.group.WORLD
        with pytest.raises(ScheduleExecutionError, match="backend 'fake'"):
            comm.all_reduce(torch.ones(4))
        with pytest.raises(ScheduleExecutionError, match="backend 'fake'"):
            pc.compressed_all_reduce(torch.ones(4), 2, dist.group.WORLD)
    finally:
        dist.destroy_process_group()


def test_a_hung_rank_fails_the_spawn_within_its_timeout(tmp_path):
    """A rank that never returns is killed at the spawn's timeout, which
    fails the call, rather than holding the run."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish"):
        procs.spawn(time.sleep, 2, (600,), store_dir=str(tmp_path), timeout_s=15.0)
    assert time.monotonic() - t0 < 60
