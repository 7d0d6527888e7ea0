"""The port's schedule verifier, simulator and ``PCCL_VERIFY`` hook against
the JAX package's, on the CPU.

Each package builds its own schedules: the 78 cases of the analysis CLI's
``_generator_cases()`` and the mutants of ``tests/test_verify_mutations.py``
(the same operators, drawn from the same seed in each package).  Every
comparison is exact: fingerprints, ``ok`` / ``verifiable``, the violation
strings, ``rounds_checked``, the simulator's final masks (or its error),
and round feasibility.  The hook runs the verifier in ``compile_schedule``
on a cache miss; with it on, the collectives stay bit-identical to the
reference's interpreter under ``jax.vmap`` (the oracle of
``tests/test_torch_collectives.py``).
"""

import importlib
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.analysis import __main__ as ref_cli
from repro.analysis import invariants as ref_inv
from repro.analysis import verify as ref_verify
from repro.api import PcclSession as RefSession
from repro.comm import primitives as ref_prims
from repro.core import cost_model as ref_cm
from repro.core import schedules as ref_S
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import invariants as inv
from repro_torch.analysis import verify
from repro_torch.api import PcclSession
from repro_torch.comm import exec_engine
from repro_torch.core import cost_model as cm
from repro_torch.core import schedules as S

# the modules: each package's ``core`` exports a function of the same name
ref_sim = importlib.import_module("repro.core.simulate")
sim = importlib.import_module("repro_torch.core.simulate")

D = 1 << 20


def _verdict(result):
    return (result.collective, result.algorithm, result.n, result.ok, result.verifiable,
            [str(v) for v in result.violations], result.rounds_checked)


def _simulated(sim_mod, sched):
    """The simulator's final masks and the post-condition's verdict, or the
    error each raised (a duplicated reduce send makes ``simulate`` raise
    ``KeyError`` in both packages)."""
    try:
        state = sim_mod.simulate(sched)
    except Exception as e:  # compared, not swallowed
        return ("simulate raised", type(e).__name__, str(e))
    try:
        sim_mod.verify(sched)
        post = "holds"
    except Exception as e:
        post = (type(e).__name__, str(e))
    return state, post


# --------------------------------------------------- the generator zoo (78)

REF_CASES = list(ref_cli._generator_cases())
CASES = list(cli._generator_cases())


def test_the_generator_zoo_has_78_cases_in_both_packages():
    assert len(REF_CASES) == len(CASES) == 78
    assert [c[0] for c in REF_CASES] == [c[0] for c in CASES]


@pytest.mark.parametrize("i", range(len(REF_CASES)), ids=[c[0] for c in REF_CASES])
def test_generator_case_verified_as_the_reference(i):
    (label, ref_sched, ref_groups), (label2, sched, groups) = REF_CASES[i], CASES[i]
    assert label == label2 and groups == ref_groups
    assert sched.fingerprint() == ref_sched.fingerprint()
    got = verify.verify_schedule(sched, groups=groups)
    assert _verdict(got) == _verdict(ref_verify.verify_schedule(ref_sched, groups=ref_groups))
    assert got.ok and got.verifiable
    assert _simulated(sim, sched) == _simulated(ref_sim, ref_sched)


@pytest.mark.parametrize("n", (4, 8, 16))
def test_swing_is_unverifiable_in_both(n):
    for make in ("swing_reduce_scatter", "swing_all_reduce"):
        sched, ref_sched = getattr(S, make)(n, D), getattr(ref_S, make)(n, D)
        assert sched.fingerprint() == ref_sched.fingerprint()
        got = verify.verify_schedule(sched)
        assert _verdict(got) == _verdict(ref_verify.verify_schedule(ref_sched))
        assert not got.verifiable
        with pytest.raises(verify.UnverifiableScheduleError) as e:
            verify.assert_verified(sched)
        with pytest.raises(ref_verify.UnverifiableScheduleError) as ref_e:
            ref_verify.assert_verified(ref_sched)
        assert str(e.value) == str(ref_e.value)


@pytest.mark.parametrize("tp,dp", [(2, 2), (4, 2), (2, 4), (4, 4)])
def test_replicate_groups_verified_and_wrong_axis_caught_as_the_reference(tp, dp):
    n = tp * dp
    for mod, vmod in ((S, verify), (ref_S, ref_verify)):
        tp_groups, dp_groups = mod.mesh_groups(tp, dp)
        rep = mod.replicate_groups(mod.ring_all_reduce(tp, D), tp_groups, n)
        assert vmod.verify_schedule(rep, groups=tp_groups).ok
    got = verify.verify_schedule(
        S.replicate_groups(S.ring_all_reduce(tp, D), S.mesh_groups(tp, dp)[0], n),
        groups=S.mesh_groups(tp, dp)[1])
    want = ref_verify.verify_schedule(
        ref_S.replicate_groups(ref_S.ring_all_reduce(tp, D), ref_S.mesh_groups(tp, dp)[0], n),
        groups=ref_S.mesh_groups(tp, dp)[1])
    assert _verdict(got) == _verdict(want) and not got.ok
    assert any(v.kind == "cross-group-transfer" for v in got.violations)


# ---------------------------------------------------------------- mutants
#
# The operators of tests/test_verify_mutations.py, taking the package whose
# Round / Transfer / Schedule they rebuild with.


def _rebuild(mod, base, rounds):
    rounds = tuple(r for r in rounds if r.transfers)
    return mod.Schedule(base.collective, base.algorithm, base.n, base.buffer_bytes, rounds)


def _pick(rng, sched):
    ri = rng.randrange(len(sched.rounds))
    return ri, rng.randrange(len(sched.rounds[ri].transfers))


def mut_drop_transfer(mod, rng, sched):
    ri, ti = _pick(rng, sched)
    rounds = list(sched.rounds)
    tf = rounds[ri].transfers
    rounds[ri] = mod.Round(tf[:ti] + tf[ti + 1:], rounds[ri].size)
    return _rebuild(mod, sched, rounds)


def mut_swap_peer(mod, rng, sched):
    ri, ti = _pick(rng, sched)
    rounds = list(sched.rounds)
    tf = list(rounds[ri].transfers)
    t = tf[ti]
    new_dst = rng.choice([r for r in range(sched.n) if r not in (t.src, t.dst)])
    tf[ti] = mod.Transfer(t.src, new_dst, t.chunks, t.reduce)
    rounds[ri] = mod.Round(tuple(tf), rounds[ri].size)
    return _rebuild(mod, sched, rounds)


def mut_dup_contribution(mod, rng, sched):
    ri, ti = _pick(rng, sched)
    rounds = list(sched.rounds)
    tf = rounds[ri].transfers
    rounds[ri] = mod.Round(tf + (tf[ti],), rounds[ri].size)
    return _rebuild(mod, sched, rounds)


def mut_reorder_rounds(mod, rng, sched):
    if len(sched.rounds) < 2:
        return sched
    i = rng.randrange(len(sched.rounds) - 1)
    rounds = list(sched.rounds)
    rounds[i], rounds[i + 1] = rounds[i + 1], rounds[i]
    return _rebuild(mod, sched, rounds)


def mut_flip_reduce(mod, rng, sched):
    ri, ti = _pick(rng, sched)
    rounds = list(sched.rounds)
    tf = list(rounds[ri].transfers)
    t = tf[ti]
    tf[ti] = mod.Transfer(t.src, t.dst, t.chunks, not t.reduce)
    rounds[ri] = mod.Round(tuple(tf), rounds[ri].size)
    return _rebuild(mod, sched, rounds)


def mut_chunk_relabel(mod, rng, sched):
    ri, ti = _pick(rng, sched)
    rounds = list(sched.rounds)
    tf = list(rounds[ri].transfers)
    t = tf[ti]
    if not t.chunks:
        return sched
    n_chunks = max(c for rnd in sched.rounds for x in rnd.transfers for c in x.chunks) + 1
    chunks = list(t.chunks)
    ci = rng.randrange(len(chunks))
    chunks[ci] = (chunks[ci] + 1 + rng.randrange(n_chunks - 1)) % n_chunks
    tf[ti] = mod.Transfer(t.src, t.dst, tuple(dict.fromkeys(chunks)), t.reduce)
    rounds[ri] = mod.Round(tuple(tf), rounds[ri].size)
    return _rebuild(mod, sched, rounds)


def mut_drop_round(mod, rng, sched):
    if len(sched.rounds) < 2:
        return sched
    i = rng.randrange(len(sched.rounds))
    return _rebuild(mod, sched, sched.rounds[:i] + sched.rounds[i + 1:])


OPERATORS = [mut_drop_transfer, mut_swap_peer, mut_dup_contribution, mut_reorder_rounds,
             mut_flip_reduce, mut_chunk_relabel, mut_drop_round]


def _bases(mod):
    return [mod.ring_reduce_scatter(8, D), mod.ring_all_gather(8, D), mod.ring_all_reduce(4, D),
            mod.rhd_reduce_scatter(8, D), mod.rhd_all_reduce(4, D), mod.dex_all_to_all(8, D),
            mod.direct_all_to_all(8, D), mod.bucket_reduce_scatter((2, 4), D)]


def _mutants(mod, seed=20260807, per_pair=4):
    """The mutation suite's corpus, every (base, operator) pair in order,
    no-op mutants included (their fingerprint equals the base's)."""
    rng = random.Random(seed)
    return [(b, op.__name__, op(mod, rng, base))
            for b, base in enumerate(_bases(mod)) for op in OPERATORS for _ in range(per_pair)]


REF_MUTANTS = _mutants(ref_S)
MUTANTS = _mutants(S)


@pytest.mark.parametrize("b", range(8))
@pytest.mark.parametrize("op", [op.__name__ for op in OPERATORS])
def test_mutants_judged_as_the_reference(b, op):
    pairs = [(m, r) for m, r in zip(MUTANTS, REF_MUTANTS) if m[0] == b and m[1] == op]
    assert len(pairs) == 4
    for (_, _, m), (_, _, ref_m) in pairs:
        assert m.fingerprint() == ref_m.fingerprint()
        assert _verdict(verify.verify_schedule(m)) == _verdict(ref_verify.verify_schedule(ref_m))
        assert ([str(v) for v in inv.check_round_feasibility(m)]
                == [str(v) for v in ref_inv.check_round_feasibility(ref_m)])
        assert _simulated(sim, m) == _simulated(ref_sim, ref_m)


def test_mutation_kill_rate_as_the_suite_requires():
    """The bar of tests/test_verify_mutations.py on the port's corpus: the
    verifier with round feasibility kills >= 95 % of the non-equivalent
    mutants, the verifier alone >= 85 %, and no survivor is unexplained."""
    mutants = [(b, op, m) for b, op, m in MUTANTS if m.fingerprint() != _bases(S)[b].fingerprint()]
    assert len(mutants) >= 150
    killed = feasibility = 0
    equivalent, unexplained = [], []
    for b, op, m in mutants:
        if not verify.verify_schedule(m).ok:
            killed += 1
        elif inv.check_round_feasibility(m):
            feasibility += 1
        elif _simulated(sim, m)[1:] == ("holds",):
            equivalent.append((m.algorithm, op))
        else:
            unexplained.append((m.algorithm, op))
    assert not unexplained
    assert all(alg == "direct" and op == "mut_reorder_rounds" for alg, op in equivalent)
    denom = len(mutants) - len(equivalent)
    assert (killed + feasibility) / denom >= 0.95 and killed / denom >= 0.85


def test_violations_are_attributable_as_the_reference():
    def corrupt(mod):
        base = mod.ring_reduce_scatter(8, D)
        rounds = list(base.rounds)
        rounds[3] = mod.Round(rounds[3].transfers[:-1], rounds[3].size)
        return mod.Schedule(base.collective, base.algorithm, base.n, base.buffer_bytes,
                            tuple(rounds))

    got = verify.verify_schedule(corrupt(S))
    assert _verdict(got) == _verdict(ref_verify.verify_schedule(corrupt(ref_S)))
    v = got.violations[0]
    assert not got.ok and v.rank is not None and v.chunk is not None
    with pytest.raises(verify.ScheduleVerificationError) as e:
        verify.assert_verified(corrupt(S))
    with pytest.raises(ref_verify.ScheduleVerificationError) as ref_e:
        ref_verify.assert_verified(corrupt(ref_S))
    assert str(e.value) == str(ref_e.value)


# ------------------------------------------------------ the PCCL_VERIFY hook


def _relabelled(mod=S):
    """ring_reduce_scatter(8) with round 0's first transfer carrying another
    chunk: every round still a permutation with distinct receive slots, so
    it compiles, but the collective's postcondition fails."""
    base = mod.ring_reduce_scatter(8, D)
    rounds = list(base.rounds)
    tf = list(rounds[0].transfers)
    t = tf[0]
    tf[0] = mod.Transfer(t.src, t.dst, ((t.chunks[0] + 3) % 8,), t.reduce)
    rounds[0] = mod.Round(tuple(tf), rounds[0].size)
    return mod.Schedule(base.collective, base.algorithm, base.n, base.buffer_bytes, tuple(rounds))


def _cache_sizes():
    return len(exec_engine._COMPILED), len(exec_engine._DEVICE_TABLES)


@pytest.fixture
def clean_caches():
    exec_engine.clear_exec_caches()
    yield
    exec_engine.clear_exec_caches()


def test_a_bad_schedule_raises_before_compiling_and_no_cache_grows(clean_caches, monkeypatch):
    bad = _relabelled()
    assert not verify.verify_schedule(bad).ok
    monkeypatch.setenv("PCCL_VERIFY", "1")
    ok = exec_engine.compile_schedule(S.ring_all_reduce(8, D))
    exec_engine.device_tables(ok, torch.device("cpu"))
    before = _cache_sizes()
    with pytest.raises(verify.ScheduleVerificationError) as e:
        exec_engine.compile_schedule(bad)
    assert _cache_sizes() == before == (1, 1)
    with pytest.raises(ref_verify.ScheduleVerificationError) as ref_e:
        ref_verify.assert_verified(_relabelled(ref_S))
    assert str(e.value) == str(ref_e.value)
    # the same schedule compiles without the hook: the verifier caught it
    monkeypatch.setenv("PCCL_VERIFY", "0")
    assert exec_engine.compile_schedule(bad).fingerprint == bad.fingerprint()


def test_the_variable_is_read_only_on_a_miss(clean_caches, monkeypatch):
    bad = _relabelled()
    monkeypatch.delenv("PCCL_VERIFY", raising=False)
    compiled = exec_engine.compile_schedule(bad)  # a miss, no hook: cached
    monkeypatch.setenv("PCCL_VERIFY", "1")
    assert exec_engine.compile_schedule(bad) is compiled  # a hit: nothing read, nothing run

    reads = []
    real_get = exec_engine.os.environ.get

    def counting_get(key, *default):
        reads.append(key)
        return real_get(key, *default)

    monkeypatch.setattr(exec_engine.os.environ, "get", counting_get)
    exec_engine.compile_schedule(bad)
    assert reads == []
    exec_engine.compile_schedule(S.ring_all_gather(8, D))
    assert reads == ["PCCL_VERIFY"]


@pytest.mark.parametrize("value,verifies", [("1", True), ("0", False), ("", False), ("yes", True)])
def test_which_values_turn_the_hook_on(clean_caches, monkeypatch, value, verifies):
    monkeypatch.setenv("PCCL_VERIFY", value)
    if verifies:
        with pytest.raises(verify.ScheduleVerificationError):
            exec_engine.compile_schedule(_relabelled())
    else:
        exec_engine.compile_schedule(_relabelled())


@pytest.mark.parametrize("coll,algo", [("all_reduce", "ring"), ("all_reduce", "rhd"),
                                       ("reduce_scatter", "rhd"), ("all_gather", "ring"),
                                       ("all_to_all", "dex"), ("all_to_all", "direct")])
def test_verified_collectives_bit_identical_to_the_vmap_oracle(clean_caches, monkeypatch,
                                                               coll, algo):
    n = 8
    monkeypatch.setenv("PCCL_VERIFY", "1")
    calls = []
    real = verify.assert_verified

    def counted(schedule, **kw):
        calls.append(schedule.fingerprint())
        return real(schedule, **kw)

    monkeypatch.setattr(verify, "assert_verified", counted)
    rng = np.random.default_rng(len(coll) * 10 + len(algo))
    x = rng.normal(size=(n, 5 if coll == "all_gather" else 6 * n, 3)).astype(np.float32)
    local = x[0].size * x.itemsize
    nbytes = local * n if coll == "all_gather" else local
    comm = PcclSession(cm.H100_DGX, device="cpu").communicator("x", n, algorithm=algo)
    got = getattr(comm, coll)(torch.from_numpy(x)).numpy()
    ref_comm = RefSession(ref_cm.H100_DGX).communicator("x", n, algorithm=algo)
    sched = ref_comm.axis_schedule(coll, nbytes)
    want = np.asarray(jax.vmap(lambda xl: ref_prims.run_reference(coll, xl, sched, "x"),
                               axis_name="x")(jnp.asarray(x)))
    assert comm.axis_schedule(coll, nbytes).fingerprint() == sched.fingerprint()
    # all_to_all takes the compact slot-addressed compile, which, as in the
    # reference (exec_engine.compile_all_to_all), bypasses the hook
    assert calls == ([] if coll == "all_to_all" else [sched.fingerprint()])
    np.testing.assert_array_equal(got, want)
