"""The port's planned collectives against the JAX package, on the CPU.

Inputs come from a numpy seed and go through both packages.  The oracle is
the reference's per-round interpreter under ``jax.vmap`` (``axis_name="x"``),
which runs the rank-stacked operand in one process; for split communicators
it is the reference communicator's own grouped path under the same vmap.
Tolerances: fp32 collectives are **bit-identical** (same gathers, same add
order per receiver); ``ring_ef8`` is bit-identical to the reference's
quantized engine and within ``compressed_ef_error_bound`` of the exact sum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.api import PcclSession as RefSession
from repro.comm import fusion as ref_fusion
from repro.comm import pccl_collectives as ref_pc
from repro.comm import primitives as ref_prims
from repro.core import cost_model as ref_cm
from repro_torch.api import NativeBackend, PcclSession, SimBackend
from repro_torch.comm import ScheduleExecutionError, exec_engine
from repro_torch.comm import pccl_collectives as pc
from repro_torch.comm import primitives as prims
from repro_torch.core import cost_model as cm

ALGOS = {
    "reduce_scatter": ("ring", "rhd", "bucket2d"),
    "all_gather": ("ring", "rhd", "bucket2d"),
    "all_reduce": ("ring", "rhd", "bucket2d"),
    "all_to_all": ("dex", "direct", "ring"),
}


def _cases():
    for n in (4, 8):
        for coll, algos in ALGOS.items():
            for algo in algos:
                for split in (False, True):
                    # bucket2d has no usable torus for the 2-rank groups
                    if split and n == 4 and algo == "bucket2d":
                        continue
                    yield n, coll, algo, split


def _comms(n, algo, split, **kw):
    ref = RefSession(ref_cm.H100_DGX).communicator("x", n, algorithm=algo, **kw)
    port = PcclSession(cm.H100_DGX, device="cpu").communicator(
        "x", n, algorithm=algo, **kw
    )
    if split:
        colors = [r % 2 for r in range(n)]
        ref, port = ref.split(colors), port.split(colors)
    return ref, port


def _operand(rng, n, m, coll):
    rows = 5 if coll == "all_gather" else 6 * m
    return rng.normal(size=(n, rows, 3)).astype(np.float32)


def _nbytes(coll, x, m):
    local = x[0].size * x.itemsize
    return local * m if coll == "all_gather" else local


def _oracle(ref_comm, coll, x):
    """The reference's result on the rank-stacked operand, under vmap."""
    if ref_comm.groups is not None:
        fn = getattr(ref_comm, coll)
    else:
        sched = ref_comm.axis_schedule(coll, _nbytes(coll, x, ref_comm.n))

        def fn(xl):
            return ref_prims.run_reference(coll, xl, sched, "x")

    return np.asarray(jax.vmap(fn, axis_name="x")(jnp.asarray(x)))


@pytest.mark.parametrize("n,coll,algo,split", list(_cases()))
def test_interp_bit_identical_to_reference(n, coll, algo, split):
    rng = np.random.default_rng(n * 100 + len(coll) + len(algo))
    ref_comm, comm = _comms(n, algo, split)
    x = _operand(rng, n, comm.n, coll)
    want = _oracle(ref_comm, coll, x)
    got = getattr(comm, coll)(torch.from_numpy(x)).numpy()
    assert comm.axis_schedule(coll, _nbytes(coll, x, comm.n)).algorithm == algo
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # tolerance: bit-identical


@pytest.mark.parametrize(
    "n,coll,algo", sorted({(n, c, a) for n, c, a, _ in _cases()})
)
def test_engine_bit_identical_to_own_reference(n, coll, algo):
    """The compiled engine against the port's per-round interpreter."""
    rng = np.random.default_rng(7)
    _, comm = _comms(n, algo, False)
    x = torch.from_numpy(_operand(rng, n, n, coll))
    sched = comm.axis_schedule(coll, _nbytes(coll, x.numpy(), n))
    got = getattr(prims, coll)(x, sched)
    want = prims.run_reference(coll, x, sched)
    assert torch.equal(got, want)
    if coll == "all_to_all":
        assert torch.equal(prims.all_to_all_dense(x, sched), want)


def test_all_reduce_pads_to_multiple_of_n():
    """A flat size not divisible by n is zero-padded, as in the reference."""
    rng = np.random.default_rng(3)
    _, comm = _comms(4, "ring", False)
    x = rng.normal(size=(4, 7, 3)).astype(np.float32)  # 21 % 4 != 0
    got = comm.all_reduce(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(x.sum(0), x.shape), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
def test_ring_ef8_matches_reference_and_bound(n, split):
    rng = np.random.default_rng(11 + n)
    ref_comm, comm = _comms(n, "ring_ef8", split)
    m = comm.n
    x = rng.normal(size=(n, m * 10, 3)).astype(np.float32)
    if split:
        want = jax.vmap(ref_comm.all_reduce, axis_name="x")(jnp.asarray(x))
    else:
        sched = ref_comm.axis_schedule("all_reduce", x[0].size * 4)
        want = jax.vmap(
            lambda xl: ref_fusion.all_reduce_quantized(xl, sched, "x"), axis_name="x"
        )(jnp.asarray(x))
    got = comm.all_reduce(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))  # bit-identical
    # tolerance: |out - exact| <= bound(m) * m * max|x| (cost_model docstring)
    groups = comm.groups or (tuple(range(n)),)
    bound = cm.compressed_ef_error_bound(m)
    for g in groups:
        exact = x[list(g)].sum(0)
        A = np.abs(x[list(g)]).max()
        assert np.abs(got[list(g)] - exact).max() <= bound * m * A


def test_ring_ef8_chosen_under_tolerance_at_main_path_size():
    session = PcclSession(cm.H100_DGX, device="cpu")
    comm = session.communicator("x", 8, rel_error_tol=cm.compressed_ef_error_bound(8))
    assert comm.chosen_algorithm("all_reduce", 96 * 2**20) == "ring_ef8"


@pytest.mark.parametrize("n", [4, 8])
def test_compressed_all_reduce_bit_identical(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, n * 12)).astype(np.float32)
    # jit: the reference runs compiled inside shard_map, where XLA folds
    # the division by 127 into a multiply by its reciprocal
    want = jax.jit(jax.vmap(
        lambda xl: ref_pc.compressed_all_reduce(xl, "x", n), axis_name="x"
    ))(jnp.asarray(x))
    got = pc.compressed_all_reduce(torch.from_numpy(x), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [4, 8])
def test_compressed_all_reduce_ef(n):
    rng = np.random.default_rng(20 + n)
    x = rng.normal(size=(n, n * 12)).astype(np.float32)
    r = (rng.normal(size=(n, n * 12)) * 0.01).astype(np.float32)

    def ref_ef(xl, rl):
        y, st = ref_pc.compressed_all_reduce_ef(xl, ref_pc.ErrorFeedbackState(rl), "x", n)
        return y, st.residual

    want_y, want_r = jax.jit(jax.vmap(ref_ef, axis_name="x"))(jnp.asarray(x), jnp.asarray(r))
    ef = pc.ErrorFeedbackState(torch.from_numpy(r))
    y, ef2 = pc.compressed_all_reduce_ef(torch.from_numpy(x), ef, n)
    np.testing.assert_array_equal(y.numpy(), np.asarray(want_y))  # bit-identical
    # tolerance 1 ulp of the target: XLA contracts target - q*scale into
    # one FMA, the port rounds the product first
    target = x + r
    ulp = np.spacing(np.abs(target).max(axis=1, keepdims=True)).astype(np.float32)
    assert (np.abs(ef2.residual.numpy() - np.asarray(want_r)) <= ulp).all()
    init = pc.ErrorFeedbackState.init((n, 4), device="cpu")
    assert init.residual.shape == (n, 4) and not init.residual.any()


def test_quantize_scale_is_per_rank():
    x = torch.tensor([[1.0, -2.0], [100.0, 50.0]])
    q, s = pc._quantize(x)
    assert s.shape == (2, 1)
    np.testing.assert_array_equal(q.numpy(), [[64, -127], [127, 64]])


@pytest.mark.parametrize("coll", sorted(ALGOS))
@pytest.mark.parametrize("split", [False, True], ids=["full", "split"])
def test_native_backend_agrees_with_interp(coll, split):
    """The A/B baseline: tolerance fp32 1e-5 (sums in another order)."""
    rng = np.random.default_rng(5)
    _, comm = _comms(8, "auto", split)
    x = torch.from_numpy(_operand(rng, 8, comm.n, coll))
    want = getattr(comm, coll)(x)
    got = getattr(NativeBackend(), coll)(comm, x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sim_backend_shapes_and_time():
    session = PcclSession(cm.H100_DGX, device="cpu")
    comm = session.communicator("x", 4, backend=SimBackend())
    x = torch.zeros(4, 8, 2)
    assert comm.all_reduce(x) is x
    assert comm.reduce_scatter(x).shape == (4, 2, 2)
    assert comm.all_gather(x).shape == (4, 32, 2)
    assert comm.all_to_all(x).shape == x.shape
    assert comm.sim_elapsed_s > 0 and len(comm.backend.events) == 4
    with pytest.raises(ScheduleExecutionError, match="not divisible"):
        comm.reduce_scatter(torch.zeros(4, 7, 2))


def test_operand_on_another_device_raises():
    comm = PcclSession(cm.H100_DGX, device="cpu").communicator("x", 4)
    with pytest.raises(ScheduleExecutionError, match="lies on meta"):
        comm.all_reduce(torch.empty(4, 8, device="meta"))
    with pytest.raises(ScheduleExecutionError, match="global"):
        comm.all_reduce(torch.zeros(3, 8))


def test_device_tables_uploaded_once():
    exec_engine.clear_exec_caches()
    comm = PcclSession(cm.H100_DGX, device="cpu").communicator("x", 8, algorithm="ring")
    x = torch.ones(8, 16, 2)
    comm.all_reduce(x)
    first = exec_engine.exec_stats()
    comm.all_reduce(x)
    second = exec_engine.exec_stats()
    assert second.device_table_misses == first.device_table_misses
    assert second.device_table_hits > first.device_table_hits


def test_repeated_receive_slot_raises_at_compile():
    from repro_torch.core.schedules import Round, Schedule, Transfer

    rnd = Round(
        transfers=(
            Transfer(0, 1, chunks=(0, 0), reduce=True),
            Transfer(1, 0, chunks=(1, 1), reduce=True),
        ),
        size=1.0,
    )
    sched = Schedule("all_reduce", "bad", 2, 2.0, (rnd,))
    with pytest.raises(ScheduleExecutionError, match="with repeats"):
        exec_engine.compile_schedule(sched)
