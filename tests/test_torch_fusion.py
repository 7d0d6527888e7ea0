"""The port's fusion seams against the JAX package, on the CPU.

* Fused matmul → reduce-scatter and fused all-reduce → RMSNorm against the
  reference's unfused composition under ``jax.vmap``: the Pallas kernel in
  interpret mode, then the traced collective.  Tolerance: kernel tolerance,
  fp32 2e-5 and bf16 2e-2 (rtol and atol).
* The fused result against the port's own unfused result: bit for bit.
* The routing (fused or fallback) and its counters.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.comm import exec_engine as ref_engine
from repro.comm import fusion as ref_fusion
from repro.comm import primitives as ref_prims
from repro.core import schedules as ref_S
from repro.kernels.matmul.kernel import matmul_pallas
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro_torch.api import PcclSession
from repro_torch.comm import exec_engine, fusion
from repro_torch.convert import from_reference
from repro_torch.core import cost_model as cm
from repro_torch.core import schedules as S
from repro_torch.kernels.rmsnorm import rmsnorm

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _comm(n, algorithm="ring"):
    return PcclSession(cm.H100_DGX, device="cpu").communicator("x", n, algorithm=algorithm)


def _stats():
    s = exec_engine.exec_stats()
    return s.fused_dispatches, s.fallback_dispatches


def _to_torch(ja):
    """The same values as a torch tensor of the same dtype (exact)."""
    t = torch.from_numpy(np.array(ja.astype(jnp.float32)))
    return t.to(torch.bfloat16) if ja.dtype == jnp.bfloat16 else t


def _mm_inputs(n, M, K, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, M, K)).astype(np.float32)
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    jx, jw = jnp.asarray(x, DTYPES[dtype]), jnp.asarray(w, DTYPES[dtype])
    tw = from_reference({"w": np.asarray(jw)}, device="cpu")["w"]
    return jx, jw, _to_torch(jx), tw


# ------------------------------------------------------- stream programs
@pytest.mark.parametrize("sched_fn", [
    lambda S_, n: S_.ring_reduce_scatter(n, 1024.0),
    lambda S_, n: S_.rhd_reduce_scatter(n, 1024.0),
    lambda S_, n: S_.ring_all_reduce(n, 1024.0),
    lambda S_, n: S_.ring_all_gather(n, 1024.0),
], ids=["ring_rs", "rhd_rs", "ring_ar", "ring_ag"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_stream_program_matches_reference(sched_fn, n):
    ref = ref_fusion.stream_program(ref_engine.compile_schedule(sched_fn(ref_S, n)))
    got = fusion.stream_program(exec_engine.compile_schedule(sched_fn(S, n)))
    assert (ref is None) == (got is None)
    if got is not None:
        assert got.perm == ref.perm
        for f in ("order", "send", "recv"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


# ---------------------------------------------- matmul → reduce-scatter
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_mm_rs_matches_reference_composition(n, dtype):
    Mc, K, N, blk = 16, 64, 32, 16
    M = n * Mc
    jx, jw, tx, tw = _mm_inputs(n, M, K, N, dtype)
    comm = _comm(n)
    sched_bytes = float(M) * N * tx.element_size()
    ref_sched = ref_S.get_schedule("reduce_scatter", "ring", n, sched_bytes)

    def ref_unfused(xl):
        y = matmul_pallas(xl, jw, block_m=blk, block_n=blk, block_k=blk, interpret=True)
        return ref_prims.reduce_scatter(y, ref_sched, "x")

    want = jax.vmap(ref_unfused, axis_name="x")(jx)
    assert comm.axis_schedule("reduce_scatter", sched_bytes).fingerprint() == ref_sched.fingerprint()
    f0, b0 = _stats()
    got = fusion.fused_matmul_reduce_scatter(comm, tx, tw, block_m=blk, block_n=blk, block_k=blk)
    assert _stats() == (f0 + 1, b0)
    assert got.shape == (n, Mc, N) and got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))
    unfused = fusion._unfused_matmul_reduce_scatter(comm, tx, tw, blocks=(blk, blk, blk))
    assert torch.equal(got, unfused)  # bit for bit


@pytest.mark.parametrize("case", ["grouped", "rows_not_divisible", "blocks_do_not_tile", "no_stream_program"])
def test_fused_mm_rs_fallbacks(case):
    n, K, N, blk = 4, 32, 16, 16
    M = n * 16
    comm = _comm(n)
    if case == "grouped":
        comm = comm.split([r % 2 for r in range(n)])
    elif case == "rows_not_divisible":
        M = n * 16 + 2
    elif case == "blocks_do_not_tile":
        K = 40
    else:
        comm = _comm(n, algorithm="rhd")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(n, M, K)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    if case == "rows_not_divisible":
        with pytest.raises(Exception, match="not divisible"):
            fusion.fused_matmul_reduce_scatter(comm, x, w, block_m=blk, block_n=blk, block_k=blk)
        return
    f0, b0 = _stats()
    got = fusion.fused_matmul_reduce_scatter(comm, x, w, block_m=blk, block_n=blk, block_k=blk)
    assert _stats() == (f0, b0 + 1)
    y = torch.einsum("smk,kn->smn", x, w)
    want = comm.reduce_scatter(y)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fused_mm_rs_checks_operands():
    comm = _comm(4)
    with pytest.raises(Exception, match="global"):
        fusion.fused_matmul_reduce_scatter(comm, torch.zeros(3, 8, 4), torch.zeros(4, 2))
    with pytest.raises(Exception, match="weight shape"):
        fusion.fused_matmul_reduce_scatter(comm, torch.zeros(4, 8, 4), torch.zeros(5, 2))
    with pytest.raises(Exception, match="lies on meta"):
        fusion.fused_matmul_reduce_scatter(
            comm, torch.zeros(4, 8, 4, device="meta"), torch.zeros(4, 2)
        )


# ------------------------------------------------ all-reduce → RMSNorm
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("algorithm", ["auto", "ring"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_ar_rmsnorm_matches_reference_composition(n, algorithm, dtype):
    rng = np.random.default_rng(n)
    d = 48
    x = rng.normal(size=(n, 2 * n, d)).astype(np.float32)
    gamma = (rng.normal(size=d) + 1.0).astype(np.float32)
    jx = jnp.asarray(x, DTYPES[dtype])
    comm = _comm(n, algorithm)
    tx = _to_torch(jx)
    tg = from_reference({"gamma": gamma}, device="cpu")["gamma"]
    local = x[0].size
    sched = comm.axis_schedule("all_reduce", float(local) * tx.element_size())
    ref_sched = ref_S.get_schedule(
        "all_reduce", sched.algorithm, n, sched.buffer_bytes,
        dims=(2, n // 2) if sched.algorithm == "bucket2d" else None,
    )
    assert ref_sched.fingerprint() == sched.fingerprint()

    def ref_unfused(xl):
        red = ref_prims.all_reduce(xl.reshape(-1), ref_sched, "x").reshape(xl.shape)
        return rmsnorm_pallas(red, jnp.asarray(gamma), eps=1e-5, interpret=True)

    want = jax.vmap(ref_unfused, axis_name="x")(jx)
    f0, b0 = _stats()
    got = fusion.fused_all_reduce_rmsnorm(comm, tx, tg, eps=1e-5)
    assert _stats() == (f0 + 1, b0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **_tol(dtype))
    unfused = rmsnorm(comm.all_reduce(tx), tg, eps=1e-5)
    assert torch.equal(got, unfused)  # bit for bit


def test_fused_ar_rmsnorm_fallbacks():
    rng = np.random.default_rng(9)
    gamma = torch.ones(6)
    for comm, shape in [
        (_comm(4).split([0, 1, 0, 1]), (4, 4, 6)),  # grouped
        (_comm(4), (4, 1, 6)),                     # 6 % 4 != 0: padded all_reduce
    ]:
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        f0, b0 = _stats()
        got = fusion.fused_all_reduce_rmsnorm(comm, x, gamma)
        assert _stats() == (f0, b0 + 1)
        assert torch.equal(got, rmsnorm(comm.all_reduce(x), gamma))
    with pytest.raises(Exception, match="gamma shape"):
        fusion.fused_all_reduce_rmsnorm(_comm(4), torch.zeros(4, 4, 6), torch.ones(5))


# ---------------------------------------------------------------- convert
def test_from_reference_carries_bits_and_checks_names():
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(8, 4)), jnp.bfloat16)
    g = rng.normal(size=8).astype(np.float32)
    r = rng.normal(size=(4, 16)).astype(np.float32)
    out = from_reference({"w": np.asarray(w), "gamma": g, "residual": r}, device="cpu")
    assert out["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["w"].view(torch.int16).numpy(), np.asarray(w).view(np.int16)
    )
    np.testing.assert_array_equal(out["gamma"].numpy(), g)
    np.testing.assert_array_equal(out["residual"].numpy(), r)
    with pytest.raises(KeyError, match="unknown parameter"):
        from_reference({"bias": g}, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        from_reference({"gamma": r}, device="cpu")
