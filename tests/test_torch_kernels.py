"""The port's kernels K1 (matmul) and K2 (RMSNorm) against the JAX package.

On the CPU the port's entry points run each kernel's plain version; it is
held against the reference's Pallas kernel in interpret mode on the same
numpy inputs, at the shapes of ``tests/test_kernels.py``.  Tolerances as
there: fp32 2e-5, bf16 2e-2 (rtol and atol).  The CUDA kernels themselves
run only on a card: ``tests/test_torch_cuda.py`` holds those tests.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.matmul.kernel import matmul_pallas
from repro.kernels.matmul.ops import tiles_exactly as ref_tiles_exactly
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro_torch.kernels.matmul import matmul, matmul_cuda, matmul_reference, tiles_exactly
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference, rmsnorm_triton

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _both(a, name):
    """The same numpy values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# --------------------------------------------------------------------- K1
@pytest.mark.parametrize("M,K,N,blocks", [
    (128, 128, 128, (128, 128, 128)),
    (256, 384, 128, (128, 128, 128)),   # K > bk: three accumulation slices
    (64, 256, 512, (32, 256, 64)),
    (512, 64, 96, (128, 32, 32)),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_matches_pallas(M, K, N, blocks, dtype):
    rng = np.random.default_rng(0)
    bm, bn, bk = blocks
    jx, tx = _both(rng.normal(size=(M, K)).astype(np.float32), dtype)
    jw, tw = _both(rng.normal(size=(K, N)).astype(np.float32), dtype)
    want = matmul_pallas(jx, jw, block_m=bm, block_n=bn, block_k=bk, interpret=True)
    got = matmul(tx, tw, block_k=bk)
    assert got.dtype == tx.dtype and got.shape == (M, N)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_matmul_plain_runs_ragged_shapes():
    """The port masks ragged edges rather than refusing them."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(70, 130)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(130, 33)).astype(np.float32))
    torch.testing.assert_close(matmul(x, w), x @ w, rtol=2e-5, atol=2e-5)


def test_matmul_row_chunks_bit_identical_on_cpu():
    """Per-chunk calls equal one whole-M call (the fusion contract)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(8 * 16, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 32)).astype(np.float32))
    whole = matmul(x, w, block_k=16)
    chunks = torch.cat([matmul(c, w, block_k=16) for c in x.split(16)])
    assert torch.equal(whole, chunks)


@pytest.mark.parametrize("x_shape,w_shape,match", [
    ((4, 8, 2), (8, 2), "need"),
    ((4, 8), (7, 2), "need"),
    ((0, 8), (8, 2), "empty"),
    ((4, 8), (8, 0), "empty"),
])
def test_matmul_preconditions(x_shape, w_shape, match):
    with pytest.raises(ValueError, match=match):
        matmul(torch.zeros(x_shape), torch.zeros(w_shape))


def test_matmul_refuses_other_devices_and_dtypes():
    with pytest.raises(ValueError, match="CUDA"):
        matmul(torch.zeros(4, 4, device="meta"), torch.zeros(4, 4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(torch.zeros(4, 4), torch.zeros(4, 4))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        matmul(torch.zeros(4, 4, dtype=torch.float64), torch.zeros(4, 4, dtype=torch.float64))


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (96, 64, 128), (100, 128, 128), (0, 8, 8)])
def test_tiles_exactly_matches_reference(M, K, N):
    for blocks in [dict(), dict(block_m=32, block_n=64, block_k=16)]:
        assert tiles_exactly(M, K, N, **blocks) == ref_tiles_exactly(M, K, N, **blocks)


# --------------------------------------------------------------------- K2
@pytest.mark.parametrize("shape", [(8, 64), (3, 7, 128), (1, 1024), (513, 96), (5, 100), (2, 3, 130)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.normal(size=shape).astype(np.float32), dtype)
    w = (rng.normal(size=shape[-1]) + 1.0).astype(np.float32)
    want = rmsnorm_pallas(jx, jnp.asarray(w), interpret=True)
    got = rmsnorm(tx, torch.from_numpy(w))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_rmsnorm_out_may_alias_input():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(6, 32)).astype(np.float32))
    w = torch.ones(32)
    want = rmsnorm(x, w)
    buf = x.clone()
    assert rmsnorm(buf, w, out=buf) is buf
    assert torch.equal(buf, want)


def test_rmsnorm_preconditions():
    w = torch.ones(64)
    with pytest.raises(ValueError, match="no rows"):
        rmsnorm(torch.zeros(0, 64), w)
    with pytest.raises(ValueError, match="feature dim is 0"):
        rmsnorm(torch.zeros(4, 0), torch.ones(0))
    with pytest.raises(ValueError, match="weight size"):
        rmsnorm(torch.zeros(4, 64), torch.ones(32))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm(torch.zeros(4, 64, device="meta"), torch.ones(64, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_triton(torch.zeros(4, 64), w)


def test_plain_versions_match_reference_refs():
    """The plain versions against the reference's own jnp oracles."""
    from repro.kernels.matmul.ref import matmul_reference as ref_mm
    from repro.kernels.rmsnorm.ref import rmsnorm_reference as ref_rms

    rng = np.random.default_rng(4)
    x = rng.normal(size=(64, 256)).astype(np.float32)
    w = rng.normal(size=(256, 32)).astype(np.float32)
    np.testing.assert_allclose(
        matmul_reference(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(ref_mm(jnp.asarray(x), jnp.asarray(w))), rtol=2e-5, atol=2e-5,
    )
    g = (rng.normal(size=256) + 1.0).astype(np.float32)
    np.testing.assert_allclose(
        rmsnorm_reference(torch.from_numpy(x), torch.from_numpy(g)).numpy(),
        np.asarray(ref_rms(jnp.asarray(x), jnp.asarray(g))), rtol=2e-6, atol=2e-6,
    )
