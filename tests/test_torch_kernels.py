"""The port's kernels K1–K4 against the JAX package.

On the CPU the port's entry points run each kernel's plain version; it is
held against the reference's Pallas kernel in interpret mode on the same
numpy inputs, at the shapes of ``tests/test_kernels.py``.  Tolerances as
there: fp32 2e-5, bf16 2e-2 (rtol and atol).  The CUDA kernels themselves
run only on a card: ``tests/test_torch_cuda.py`` holds those tests.
"""

import numpy as np
import pytest
from conftest import hypothesis_or_stubs

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from repro.kernels.flash.kernel import flash_attention_pallas
from repro.kernels.matmul.kernel import matmul_pallas
from repro.kernels.matmul.ops import tiles_exactly as ref_tiles_exactly
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.ssd import ref as ref_ssd
from repro.kernels.ssd.kernel import ssd_pallas
from repro_torch.kernels.build import LAUNCHES
from repro_torch.kernels.flash import attention_reference, flash_attention, flash_attention_cuda
from repro_torch.kernels.flash import tensor_core_route as flash_tc_route
from repro_torch.kernels.matmul import matmul, matmul_cuda, matmul_reference, matmul_route, tiles_exactly
from repro_torch.kernels.matmul import tensor_core_route as matmul_tc_route
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference, rmsnorm_triton
from repro_torch.kernels.ssd import ssd, ssd_cuda, ssd_decode_step, ssd_reference
from repro_torch.kernels.ssd import tensor_core_route as ssd_tc_route

given, settings, st = hypothesis_or_stubs()
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _first_matmul():
    """One plain float32 matmul before any comparison.  In a fresh process
    with several OpenMP threads, the first batched MKL product on the CPU
    can come out wrong (observed with torch 2.13.0+cpu: errors near 1e-4 in
    the first ``ssd_reference`` call, none once a plain matmul has run)."""
    torch.ones(64, 64) @ torch.ones(64, 64)


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


# --------------------------------------------------------------------- K3
@pytest.mark.parametrize("B,S,H,K,D", [
    (1, 128, 4, 4, 32),     # MHA
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 256, 4, 1, 128),    # MQA
    (2, 384, 6, 3, 64),     # non-pow2 heads
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_matches_pallas(B, S, H, K, D, dtype):
    rng = np.random.default_rng(0)
    qkv = [rng.normal(size=(B, S, h, D)).astype(np.float32) for h in (H, K, K)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in qkv)
    want = flash_attention_pallas(jq, jk, jv, causal=True, block_q=128, block_k=128, interpret=True)
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_flash_non_causal_matches_pallas():
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(rng.normal(size=(1, 128, 2, 32)).astype(np.float32), "float32") for _ in range(3)
    )
    want = flash_attention_pallas(jq, jk, jv, causal=False, interpret=True)
    got = flash_attention(tq, tk, tv, causal=False)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128), (256, 256)])
def test_flash_matches_pallas_at_every_block(bq, bk):
    """The port's result depends on no block size; Pallas's at each."""
    rng = np.random.default_rng(2)
    jq, tq = _both(rng.normal(size=(1, 256, 2, 32)).astype(np.float32), "float32")
    want = flash_attention_pallas(jq, jq, jq, causal=True, block_q=bq, block_k=bk, interpret=True)
    got = flash_attention(tq, tq, tq, causal=True)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


def test_flash_preconditions():
    q = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="aligned"):
        flash_attention(q, torch.zeros(1, 6, 2, 16), torch.zeros(1, 6, 2, 16), causal=True)
    with pytest.raises(ValueError, match="multiple of K"):
        flash_attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, q, q)
    # ragged S runs: the port masks edges instead of asserting S % block == 0
    assert flash_attention(torch.ones(1, 7, 2, 16), torch.ones(1, 7, 2, 16),
                           torch.ones(1, 7, 2, 16)).shape == (1, 7, 2, 16)


# --------------------------------------------------------------------- K4
def _ssd_arrays(rng, B, S, H, P, N, per_head=True):
    bc = (B, S, H, N) if per_head else (B, S, N)
    return (rng.normal(size=(B, S, H, P)).astype(np.float32),
            (-np.abs(rng.normal(size=(B, S, H))) * 0.3).astype(np.float32),
            (rng.normal(size=bc) * 0.3).astype(np.float32),
            (rng.normal(size=bc) * 0.3).astype(np.float32))


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (1, 128, 2, 16, 16, 32),
    (2, 96, 3, 32, 64, 32),    # padding path
    (1, 256, 4, 64, 64, 64),
    (1, 64, 1, 128, 64, 64),
])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_matches_pallas(B, S, H, P, N, chunk, dtype):
    X, la, Bm, Cm = _ssd_arrays(np.random.default_rng(0), B, S, H, P, N)
    (jX, tX), (jB, tB), (jC, tC) = (_both(a, dtype) for a in (X, Bm, Cm))
    Y, fin = ssd_pallas(jX, jnp.asarray(la), jB, jC, chunk=chunk, interpret=True)
    got_Y, got_fin = ssd(tX, torch.from_numpy(la), tB, tC, chunk=chunk)
    assert got_Y.dtype == tX.dtype and got_fin.dtype == tX.dtype
    np.testing.assert_allclose(_f32(got_Y), _f32(Y), **_tol(dtype))
    np.testing.assert_allclose(_f32(got_fin), _f32(fin), **_tol(dtype))


def test_ssd_shared_bc_matches_pallas():
    X, la, Bm, Cm = _ssd_arrays(np.random.default_rng(3), 1, 128, 2, 16, 8, per_head=False)
    Y, fin = ssd_pallas(*(jnp.asarray(a) for a in (X, la, Bm, Cm)), chunk=32, interpret=True)
    got_Y, got_fin = ssd(*(torch.from_numpy(a) for a in (X, la, Bm, Cm)), chunk=32)
    np.testing.assert_allclose(got_Y.numpy(), np.asarray(Y), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_fin.numpy(), np.asarray(fin), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_head,S", [(False, 96), (True, 100)])
def test_ssd_initial_state_matches_reference(per_head, S):
    """Pallas refuses an initial state; ``ssd_reference`` defines it."""
    rng = np.random.default_rng(4)
    X, la, Bm, Cm = _ssd_arrays(rng, 2, S, 3, 16, 8, per_head=per_head)
    init = rng.normal(size=(2, 3, 16, 8)).astype(np.float32)
    Y, fin = ref_ssd.ssd_reference(*(jnp.asarray(a) for a in (X, la, Bm, Cm)), chunk=32,
                                   initial_state=jnp.asarray(init))
    got_Y, got_fin = ssd(*(torch.from_numpy(a) for a in (X, la, Bm, Cm)), chunk=32,
                         initial_state=torch.from_numpy(init))
    np.testing.assert_allclose(got_Y.numpy(), np.asarray(Y), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got_fin.numpy(), np.asarray(fin), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ssd_decode_step_matches_reference(shared, dtype):
    rng = np.random.default_rng(5)
    B, H, P, N = 2, 3, 16, 8
    bc = (B, N) if shared else (B, H, N)
    state = rng.normal(size=(B, H, P, N)).astype(np.float32)
    x = rng.normal(size=(B, H, P)).astype(np.float32)
    la = (-np.abs(rng.normal(size=(B, H))) * 0.3).astype(np.float32)
    Bm, Cm = (rng.normal(size=bc).astype(np.float32) for _ in range(2))
    (js, ts), (jx, tx), (jB, tB), (jC, tC) = (_both(a, dtype) for a in (state, x, Bm, Cm))
    y, st = ref_ssd.ssd_decode_step(js, jx, jnp.asarray(la), jB, jC)
    got_y, got_st = ssd_decode_step(ts, tx, torch.from_numpy(la), tB, tC)
    assert got_y.dtype == tx.dtype and got_st.dtype == ts.dtype
    np.testing.assert_allclose(_f32(got_y), _f32(y), **_tol(dtype))
    np.testing.assert_allclose(_f32(got_st), _f32(st), **_tol(dtype))


def test_ssd_preconditions():
    X = torch.zeros(1, 8, 2, 4)
    la, Bm = torch.zeros(1, 8, 2), torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="la"):
        ssd(X, torch.zeros(1, 8, 3), Bm, Bm)
    with pytest.raises(ValueError, match="B/C"):
        ssd(X, la, Bm, torch.zeros(1, 8, 2, 4))
    with pytest.raises(ValueError, match="initial_state"):
        ssd(X, la, Bm, Bm, initial_state=torch.zeros(1, 2, 4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        ssd(X.to("meta"), la.to("meta"), Bm.to("meta"), Bm.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_cuda(X, la, Bm, Bm)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _bf16_pair(t):
    """``t`` as the kernel carries it in a bf16 hi + lo pair."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _ssd_tensor_core_arithmetic(X, la, Bm, Cm, init, L=64):
    """K4's tensor-core route (``ssd_sm90.cu``) in fp32 on the CPU, rounded
    to bf16 where the kernel rounds: X, B and C as they arrive, the state
    before each chunk (pass 2) and Y (pass 3); dte·B (pass 1) and W (pass 3)
    go to wgmma as bf16 hi + lo pairs."""
    import torch.nn.functional as F

    B, S, H, P = X.shape
    pad = -S % L
    X, la = F.pad(X, (0, 0, 0, 0, 0, pad)), F.pad(la, (0, 0, 0, pad))
    spec = (0, 0) * (Bm.ndim - 2) + (0, pad)
    nc = X.shape[1] // L

    def per_head(m):
        m = _bf16(F.pad(m, spec))
        m = m[:, :, None] if m.ndim == 3 else m
        return m.reshape(B, nc, L, -1, m.shape[-1]).expand(-1, -1, -1, H, -1)

    Xc, Bc, Cc = _bf16(X).reshape(B, nc, L, H, P), per_head(Bm), per_head(Cm)
    cum = torch.cumsum(la.reshape(B, nc, L, H), 2)
    total = cum[:, :, -1]
    Bd = _bf16_pair(Bc * torch.exp(total[:, :, None] - cum)[..., None])
    states = torch.einsum("bclhp,bclhn->bchpn", Xc, Bd)
    R, before = init.clone(), []
    for c in range(nc):
        before.append(_bf16(R))
        R = R * torch.exp(total[:, c])[:, :, None, None] + states[:, c]
    Y = torch.einsum("bclhn,bchpn->bclhp", Cc, torch.stack(before, 1)) * torch.exp(cum)[..., None]
    tri = torch.tril(torch.ones(L, L, dtype=torch.bool))
    dec = torch.where(tri[None, None, :, :, None], torch.exp(cum[:, :, :, None] - cum[:, :, None]), 0.0)
    W = _bf16_pair(torch.einsum("bcthn,bcshn->bctsh", Cc, Bc) * dec)
    Y = Y + torch.einsum("bctsh,bcshp->bcthp", W, Xc)
    return _bf16(Y.reshape(B, -1, H, P)[:, :S]), _bf16(R)


@pytest.mark.parametrize("per_head", [False, True])
def test_ssd_tensor_core_rounding_within_bf16_tolerance(per_head):
    """At Zamba2's P = N = L = 64, with a ragged last chunk and an initial
    state, the bf16 rounding points of K4's tensor-core route keep it
    within the bf16 tolerance of ``ssd_reference`` computed in fp32."""
    rng = np.random.default_rng(7)
    B, S, H, P, N = 2, 4 * 64 + 17, 3, 64, 64
    bc = (B, S, H, N) if per_head else (B, S, N)
    X = torch.from_numpy(rng.normal(size=(B, S, H, P)).astype(np.float32))
    la = torch.from_numpy((-rng.uniform(size=(B, S, H)) * 0.3).astype(np.float32))
    Bm, Cm = (torch.from_numpy((rng.normal(size=bc) * 0.3).astype(np.float32)) for _ in range(2))
    init = torch.from_numpy((rng.normal(size=(B, H, P, N)) * 0.1).astype(np.float32))
    assert ssd_tc_route(torch.bfloat16, P, N, 64)
    want_Y, want_fin = ssd_reference(_bf16(X), la, _bf16(Bm), _bf16(Cm), chunk=64,
                                     initial_state=init)
    got_Y, got_fin = _ssd_tensor_core_arithmetic(X, la, Bm, Cm, init)
    np.testing.assert_allclose(got_Y.numpy(), want_Y.numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_fin.numpy(), want_fin.numpy(), rtol=2e-2, atol=2e-2)


# -------------------------------------------- K1, K3 and K4 kernel routes
# On a CUDA tensor K1, K3 and K4 launch one of two hand-written kernels,
# chosen by a pure predicate: bf16 shapes the tensor-core kernel (wgmma, fed
# by TMA) takes go there, the rest to the CUDA-core kernel (fma).  The
# predicates run here; the kernels only on the card
# (tests/test_torch_cuda.py).


@pytest.mark.parametrize("dtype,K,N,want", [
    (torch.bfloat16, 3584, 12288, True),   # the fused mm+RS shape
    (torch.bfloat16, 8, 8, True),
    (torch.bfloat16, 200, 264, True),      # ragged against the 64 / 256 tiles: TMA zero-fills
    (torch.bfloat16, 100, 264, False),     # K % 8: rows of x off 16 bytes
    (torch.bfloat16, 200, 100, False),     # N % 8: rows of w off 16 bytes
    (torch.bfloat16, 36, 20, False),
    (torch.float32, 3584, 12288, False),   # fp32 stays on the CUDA cores (TF32 misses 2e-5)
    (torch.float32, 64, 64, False),
])
def test_matmul_tensor_core_route_predicate(dtype, K, N, want):
    assert matmul_tc_route(dtype, K, N) is want
    assert matmul_route((1000, K), (K, N), dtype) == ("wgmma" if want else "fma")


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 16, True),
    (torch.bfloat16, 64, True),
    (torch.bfloat16, 80, True),            # Zamba2
    (torch.bfloat16, 128, True),
    (torch.bfloat16, 72, False),           # D % 16: not a whole wgmma k-step
    (torch.bfloat16, 8, False),
    (torch.bfloat16, 144, False),          # beyond both kernels' 128
    (torch.float32, 80, False),            # fp32 stays on the CUDA cores
    (torch.float32, 128, False),
])
def test_flash_tensor_core_route_predicate(dtype, D, want):
    assert flash_tc_route(dtype, D) is want


@pytest.mark.parametrize("dtype,P,N,chunk,want", [
    (torch.bfloat16, 64, 64, 64, True),    # Zamba2, shared or per-head B/C alike
    (torch.bfloat16, 32, 64, 64, False),   # one wgmma m64n64 tile per product only
    (torch.bfloat16, 128, 64, 64, False),
    (torch.bfloat16, 64, 32, 64, False),
    (torch.bfloat16, 64, 64, 32, False),
    (torch.bfloat16, 64, 64, 128, False),
    (torch.float32, 64, 64, 64, False),    # fp32 stays on the CUDA cores
    (torch.float32, 128, 64, 128, False),
])
def test_ssd_tensor_core_route_predicate(dtype, P, N, chunk, want):
    assert ssd_tc_route(dtype, P, N, chunk) is want


@settings(max_examples=200, deadline=None)
@given(M=st.integers(1, 1 << 20), K=st.integers(1, 1 << 15), N=st.integers(1, 1 << 15),
       cuts=st.lists(st.integers(1, 1 << 20), max_size=8), bf16=st.booleans())
def test_matmul_route_never_depends_on_m(M, K, N, cuts, bf16):
    """The fusion invariant's guard: every row chunk of a call takes the
    route (hence the kernel, tile shape and K order) of the whole-M call."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    whole = matmul_route((M, K), (K, N), dtype)
    for rows in [M, *cuts]:
        assert matmul_route((rows, K), (K, N), dtype) == whole


@pytest.mark.parametrize("M,chunks", [(32768, 8), (300, 3), (129, 129)])
def test_matmul_route_of_fused_chunks_equals_whole(M, chunks):
    rows = -(-M // chunks)
    for dtype in (torch.bfloat16, torch.float32):
        whole = matmul_route((M, 3584), (3584, 12288), dtype)
        assert all(matmul_route((min(rows, M - r0), 3584), (3584, 12288), dtype) == whole
                   for r0 in range(0, M, rows))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cpu_tensors_take_the_plain_versions(dtype):
    """On the CPU both entry points compute their plain versions bit for bit
    and launch no kernel of either route."""
    rng = np.random.default_rng(5)
    tdt = DTYPES[dtype][1]
    x = torch.from_numpy(rng.normal(size=(96, 64)).astype(np.float32)).to(tdt)
    w = torch.from_numpy(rng.normal(size=(64, 40)).astype(np.float32)).to(tdt)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 70, h, 80)).astype(np.float32)).to(tdt)
               for h in (4, 2, 2))
    X = torch.from_numpy(rng.normal(size=(1, 70, 2, 64)).astype(np.float32)).to(tdt)
    la = torch.from_numpy(-rng.uniform(size=(1, 70, 2)).astype(np.float32))
    bc = torch.from_numpy(rng.normal(size=(1, 70, 64)).astype(np.float32)).to(tdt)
    def counts():
        return [(LAUNCHES.by_route(k), LAUNCHES.total(k)) for k in ("matmul", "flash", "ssd")]

    before = counts()
    assert torch.equal(matmul(x, w), matmul_reference(x, w))
    assert torch.equal(flash_attention(q, k, v), attention_reference(q, k, v))
    for got, want in zip(ssd(X, la, bc, bc), ssd_reference(X, la, bc, bc)):
        assert torch.equal(got, want)
    assert counts() == before


@pytest.mark.parametrize("name", ["matmul", "flash", "ssd"])
def test_tensor_core_sources_are_in_the_package(name):
    import importlib

    from repro_torch.kernels.build import SHARED_HEADERS, library_path, ptxas_report

    mod = importlib.import_module(f"repro_torch.kernels.{name}.kernel")
    assert set(mod.SOURCES) == {"wgmma", "fma"} and mod.SOURCES["fma"] == mod.SOURCE
    src = mod.SOURCES["wgmma"]
    text = src.read_text()
    assert src.exists() and src.parent == mod.SOURCE.parent
    assert f"src/repro/kernels/{name}/kernel.py::" in text  # names the TPU kernel it replaces
    assert "wgmma.mma_async" in text and '#include "../../csrc/sm90.cuh"' in text
    assert (SHARED_HEADERS / "sm90.cuh").exists()
    assert library_path(src) != library_path(mod.SOURCE)
    assert ptxas_report(src) == "" or "registers" in ptxas_report(src)
    assert set(LAUNCHES.by_route(name)) == {"wgmma", "fma"}


def test_launch_counts_lose_no_update_under_threads():
    """``LaunchCounts`` is one lock around every count: 32 threads (more
    than the cores) recording at once, with the interpreter switching
    threads every microsecond, lose no launch; readers get copies and
    ``reset`` zeroes every route."""
    import sys
    import threading

    from repro_torch.kernels.build import LaunchCounts

    counts = LaunchCounts({"a": ("x", "y"), "b": ("z",)})
    per_thread = 2000

    def launches(i):
        kernel, route = ("a", "x") if i % 2 else ("b", "z")
        for _ in range(per_thread):
            counts.record(kernel, route)
            counts.record("a", "y")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launches, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counts.by_route("a") == {"x": 16 * per_thread, "y": 32 * per_thread}
    assert counts.totals() == {"a": 48 * per_thread, "b": 16 * per_thread}
    copy = counts.by_route("b")
    copy["z"] = 0
    assert counts.total("b") == 16 * per_thread
    counts.reset()
    assert counts.totals() == {"a": 0, "b": 0} and counts.by_route("a") == {"x": 0, "y": 0}
    with pytest.raises(KeyError):
        counts.record("a", "z")  # a route the kernel does not have
