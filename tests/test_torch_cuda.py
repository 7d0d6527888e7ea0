"""The port on the card: its CUDA and Triton kernels, its main path, its models
and their training.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), so
each carries the ``cuda`` marker and skips without one.  On a machine with
a card and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX, so it runs where only the port is installed.
Tolerances: kernel against plain version fp32 rtol 2e-5 / atol 2e-4 (K1's
fp32 sum runs in another order), bf16 2e-2; K3 and K4 fp32 rtol and atol
1e-4 (sums of up to T products and an online softmax in another order);
a reduced model or train step on the card against the CPU 1e-4; the
CUDA-core routes' edge cases at ``chip_smoke.py``'s ``KERNEL_TOL``; everything
else bit for bit, the gradients through K3 and K4 (their plain versions'
autograd) included.  K1 and K3 have two routes each (tensor-core
``wgmma`` kernels for bf16, CUDA-core ``fma`` kernels otherwise), K4 three
(``wgmma`` at P = N = 64, ``wgmma_tiled`` at other multiples of 64,
``fma``); the tests count the launches of each
(``repro_torch.kernels.build.LAUNCHES``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.build import LAUNCHES

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_kernel_matches_plain(dev, dtype):
    from repro_torch.kernels.matmul import matmul, matmul_reference

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(300, 520, generator=g, device=dev).to(dtype)  # ragged edges
    w = (torch.randn(520, 200, generator=g, device=dev) / math.sqrt(520)).to(dtype)
    before = LAUNCHES.total("matmul")
    got = matmul(x, w)
    assert LAUNCHES.total("matmul") == before + 1
    torch.testing.assert_close(got.float(), matmul_reference(x, w).float(), **_tol(dtype))
    chunks = torch.cat([matmul(c, w) for c in x.split(100)])
    assert torch.equal(got, chunks)  # per-chunk calls == one whole-M call


def _routes(kernel):
    return LAUNCHES.by_route(kernel)


def _launched(kernel, before, route):
    after = _routes(kernel)
    assert after[route] == before[route] + 1, (before, after)
    assert sum(after.values()) == sum(before.values()) + 1
    assert LAUNCHES.total(kernel) == sum(after.values())


@pytest.mark.parametrize("M,K,N", [
    (300, 200, 264),    # partial tiles on every edge: M % 128, K % 64, N % 256 all != 0
    (1000, 3584, 520),  # the main path's K, many k-tiles
    (129, 64, 8),       # one row into a second tile, one 8-column slice of N
])
def test_matmul_tensor_core_route_partial_tiles(dev, M, K, N):
    from repro_torch.kernels.matmul import matmul, matmul_reference

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(M, K, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    before = _routes("matmul")
    got = matmul(x, w)
    _launched("matmul", before, "wgmma")
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    torch.testing.assert_close(got.float(), matmul_reference(x, w).float(), rtol=2e-2, atol=2e-2)
    # per-chunk calls, at row offsets that fall inside tiles, == one whole-M call
    sizes = [M // 3, M // 5, M - M // 3 - M // 5]
    before = _routes("matmul")
    chunks = torch.cat([matmul(c, w) for c in x.split(sizes)])
    assert _routes("matmul")["wgmma"] == before["wgmma"] + 3
    assert torch.equal(got, chunks)


@pytest.mark.parametrize("K,N", [(100, 264), (200, 100), (36, 20)])
def test_matmul_bf16_shapes_tma_cannot_address_take_the_cuda_core_route(dev, K, N):
    from repro_torch.kernels.matmul import matmul, matmul_reference

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(150, K, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g, device=dev) / math.sqrt(K)).to(torch.bfloat16)
    before = _routes("matmul")
    got = matmul(x, w)
    _launched("matmul", before, "fma")
    torch.testing.assert_close(got.float(), matmul_reference(x, w).float(), rtol=2e-2, atol=2e-2)


# chip_smoke.py's KERNEL_TOL: a kernel against its plain version (rtol, atol)
KERNEL_TOL = {("matmul", torch.float32): (2e-5, 1e-4), ("matmul", torch.bfloat16): (2e-2, 2e-2),
              ("flash", torch.float32): (1e-4, 1e-4), ("flash", torch.bfloat16): (2e-2, 2e-2),
              ("ssd", torch.float32): (1e-4, 1e-4), ("ssd", torch.bfloat16): (2e-2, 2e-2)}


def _off16(t, nbytes=4):
    """A copy of ``t`` whose ``data_ptr()`` is ``nbytes`` off 16 bytes: a
    contiguous view that starts inside a larger buffer."""
    skip = nbytes // t.element_size()
    buf = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    view = buf[skip:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == nbytes and view.is_contiguous()
    return view


def _close(got, want, kernel):
    rtol, atol = KERNEL_TOL[(kernel, want.dtype)]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("M,K,N", [
    (300, 130, 200),   # ragged M and N tiles, K % 4 == 2
    (257, 3583, 129),  # the main path's K less one: K % 4 == 3, one row into a third tile
    (64, 7, 33),       # K shorter than one slice, N % 4 == 1
    (130, 36, 20),     # K % 4 == 0 (bf16: K % 8 != 0 keeps it off the tensor cores)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_cuda_core_route_edges(dev, M, K, N, dtype):
    """K1's fma route at ragged M, N and K, with operands and output 4
    bytes off 16 (its masked scalar loads and stores): within KERNEL_TOL of
    the plain version, the same bits as on aligned operands, and row chunks
    bit-identical to one whole-M call."""
    from repro_torch.kernels.matmul import matmul_cuda, matmul_reference

    g = torch.Generator(device=dev).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    w = (torch.randn(K, N, generator=g, device=dev) / math.sqrt(K)).to(dtype)
    before = _routes("matmul")
    got = matmul_cuda(x, w)
    _launched("matmul", before, "fma")
    _close(got, matmul_reference(x, w), "matmul")
    out = _off16(torch.empty(M, N, dtype=dtype, device=dev))
    off = matmul_cuda(_off16(x), _off16(w), out=out)
    assert off.data_ptr() == out.data_ptr() and torch.equal(off, got)
    chunks = torch.cat([matmul_cuda(c, w) for c in x.split([M // 3, M // 5, M - M // 3 - M // 5])])
    assert torch.equal(chunks, got)  # chunks start K * rows elements in: off 16 where K % 4 != 0


@pytest.mark.parametrize("D,dtype", [
    (6, torch.float32), (8, torch.float32), (72, torch.float32), (80, torch.float32),
    (128, torch.float32), (8, torch.bfloat16), (72, torch.bfloat16),
])
def test_flash_cuda_core_route_edges(dev, D, dtype):
    """K3's fma route at head dims 6 to 128 (D % 4 != 0 and bf16 take its
    masked scalar path), GQA 2:1, ragged S causal and non-causal, T != S, and
    q, k, v and o 4 bytes off 16: within KERNEL_TOL of the plain version, and
    the same bits as on aligned operands."""
    from repro_torch.kernels.flash import attention_reference, flash_attention_cuda

    for S, T, causal in ((200, 200, True), (200, 200, False), (100, 333, False)):
        g = torch.Generator(device=dev).manual_seed(D + S + T)
        q = torch.randn(1, S, 4, D, generator=g, device=dev).to(dtype)
        k, v = (torch.randn(1, T, 2, D, generator=g, device=dev).to(dtype) for _ in range(2))
        before = _routes("flash")
        got = flash_attention_cuda(q, k, v, causal=causal)
        _launched("flash", before, "fma")
        _close(got, attention_reference(q, k, v, causal=causal), "flash")
        out = _off16(torch.empty_like(q))
        off = flash_attention_cuda(_off16(q), _off16(k), _off16(v), causal=causal, out=out)
        assert off.data_ptr() == out.data_ptr() and torch.equal(off, got), (S, T, causal)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, dtype):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(33, 300, generator=g, device=dev).to(dtype)  # d off a power of 2
    w = torch.randn(300, generator=g, device=dev) + 1.0
    before = LAUNCHES.total("rmsnorm")
    got = rmsnorm(x, w)
    assert LAUNCHES.total("rmsnorm") == before + 1
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got.float(), rmsnorm_reference(x, w).float(), **tol)
    buf = x.clone()
    assert torch.equal(rmsnorm(buf, w, out=buf), got)  # in place, same bits


def test_kernels_refuse_what_they_cannot_take(dev):
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm_triton

    x = torch.ones(8, 8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_cuda(x.t(), x)
    with pytest.raises(ValueError, match="dtype|float32 or bfloat16"):
        matmul_cuda(x, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_triton(x.t(), torch.ones(8, device=dev))


@pytest.mark.parametrize("coll", ["all_reduce", "reduce_scatter", "all_gather", "all_to_all"])
def test_collectives_on_the_card_equal_the_cpu(dev, coll):
    """Gathers, scatters and fp32 adds in one order: the same bits on both."""
    from repro_torch import PcclSession
    from repro_torch.core import cost_model as cm

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(8, 64, 5)).astype(np.float32))
    on_cpu = getattr(PcclSession(cm.H100_DGX, device="cpu").communicator("x", 8), coll)(x)
    on_card = getattr(PcclSession(cm.H100_DGX).communicator("x", 8), coll)(x.to(dev))
    assert on_card.device.type == "cuda"
    assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_seams_bit_identical_to_unfused(dev, dtype):
    from repro_torch import PcclSession
    from repro_torch.comm import fusion
    from repro_torch.core import cost_model as cm
    from repro_torch.kernels.rmsnorm import rmsnorm

    session = PcclSession(cm.H100_DGX)
    ring = session.communicator("x", 8, algorithm="ring")
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(8, 8 * 64, 256, generator=g, device=dev).to(dtype)
    w = (torch.randn(256, 384, generator=g, device=dev) / 16).to(dtype)
    k1, fused = LAUNCHES.total("matmul"), session.exec_stats().fused_dispatches
    k1_tc = LAUNCHES.by_route("matmul")["wgmma"]
    out = fusion.fused_matmul_reduce_scatter(ring, x, w)
    assert LAUNCHES.total("matmul") == k1 + 8  # one launch per step for all ranks
    assert LAUNCHES.by_route("matmul")["wgmma"] == k1_tc + (8 if dtype == torch.bfloat16 else 0)
    assert session.exec_stats().fused_dispatches == fused + 1
    unfused = fusion._unfused_matmul_reduce_scatter(ring, x, w, blocks=(128, 128, 128))
    assert torch.equal(out, unfused)

    comm = session.communicator("x", 8)
    a = torch.randn(8, 64, 384, generator=g, device=dev).to(dtype)
    gamma = torch.randn(384, generator=g, device=dev) + 1.0
    k2 = LAUNCHES.total("rmsnorm")
    out = fusion.fused_all_reduce_rmsnorm(comm, a, gamma)
    assert LAUNCHES.total("rmsnorm") == k2 + 1
    assert torch.equal(out, rmsnorm(comm.all_reduce(a), gamma))


def _flash_inputs(dev, B, S, H, K, D, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, n, h, D, generator=g, device=dev).to(dtype)
            for n, h in ((S, H), (S, K), (S, K))]


@pytest.mark.parametrize("B,S,H,K,D", [
    (2, 256, 8, 2, 64),     # GQA 4:1
    (1, 200, 4, 4, 80),     # ragged S, Zamba2's head dim
    (1, 130, 6, 3, 128),    # ragged S, largest head dim
    (2, 64, 2, 1, 16),      # MQA, one tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(dev, B, S, H, K, D, dtype):
    from repro_torch.kernels.flash import attention_reference, flash_attention

    q, k, v = _flash_inputs(dev, B, S, H, K, D, dtype)
    for causal in (True, False):
        before = LAUNCHES.total("flash")
        got = flash_attention(q, k, v, causal=causal)
        assert LAUNCHES.total("flash") == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        want = attention_reference(q, k, v, causal=causal)
        tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("D", [16, 64, 80, 128])
@pytest.mark.parametrize("B,S,T,H,K", [
    (2, 256, 256, 8, 2),    # GQA 4:1, whole tiles
    (1, 200, 200, 4, 1),    # ragged S, MQA
    (1, 333, 333, 2, 2),    # ragged S over three q tiles
    (1, 100, 300, 4, 2),    # non-causal only: T != S
])
def test_flash_tensor_core_route(dev, D, B, S, T, H, K):
    from repro_torch.kernels.flash import attention_reference, flash_attention

    g = torch.Generator(device=dev).manual_seed(D + S)
    q = torch.randn(B, S, H, D, generator=g, device=dev)
    k, v = (torch.randn(B, T, K, D, generator=g, device=dev) for _ in range(2))
    for causal in ((True, False) if S == T else (False,)):
        for dtype, route in ((torch.bfloat16, "wgmma"), (torch.float32, "fma")):
            qd, kd, vd = (t.to(dtype) for t in (q, k, v))
            before = _routes("flash")
            got = flash_attention(qd, kd, vd, causal=causal)
            _launched("flash", before, route)
            assert got.dtype == dtype and got.shape == q.shape
            want = attention_reference(qd, kd, vd, causal=causal)
            tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
            torch.testing.assert_close(got.float(), want.float(), **tol)


def test_flash_bf16_head_dims_off_the_tensor_core_route(dev):
    from repro_torch.kernels.flash import attention_reference, flash_attention

    q, k, v = _flash_inputs(dev, 1, 130, 4, 2, 72, torch.bfloat16)  # D % 16 != 0
    before = _routes("flash")
    got = flash_attention(q, k, v)
    _launched("flash", before, "fma")
    torch.testing.assert_close(got.float(), attention_reference(q, k, v).float(), rtol=2e-2, atol=2e-2)


def _ssd_inputs(dev, B, S, H, P, N, dtype, per_head, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(B, S, H, P, generator=g, device=dev).to(dtype)
    la = -torch.rand(B, S, H, generator=g, device=dev) * 0.3
    bc = (B, S, H, N) if per_head else (B, S, N)
    Bm = (torch.randn(*bc, generator=g, device=dev) * 0.3).to(dtype)
    Cm = (torch.randn(*bc, generator=g, device=dev) * 0.3).to(dtype)
    init = torch.randn(B, H, P, N, generator=g, device=dev) * 0.1
    return X, la, Bm, Cm, init


@pytest.mark.parametrize("B,S,H,P,N,chunk,per_head", [
    (2, 256, 4, 64, 64, 64, False),   # Zamba2's widths, shared B/C
    (1, 200, 3, 32, 64, 64, True),    # S % chunk != 0, per-head B/C
    (2, 96, 2, 16, 16, 32, False),
    (1, 128, 2, 128, 64, 64, True),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_plain(dev, B, S, H, P, N, chunk, per_head, dtype):
    from repro_torch.kernels.ssd import ssd, ssd_reference

    X, la, Bm, Cm, init = _ssd_inputs(dev, B, S, H, P, N, dtype, per_head)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    for state in (None, init):
        before = LAUNCHES.total("ssd")
        Y, fin = ssd(X, la, Bm, Cm, chunk=chunk, initial_state=state)
        assert LAUNCHES.total("ssd") == before + 1
        assert Y.dtype == fin.dtype == dtype  # the final state in X's dtype, as the plain version
        Yr, finr = ssd_reference(X, la, Bm, Cm, chunk=chunk, initial_state=state)
        torch.testing.assert_close(Y.float(), Yr.float(), **tol)
        torch.testing.assert_close(fin.float(), finr.float(), **tol)


@pytest.mark.parametrize("P,N", [(32, 64), (64, 64), (128, 64), (128, 128)])
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("B,S,H", [
    (2, 64, 4),     # one whole chunk
    (1, 200, 3),    # ragged last chunk
    (1, 4096, 8),   # the serving length: 64 chunks of state passing
    (2, 40, 2),     # S < chunk
])
def test_ssd_tensor_core_route(dev, P, N, per_head, B, S, H):
    from repro_torch.kernels.ssd import ssd, ssd_reference, ssd_route

    X, la, Bm, Cm, init = _ssd_inputs(dev, B, S, H, P, N, torch.float32, per_head, seed=S + P)
    for dtype in (torch.bfloat16, torch.float32):
        route = ssd_route(dtype, P, N, 64)
        Xd, Bd, Cd = (t.to(dtype) for t in (X, Bm, Cm))
        tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
        for state in (None, init):
            before = _routes("ssd")
            Y, fin = ssd(Xd, la, Bd, Cd, chunk=64, initial_state=state)
            _launched("ssd", before, route)
            assert Y.dtype == fin.dtype == dtype and Y.shape == X.shape
            Yr, finr = ssd_reference(Xd, la, Bd, Cd, chunk=64, initial_state=state)
            torch.testing.assert_close(Y.float(), Yr.float(), **tol)
            torch.testing.assert_close(fin.float(), finr.float(), **tol)


@pytest.mark.parametrize("P,N,chunk,per_head", [
    (6, 10, 16, False),     # P and N not multiples of 4: 4-byte copies, scalar stores
    (6, 10, 32, True),
    (80, 48, 32, False),    # P = 80: one head a tile, 176 of 256 columns masked
    (80, 48, 64, True),
    (64, 64, 16, False),    # four heads a tile (shared B/C, P = 64), chunk 16
    (128, 72, 32, False),   # two heads a tile
    (1000, 520, 16, True),  # four column tiles a head, nine N-slices
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_cuda_core_route_edges(dev, P, N, chunk, per_head, dtype):
    """K4's fma route at widths and chunks off the main paths, a ragged S,
    shared and per-head B/C, bf16 (widened in registers), with and without
    an initial state: within KERNEL_TOL of the plain version; and with X, B
    and C 4 bytes off 16 (its 4-byte copies), the same bits."""
    from repro_torch.kernels.ssd import ssd_cuda, ssd_reference, ssd_route

    assert ssd_route(dtype, P, N, chunk) == "fma"
    X, la, Bm, Cm, init = _ssd_inputs(dev, 1, 3 * chunk + 5, 3, P, N, dtype, per_head,
                                      seed=P + N + chunk)
    for state in (None, init):
        before = _routes("ssd")
        Y, fin = ssd_cuda(X, la, Bm, Cm, chunk=chunk, initial_state=state)
        _launched("ssd", before, "fma")
        assert Y.dtype == fin.dtype == dtype
        Yr, finr = ssd_reference(X, la, Bm, Cm, chunk=chunk, initial_state=state)
        _close(Y, Yr, "ssd")
        _close(fin, finr, "ssd")
        Yo, fino = ssd_cuda(_off16(X), la, _off16(Bm), _off16(Cm), chunk=chunk, initial_state=state)
        assert torch.equal(Yo, Y) and torch.equal(fino, fin), state is None


def test_ssd_fma_route_keeps_raw_scores_once_per_chunk_where_b_and_c_are_shared(dev):
    """Shared B/C: the fma route's scores scratch is (B, nc, L, L), each
    chunk's raw C Bᵀ once for all heads (rows and columns past S zero), the
    per-head masks applied as pass 3 reads it; per-head B/C keeps (B, H, nc,
    L, L).  Given as ``out=`` buffers, the same Y and final state as buffers
    of the call's own."""
    from repro_torch.kernels.ssd import ssd_cuda, ssd_reference
    from repro_torch.kernels.ssd.kernel import buffers

    for per_head in (False, True):
        X, la, Bm, Cm, init = _ssd_inputs(dev, 2, 150, 5, 64, 64, torch.float32, per_head, seed=7)
        shapes = buffers(X.shape, 64, 64, X.dtype, "fma", per_head=per_head)
        assert shapes["scores"][0] == ((2, 5, 3, 64, 64) if per_head else (2, 3, 64, 64))
        out = {name: torch.empty(shape, dtype=dt, device=dev)
               for name, (shape, dt) in shapes.items()}
        Y, fin = ssd_cuda(X, la, Bm, Cm, chunk=64, initial_state=init, out=out)
        Y2, fin2 = ssd_cuda(X, la, Bm, Cm, chunk=64, initial_state=init)
        assert torch.equal(Y, Y2) and torch.equal(fin, fin2)
        pad = (0, 0) * (Bm.ndim - 2) + (0, 42)  # S = 150 to 3 chunks of 64
        Bc, Cc = (torch.nn.functional.pad(m, pad).unflatten(1, (3, 64)) for m in (Bm, Cm))
        raw = (torch.einsum("bcthn,bcshn->bhcts", Cc, Bc) if per_head
               else torch.einsum("bctn,bcsn->bcts", Cc, Bc))
        torch.testing.assert_close(out["scores"], raw, rtol=1e-5, atol=1e-5)
        Yr, finr = ssd_reference(X, la, Bm, Cm, chunk=64, initial_state=init)
        _close(Y, Yr, "ssd")
        _close(fin, finr, "ssd")


def test_flash_and_ssd_refuse_what_they_cannot_take(dev):
    from repro_torch.kernels.flash import flash_attention_cuda
    from repro_torch.kernels.ssd import ssd_cuda

    q, k, v = _flash_inputs(dev, 1, 64, 2, 2, 32, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=False)
    with pytest.raises(ValueError, match="one dtype"):
        flash_attention_cuda(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*_flash_inputs(dev, 1, 8, 1, 1, 160, torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q.cpu(), k.cpu(), v.cpu())
    X, la, Bm, Cm, init = _ssd_inputs(dev, 1, 64, 2, 16, 16, torch.float32, False)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(X, la, torch.cat([Bm, Bm], dim=-1)[..., :16], Cm, chunk=32)
    with pytest.raises(ValueError, match="float32"):
        ssd_cuda(X, la.to(torch.bfloat16), Bm, Cm, chunk=32)
    # the fma route tiles P and N, so any width fits; a chunk of 1024 does
    # not (its L x 64 tiles of X and B alone take 536,576 bytes)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_cuda(*_ssd_inputs(dev, 1, 64, 1, 64, 64, torch.float32, False)[:4], chunk=1024)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_mlstm_widths(dev, dtype):
    """K4 at the mLSTM's P = 1024, N = 512 (xLSTM-1.3B), per-head B/C (k and
    q), an fp32 initial state and a ragged S: bf16 on the wgmma_tiled route,
    fp32 on the fma route, 16 P-tiles and 8 N-slices a chunk on both."""
    from repro_torch.kernels.ssd import ssd, ssd_reference, ssd_route

    X, la, Bm, Cm, init = _ssd_inputs(dev, 1, 300, 2, 1024, 512, dtype, True, seed=5)
    la = la / 3  # the mLSTM's forget gates keep most of the state
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    route = ssd_route(dtype, 1024, 512, 64)
    assert route == ("wgmma_tiled" if dtype == torch.bfloat16 else "fma")
    for state in (None, init):
        before = _routes("ssd")
        Y, fin = ssd(X, la, Bm, Cm, chunk=64, initial_state=state)
        _launched("ssd", before, route)
        assert Y.dtype == fin.dtype == dtype and fin.shape == (1, 2, 1024, 512)
        Yr, finr = ssd_reference(X, la, Bm, Cm, chunk=64, initial_state=state)
        torch.testing.assert_close(Y.float(), Yr.float(), **tol)
        torch.testing.assert_close(fin.float(), finr.float(), **tol)


def test_ssd_tiled_route_at_the_mlstm_prefill_writes_its_out_buffers(dev):
    """K4's wgmma_tiled route at the mLSTM's prefill, X (4, 4096, 4, 1024),
    N = 512, per-head B/C and an initial state: into caller-given ``out=``
    buffers (scratch and outputs), the same bytes as buffers of its own,
    and within the bf16 tolerance of the plain version."""
    from repro_torch.kernels.ssd import ssd_cuda, ssd_reference
    from repro_torch.kernels.ssd.kernel import buffers

    X, la, Bm, Cm, init = _ssd_inputs(dev, 4, 4096, 4, 1024, 512, torch.bfloat16, True, seed=12)
    shapes = buffers(X.shape, 512, 64, X.dtype, "wgmma_tiled", per_head=True)
    out = {name: torch.empty(shape, dtype=dtype, device=dev)
           for name, (shape, dtype) in shapes.items()}
    assert out["before"].shape == (4, 4, 64, 2, 1024, 512)  # hi, lo
    before = _routes("ssd")
    Y, fin = ssd_cuda(X, la, Bm, Cm, chunk=64, initial_state=init, out=out)
    _launched("ssd", before, "wgmma_tiled")
    assert Y is out["Y"] and fin is out["fin"]
    Y2, fin2 = ssd_cuda(X, la, Bm, Cm, chunk=64, initial_state=init)
    torch.cuda.synchronize()
    assert torch.equal(Y, Y2) and torch.equal(fin, fin2)
    Yr, finr = ssd_reference(X, la, Bm, Cm, chunk=64, initial_state=init)
    torch.testing.assert_close(Y.float(), Yr.float(), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(fin.float(), finr.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("per_head", [False, True])
def test_ssd_tiled_route_ragged_s_at_mlstm_widths(dev, per_head):
    """K4's wgmma_tiled route at P = 1024, N = 512 with S = 1000 (a last
    chunk of 40 rows), shared and per-head B/C, with and without an initial
    state: Y and the final state within the bf16 tolerance of the plain
    version (TMA zero-fills the rows past S)."""
    from repro_torch.kernels.ssd import ssd_cuda, ssd_reference

    X, la, Bm, Cm, init = _ssd_inputs(dev, 1, 1000, 4, 1024, 512, torch.bfloat16, per_head,
                                      seed=13)
    for state in (None, init):
        before = _routes("ssd")
        Y, fin = ssd_cuda(X, la, Bm, Cm, chunk=64, initial_state=state)
        _launched("ssd", before, "wgmma_tiled")
        Yr, finr = ssd_reference(X, la, Bm, Cm, chunk=64, initial_state=state)
        torch.testing.assert_close(Y.float(), Yr.float(), rtol=2e-2, atol=2e-2)
        torch.testing.assert_close(fin.float(), finr.float(), rtol=2e-2, atol=2e-2)


def test_zamba2_reduced_pallas_path_matches_plain_on_the_card(dev):
    """Reduced Zamba2: prefill and decode logits with K3/K4 against the
    plain path, on the card, in fp32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("zamba2-2.7b").reduced()
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=torch.Generator().manual_seed(1)).to(dev)
    out = {}
    with torch.inference_mode():
        for use_pallas in (False, True):
            m = build_model(dataclasses.replace(cfg, use_pallas=use_pallas))
            k3, k4 = LAUNCHES.total("flash"), LAUNCHES.total("ssd")
            logits, state = m.prefill(params, {"tokens": tokens[:, :38]})
            groups = cfg.n_layers // cfg.hybrid.shared_attn_every
            assert LAUNCHES.total("flash") - k3 == (groups if use_pallas else 0)
            assert LAUNCHES.total("ssd") - k4 == (cfg.n_layers if use_pallas else 0)
            out[use_pallas] = [logits]
            for i in (38, 39):
                logits, state = m.decode_step(params, state, tokens[:, i:i + 1])
                out[use_pallas].append(logits)
    for a, b in zip(out[True], out[False]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_flash_tensor_core_route_at_olmoe_head_dim(dev):
    """K3 at OLMoE's attention (16 heads of 128, MHA), bf16: the wgmma route."""
    from repro_torch.kernels.flash import attention_reference, flash_attention

    q, k, v = _flash_inputs(dev, 1, 512, 16, 16, 128, torch.bfloat16, seed=3)
    before = _routes("flash")
    got = flash_attention(q, k, v, causal=True)
    _launched("flash", before, "wgmma")
    torch.testing.assert_close(got.float(), attention_reference(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b"])
def test_decoder_reduced_on_the_card_equals_the_cpu(dev, arch):
    """Reduced OLMoE (K3 on the fma route) and DeepSeek-V2-Lite (MLA, no
    kernel): prefill and two decode steps on the card against the same
    model and weights on the CPU, fp32, within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 42), generator=torch.Generator().manual_seed(1))
    out = {}
    with torch.inference_mode():
        for device in ("cpu", dev):
            p, toks = params.to(device), tokens.to(device)
            k3 = _routes("flash")
            logits, state = model.prefill(p, {"tokens": toks[:, :40]})
            launched = {r: n - k3[r] for r, n in _routes("flash").items()}
            if device == dev:
                want = 0 if cfg.mla else cfg.n_layers
                assert launched == {"wgmma": 0, "fma": want}, launched
            out[device] = [logits]
            for i in (40, 41):
                logits, state = model.decode_step(p, state, toks[:, i:i + 1])
                out[device].append(logits)
    for a, b in zip(out[dev], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_xlstm_reduced_on_the_card_equals_the_cpu(dev):
    """Reduced xLSTM (2 groups of one mLSTM and one sLSTM): prefill and two
    decode steps on the card, K4 on the fma route in each mLSTM, against
    the same model and weights on the CPU, fp32, within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(), use_pallas=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 42), generator=torch.Generator().manual_seed(1))
    out = {}
    with torch.inference_mode():
        for device in ("cpu", dev):
            p, toks = params.to(device), tokens.to(device)
            k4 = _routes("ssd")
            logits, state = model.prefill(p, {"tokens": toks[:, :40]})
            launched = {r: n - k4[r] for r, n in _routes("ssd").items()}
            if device == dev:
                assert launched == {"wgmma": 0, "wgmma_tiled": 0,
                                    "fma": model.n_groups * model.m_per_group}, launched
            out[device] = [logits]
            for i in (40, 41):
                logits, state = model.decode_step(p, state, toks[:, i:i + 1])
                out[device].append(logits)
    for a, b in zip(out[dev], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "fma"), (torch.bfloat16, "wgmma")])
def test_flash_kernel_at_whisper_decoder_shape(dev, dtype, route):
    """K3 at Whisper-small's decoder prefill (12 heads of 64, MHA) with the
    longest prompt OpenAI's decoding builds, S = 228: ragged against the
    tiles, causal, on each route."""
    from repro_torch.kernels.flash import attention_reference, flash_attention

    q, k, v = _flash_inputs(dev, 2, 228, 12, 12, 64, dtype, seed=4)
    before = _routes("flash")
    got = flash_attention(q, k, v, causal=True)
    _launched("flash", before, route)
    assert got.dtype == dtype and got.shape == q.shape
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), attention_reference(q, k, v).float(), **tol)


def test_whisper_reduced_on_the_card_equals_the_cpu(dev):
    """Reduced whisper-small (2 encoder and 4 decoder layers, enc_seq 32),
    random encoder frames: prefill (K3 on the fma route in each decoder
    layer, none in the encoder or the cross-attention) and two decode steps
    on the card against the same model and weights on the CPU, fp32,
    within 1e-4; the cross state too."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config("whisper-small").reduced(), use_pallas=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (2, 42), generator=g)
    frames = torch.randn(2, cfg.enc_dec.enc_seq, cfg.d_model, generator=g)
    out = {}
    with torch.inference_mode():
        for device in ("cpu", dev):
            p, toks = params.to(device), tokens.to(device)
            k3 = _routes("flash")
            logits, state = model.prefill(p, {"tokens": toks[:, :40],
                                              "enc_frames": frames.to(device)}, max_len=48)
            launched = {r: n - k3[r] for r, n in _routes("flash").items()}
            if device == dev:
                assert launched == {"wgmma": 0, "fma": cfg.n_layers}, launched
            out[device] = [logits, *state["cross"].values()]
            for i in (40, 41):
                logits, state = model.decode_step(p, state, toks[:, i:i + 1])
                out[device].append(logits)
            if device == dev:
                assert _routes("flash") == {r: n + (cfg.n_layers if r == "fma" else 0)
                                                         for r, n in k3.items()}  # none in decode
    for a, b in zip(out[dev], out["cpu"]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def _grad_case(fn, inputs, weights):
    """The outputs of ``fn`` and the gradients of Σ out·w (fp32) with
    respect to the inputs that take one."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(t.requires_grad)
              for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    total = sum((o.float() * w).sum() for o, w in zip(outs, weights) if w is not None)
    return outs, torch.autograd.grad(total, [t for t in leaves if t is not None and t.requires_grad])


@pytest.mark.parametrize("case", ["gqa", "ragged"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradient_through_the_kernel_is_the_plain_versions(dev, case, dtype):
    """K3 forward on the card under autograd: the kernel launches once (its
    route as without autograd), and the gradient is the plain version's
    autograd, bit for bit (the backward recomputes the plain version on the
    same inputs); at the smoke's GQA and ragged shapes."""
    from repro_torch.kernels.flash import attention_reference, flash_attention

    B, S, H, K, D = {"gqa": (2, 256, 8, 2, 64), "ragged": (1, 200, 32, 32, 80)}[case]
    q, k, v = (t.requires_grad_() for t in _flash_inputs(dev, B, S, H, K, D, dtype, seed=7))
    w = [torch.randn(B, S, H, D, generator=torch.Generator(device=dev).manual_seed(8), device=dev)]
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    before = _routes("flash")
    (got,), grads = _grad_case(lambda *t: flash_attention(*t, causal=True), (q, k, v), w)
    _launched("flash", before, route)  # one launch, the backward launches none
    (want,), want_grads = _grad_case(lambda *t: attention_reference(*t, causal=True), (q, k, v), w)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


@pytest.mark.parametrize("case", ["per_head", "ragged", "initial_state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradient_through_the_kernel_is_the_plain_versions(dev, case, dtype):
    """K4 forward on the card under autograd: one launch, and the gradient
    of X, la, B, C (shared B/C summed over heads on the ragged case) and an
    initial state is ``ssd_reference``'s autograd, bit for bit; the final
    state takes no gradient where nothing reads it."""
    from repro_torch.kernels.ssd import ssd, ssd_reference

    B, S, H, P, N = {"per_head": (2, 512, 8, 64, 64), "ragged": (2, 1000, 80, 64, 64),
                     "initial_state": (1, 200, 4, 64, 64)}[case]
    X, la, Bm, Cm, init = _ssd_inputs(dev, B, S, H, P, N, dtype, case != "ragged", seed=9)
    inputs = [X, la, Bm, Cm, init if case == "initial_state" else None]
    for t in inputs:
        if t is not None:
            t.requires_grad_()
    g = torch.Generator(device=dev).manual_seed(10)
    w = [torch.randn(B, S, H, P, generator=g, device=dev),
         torch.randn(B, H, P, N, generator=g, device=dev) if case == "initial_state" else None]
    route = "wgmma" if dtype == torch.bfloat16 else "fma"
    before = _routes("ssd")
    (Y, _), grads = _grad_case(lambda *t: ssd(*t[:4], chunk=64, initial_state=t[4]), inputs, w)
    _launched("ssd", before, route)
    (Yr, _), want = _grad_case(lambda *t: ssd_reference(*t[:4], chunk=64, initial_state=t[4]),
                               inputs, w)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(Y.float(), Yr.float(), **tol)
    assert len(grads) == (5 if case == "initial_state" else 4)
    assert all(torch.equal(a, b) for a, b in zip(grads, want))


def test_reduced_train_step_on_the_card_equals_the_cpu(dev):
    """Reduced Zamba2 with the kernels (fma route in fp32): one microbatched
    train step on the card against the same step on the CPU from the same
    weights, fp32, within 1e-4: loss, grad norm and every parameter after
    the update (the default schedule's first step moves a parameter by at
    most lr = 3e-6, so a gradient near zero cannot move it past 1e-4)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.models import ParamTree, build_model
    from repro_torch.train import OptimizerConfig, init_opt_state, make_train_step

    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(), use_pallas=True)
    model = build_model(cfg)
    start = model.init(torch.Generator().manual_seed(0), "cpu").state_dict()
    batch = SyntheticLMData(cfg, DataConfig(global_batch=4, seq_len=64)).global_batch(0)
    step = make_train_step(model, OptimizerConfig(), microbatches=2)
    out = {}
    for device in ("cpu", dev):
        params = ParamTree.from_state_dict({k: v.clone().to(device) for k, v in start.items()})
        k3, k4 = _routes("flash"), _routes("ssd")
        params, _, metrics = step(params, init_opt_state(params), to_device(batch, device))
        if device == dev:
            groups = cfg.n_layers // cfg.hybrid.shared_attn_every
            # forward and remat recompute, 2 microbatches
            assert {r: n - k3[r] for r, n in _routes("flash").items()} == \
                {"wgmma": 0, "fma": 4 * groups}
            assert {r: n - k4[r] for r, n in _routes("ssd").items()} == \
                {"wgmma": 0, "wgmma_tiled": 0, "fma": 4 * cfg.n_layers}
        out[device] = (metrics, {k: v.detach().cpu() for k, v in params.state_dict().items()})
    (m_cpu, p_cpu), (m_dev, p_dev) = out["cpu"], out[dev]
    for key in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(m_dev[key].cpu(), m_cpu[key], rtol=1e-4, atol=1e-4)
    for name in p_cpu:
        torch.testing.assert_close(p_dev[name], p_cpu[name], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype,route", [(torch.float32, "fma"), (torch.bfloat16, "wgmma")])
def test_flash_kernel_at_whisper_train_shape(dev, dtype, route):
    """K3 as a Whisper-small train step calls it: each decoder layer's causal
    self-attention over a microbatch of 4 rows of 448 tokens (Whisper's
    text context), 12 heads of 64, through ``flash_attention`` on inputs
    that take a gradient: one launch on the route, the forward within the
    kernel tolerance of the plain version, the gradient the plain version's
    autograd bit for bit."""
    from repro_torch.kernels.flash import attention_reference, flash_attention

    q, k, v = (t.requires_grad_() for t in _flash_inputs(dev, 4, 448, 12, 12, 64, dtype, seed=11))
    w = [torch.randn(4, 448, 12, 64, generator=torch.Generator(device=dev).manual_seed(12),
                     device=dev)]
    before = _routes("flash")
    (got,), grads = _grad_case(lambda *t: flash_attention(*t, causal=True), (q, k, v), w)
    _launched("flash", before, route)
    (want,), want_grads = _grad_case(lambda *t: attention_reference(*t, causal=True), (q, k, v), w)
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_checkpoint_round_trip_of_cuda_tensors(dev, tmp_path):
    """An async save of a train state on the card, its parameters and
    moments then updated in place by AdamW: the restore into a template on
    the card gives the state as it was at save time, bit for bit, on the
    card."""
    from repro_torch.ckpt import CheckpointConfig, CheckpointManager
    from repro_torch.ckpt.checkpoint import flatten
    from repro_torch.train import OptimizerConfig, adamw_update, init_opt_state

    g = torch.Generator(device=dev).manual_seed(13)
    params = {"w": torch.randn(512, 384, generator=g, device=dev),
              "b": {"c": torch.randn(384, generator=g, device=dev)}}
    flat = {"w": params["w"], "b.c": params["b"]["c"]}  # AdamW's view: the same tensors
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1)

    def grads():
        return {"w": torch.randn(512, 384, generator=g, device=dev),
                "b.c": torch.randn(384, generator=g, device=dev)}

    flat, state, _ = adamw_update(cfg, grads(), flat, init_opt_state(flat))
    saved = {k: v.clone() for k, v in flatten((params, state))}
    mgr = CheckpointManager(CheckpointConfig(str(tmp_path), async_write=True))
    mgr.save(1, (params, state))
    adamw_update(cfg, grads(), flat, state)  # in place, while the writer runs
    fresh = {"w": torch.zeros(512, 384, device=dev), "b": {"c": torch.zeros(384, device=dev)}}
    fresh_state = init_opt_state({"w": fresh["w"], "b.c": fresh["b"]["c"]})
    (got_params, got_state), step, _ = mgr.restore((fresh, fresh_state))
    got = dict(flatten((got_params, got_state)))
    assert step == 1 and set(got) == set(saved)
    assert all(t.device.type == "cuda" for t in got.values())
    assert all(torch.equal(got[k], saved[k]) for k in saved)


def test_reduced_whisper_trainer_on_the_card(dev, tmp_path):
    """Reduced whisper-small with the kernels, bf16 activations, through the
    ``Trainer`` on the card: a failure at step 3, a resume from the step-2
    checkpoint, and K3 on its tensor-core route in every decoder layer's
    forward and remat recompute (none in the encoder or the
    cross-attention); finite losses, the replayed steps' losses equal to
    the first pass's within 1e-6, the final checkpoint at step 6."""
    import dataclasses

    from repro_torch.ckpt import CheckpointConfig
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.runtime.fault import FailureInjector
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config("whisper-small").reduced(), use_pallas=True,
                              dtype="bfloat16")
    trainer = Trainer(cfg, DataConfig(global_batch=4, seq_len=64),
                      OptimizerConfig(lr=1e-3, total_steps=6, warmup_steps=1),
                      TrainerConfig(total_steps=6, ckpt_every=2, log_every=1, microbatches=2),
                      ckpt_cfg=CheckpointConfig(str(tmp_path), keep=2),
                      failure_injector=FailureInjector(fail_at_steps=(3,)))
    assert trainer.device.type == "cuda"
    before = _routes("flash")
    out = trainer.run()
    launched = {r: n - before[r] for r, n in _routes("flash").items()}
    steps = [h["step"] for h in out["history"]]
    assert steps == [0, 1, 2, 2, 3, 4, 5]
    # each step: n_layers decoder layers x (forward + remat recompute) x 2 microbatches
    assert launched == {"wgmma": len(steps) * cfg.n_layers * 2 * 2, "fma": 0}, launched
    losses = [h["loss"] for h in out["history"]]
    assert all(math.isfinite(x) for x in losses)
    assert losses[3] == pytest.approx(losses[2], rel=1e-6)
    assert trainer.ckpt.latest_step() == 6 and trainer.ckpt.steps() == [4, 6]
    assert all(p.device.type == "cuda" for p in out["params"].parameters())


def test_launch_counts_are_one_locked_object_of_every_kernel(dev):
    """``LAUNCHES`` counts each kernel where it launches, by route, and
    nowhere else: one call of each entry point adds one to its kernel and
    route; launches from several fresh threads at once all launch and all
    count; ``reset`` sets every count to 0 and the readers return copies."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.build import LAUNCHES, LaunchCounts
    from repro_torch.kernels.flash import flash_attention
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.rmsnorm import rmsnorm
    from repro_torch.kernels.ssd import ssd

    assert isinstance(LAUNCHES, LaunchCounts)
    assert set(LAUNCHES.totals()) == {"matmul", "rmsnorm", "flash", "ssd", "round"}
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(128, 64, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(64, 64, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = _flash_inputs(dev, 1, 64, 2, 2, 64, torch.bfloat16)
    X, la, Bm, Cm, _ = _ssd_inputs(dev, 1, 64, 2, 64, 64, torch.bfloat16, False)
    LAUNCHES.reset()
    assert LAUNCHES.totals() == {"matmul": 0, "rmsnorm": 0, "flash": 0, "ssd": 0, "round": 0}
    matmul(x, w)
    rmsnorm(x, torch.ones(64, device=dev))
    flash_attention(q, k, v, causal=True)
    ssd(X, la, Bm, Cm, chunk=64)
    torch.cuda.synchronize()
    assert LAUNCHES.totals() == {"matmul": 1, "rmsnorm": 1, "flash": 1, "ssd": 1, "round": 0}
    assert {name: LAUNCHES.by_route(name) for name in ("matmul", "rmsnorm", "flash", "ssd")} == {
        "matmul": {"wgmma": 1, "fma": 0}, "rmsnorm": {"triton": 1},
        "flash": {"wgmma": 1, "fma": 0}, "ssd": {"wgmma": 1, "wgmma_tiled": 0, "fma": 0}}
    snapshot = LAUNCHES.by_route("matmul")
    snapshot["wgmma"] = 99  # a copy: the count does not move
    assert LAUNCHES.total("matmul") == 1

    def launch_many(_):
        # a fresh host thread: the tensor-core wrappers encode their TMA maps
        # with cuTensorMapEncodeTiled, which needs the thread's context bound
        for _ in range(20):
            matmul(x, w)
            flash_attention(q, k, v, causal=True)
            ssd(X, la, Bm, Cm, chunk=64)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(launch_many, range(8)))
    torch.cuda.synchronize()
    for name in ("matmul", "flash", "ssd"):
        tiled = {"wgmma_tiled": 0} if name == "ssd" else {}
        assert LAUNCHES.by_route(name) == {"wgmma": 1 + 8 * 20, "fma": 0, **tiled}, name
    LAUNCHES.reset()
    assert sum(LAUNCHES.totals().values()) == 0


def test_reduced_zamba2_serves_under_a_one_rank_nccl_mesh_bit_for_bit(dev):
    """Path 11a at a reduced size: the engine under a one-rank NCCL mesh
    with the default rules gives the same tokens and logits as without a
    mesh, launches K3 and K4 as often, and reaches the shard sites."""
    import os
    import socket
    from dataclasses import replace

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.serve.engine import EngineConfig, Request, ServeEngine
    from repro_torch.sharding import SITES, default_rules, use_partitioning

    cfg = replace(get_config("zamba2-2.7b").reduced(), use_pallas=True, dtype="bfloat16")

    def serve():
        engine = ServeEngine(cfg, EngineConfig(batch_size=2, max_len=48), seed=0, device=dev)
        logits = []
        decode = engine.model.decode_step

        def watched(*args, **kwargs):
            out = decode(*args, **kwargs)
            logits.append(out[0].clone())
            return out

        engine.model.decode_step = watched
        rng = np.random.default_rng(0)
        reqs = [Request(prompt=rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                        max_new_tokens=4) for n in (40, 24)]
        LAUNCHES.reset()
        engine.generate(reqs)
        return [q.generated for q in reqs], logits, LAUNCHES.by_route("flash"), \
            LAUNCHES.by_route("ssd")

    plain = serve()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        SITES.reset()
        with use_partitioning(mesh, default_rules()):
            meshed = serve()
        assert SITES.total() > 0
    finally:
        dist.destroy_process_group()
    assert meshed[0] == plain[0]
    assert len(meshed[1]) == len(plain[1])
    assert all(torch.equal(a, b) for a, b in zip(meshed[1], plain[1]))
    # the reduced widths take K4's fma route (its wgmma route needs P = N = 64)
    assert meshed[2:] == plain[2:] and plain[2]["wgmma"] > 0 and sum(plain[3].values()) > 0


def _p12_cases(n):
    base = dict(n=n, hw="H100_DGX")
    cases = [dict(base, path="comm", collective=c, seed=40 + i,
                  local=(16, 64) if c == "all_gather" else (16 * n, 64))
             for i, c in enumerate(("all_reduce", "reduce_scatter", "all_gather", "all_to_all"))]
    cases.append(dict(base, path="comm", collective="all_reduce", algorithm="ring_ef8",
                      local=(16 * n, 64), seed=44))
    cases.append(dict(base, path="fused_mm_rs", local=(64 * n, 128), side=(128, 64),
                      dtype="bfloat16", algorithm="ring", seed=45))
    cases.append(dict(base, path="fused_ar_rms", local=(8, 64 * n), side=(64 * n,),
                      dtype="bfloat16", seed=46))
    return cases


def test_process_group_collectives_take_the_staged_route(dev, tmp_path):
    """Four processes over gloo on the one card: every collective, ring_ef8
    and both seams, each rank's result bit for bit its row of the
    rank-stacked engine on the card; every round on ``gloo-staged`` with
    bytes staged through the host; one K1 a tile (wgmma) and one K2 in
    each process's counted calls."""
    from repro_torch import PcclSession
    from repro_torch.comm import fusion
    from repro_torch.core import cost_model as cm
    from repro_torch.launch import procs

    n = 4
    cases = _p12_cases(n)
    ranks = procs.spawn(procs.collectives_program, n, (cases, "cuda"), store_dir=str(tmp_path),
                        timeout_s=300, threads=2)
    for i, case in enumerate(cases):
        dtype = getattr(torch, case.get("dtype", "float32"))
        x = torch.as_tensor(procs.stacked_input(case), device=dev).to(dtype)
        comm = PcclSession(cm.H100_DGX, device=dev).communicator(
            "x", n, algorithm=case.get("algorithm", "auto"))
        side = torch.as_tensor(procs.side_input(case), device=dev).to(dtype) \
            if "side" in case else None
        if case["path"] == "fused_mm_rs":
            want = fusion.fused_matmul_reduce_scatter(comm, x, side)
        elif case["path"] == "fused_ar_rms":
            want = fusion.fused_all_reduce_rmsnorm(comm, x, side)
        else:
            want = getattr(comm, case["collective"])(x)
        want = want.float().cpu().numpy()
        for r, rank in enumerate(ranks):
            out = rank["cases"][i]["out"]
            if case["path"].startswith("fused"):
                np.testing.assert_array_equal(out[0], out[1])  # fused == unfused
                out = out[0]
            np.testing.assert_array_equal(out, want[r])
    for rank in ranks:
        assert set(rank["route_rounds"]) == {"gloo-staged"} and rank["staged_bytes"] > 0
        counted = [c["launches"] for c in rank["cases"]]
        assert counted[5]["matmul"] == {"wgmma": n, "fma": 0}
        assert counted[6]["rmsnorm"] == {"triton": 1}


def test_a_cuda_operand_on_a_fake_group_raises(dev):
    """No transport carries a CUDA operand over a group that moves no data:
    the route raises rather than falling back."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.comm import ScheduleExecutionError
    from repro_torch.comm.exec_engine import transport_route

    dist.init_process_group("fake", rank=0, world_size=2, store=FakeStore())
    try:
        with pytest.raises(ScheduleExecutionError, match="backend 'fake'"):
            transport_route(dist.group.WORLD, torch.ones(2, device=dev))
    finally:
        dist.destroy_process_group()


def test_gloo_carries_cuda_point_to_point_and_dtensor_gathers_only_staged(dev, tmp_path):
    """What this torch build's gloo does with CUDA tensors, which the
    ``gloo-staged`` routes exist for: ``batch_isend_irecv`` of CUDA
    tensors fails, and a DTensor all-gather of a CUDA tensor kills its
    ranks (torch 2.11: a segfault in ``wait_tensor``); staged through host
    memory the gather is right.  Should a torch release carry either, this
    test fails and the staging can be reconsidered."""
    from repro_torch.launch import procs

    for what in ("p2p", "dtensor_gather"):
        with pytest.raises(RuntimeError, match="failed|exited with codes"):
            procs.spawn(procs.gloo_cuda_program, 2, (what,), store_dir=str(tmp_path / what),
                        timeout_s=120)
    got = procs.spawn(procs.gloo_cuda_program, 2, ("dtensor_gather_staged",),
                      store_dir=str(tmp_path / "staged"), timeout_s=120)
    assert got == [[1.0] * 4 + [2.0] * 4] * 2


def test_sharded_trainer_on_the_card_equals_one_process(dev, tmp_path):
    """A reduced Whisper (fp32, K3 on its fma route) through the Trainer on
    a (2, 2) mesh of four processes on the card, the default rules (FSDP
    over "data", TP over "model"), DTensor's collectives staged through
    host memory: every loss within 1e-4 of the one-process Trainer on the
    card, the restart from the step-2 checkpoint, then the shrink to
    (1, 2) with every value kept."""
    from dataclasses import replace

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch import procs
    from repro_torch.sharding import default_rules
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    cfg = replace(get_config("whisper-small").reduced(), n_layers=2, use_pallas=True)
    args = (cfg, DataConfig(global_batch=4, seq_len=16), OptimizerConfig(),
            TrainerConfig(total_steps=4, ckpt_every=2, log_every=100))
    ranks = procs.spawn(procs.trainer_program, 4, args,
                        dict(mesh_shape=(2, 2), rules=default_rules(), device="cuda",
                             ckpt_dir=str(tmp_path / "ckpt"), fail_at=(3,), shrink=True),
                        store_dir=str(tmp_path), timeout_s=300, threads=2)
    one = [h["loss"] for h in Trainer(*args, device=dev).run()["history"]]
    for rank in ranks:
        assert rank["steps"] == [0, 1, 2, 2, 3] and rank["resumed_from"] == [2]
        by_step = dict(zip(rank["steps"], rank["losses"]))
        np.testing.assert_allclose([by_step[s] for s in range(4)], one, rtol=0, atol=1e-4)
        assert set(rank["route_rounds"]) == {"gloo-staged"} and rank["staged_bytes"] > 0
        assert rank["launches"]["flash"]["fma"] > 0
    survivors = [r for r in ranks if not r["failed"]]
    assert len(survivors) == 2 and all(r["reshard_exact"] for r in survivors)


def _loss_and_grads(cfg, start, batch, dev, mesh=None, rules=None):
    """The loss and every gradient of one step of ``cfg`` from the weights
    ``start``; under ``mesh`` the parameters and the batch are DTensors
    placed by ``rules``, as the sharded ``Trainer`` places them."""
    import contextlib

    from torch.distributed.tensor import DTensor, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.data import to_device
    from repro_torch.models import ParamTree, build_model
    from repro_torch.models.module import axes_of, shapes_of
    from repro_torch.sharding import partition
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.trainer import _place

    model = build_model(cfg)
    params = ParamTree.from_state_dict({k: v.clone().to(dev) for k, v in start.items()})
    batch = to_device(batch, dev)
    placed = contextlib.nullcontext()
    if mesh is not None:
        specs = model.specs()
        _place(params, partition.param_sharding(axes_of(specs), mesh, rules,
                                                shapes_tree=shapes_of(specs)), mesh)
        with partition.use_partitioning(mesh, rules):
            batch = {k: distribute_tensor(v, mesh, partition.placements(partition.spec_for(
                ("batch",) + (None,) * (v.ndim - 1), tuple(v.shape)), v.ndim, mesh),
                src_data_rank=None) for k, v in batch.items()}
        placed = contextlib.ExitStack()
        placed.enter_context(partition.use_partitioning(mesh, rules))
        placed.enter_context(implicit_replication())
    p = leaves(params)
    for t in p.values():
        t.requires_grad_(True)
    with placed:
        loss, _ = model.loss(params, batch)
        loss.backward()
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu()
    return whole(loss), {k: whole(t.grad) for k, t in p.items()}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b"])
def test_reduced_train_step_under_a_one_rank_nccl_mesh_equals_no_mesh(dev, arch):
    """A reduced Zamba2 and OLMoE step (fp32, plain path) with DTensor
    parameters and batch on a one-rank NCCL mesh, the default rules: the
    ops this torch has no DTensor rule for take the port's
    (``repro_torch.sharding.rules``); the loss and every gradient within
    1e-6 of the step with no mesh."""
    import os
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import build_model
    from repro_torch.sharding import default_rules

    cfg = get_config(arch).reduced()
    start = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu").state_dict()
    batch = SyntheticLMData(cfg, DataConfig(global_batch=4, seq_len=32)).global_batch(0)
    want_loss, want = _loss_and_grads(cfg, start, batch, dev)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("nccl", rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        loss, grads = _loss_and_grads(cfg, start, batch, dev, mesh, default_rules())
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-6)
    assert set(grads) == set(want)
    for k in want:
        torch.testing.assert_close(grads[k], want[k], rtol=0, atol=1e-6, msg=k)


# ------------------------------------------- the kernel lint's launch models

def _lint_cases():
    from repro_torch.analysis.kernel_lint import shipped_kernel_cases

    return shipped_kernel_cases()


@pytest.mark.parametrize("case", _lint_cases(), ids=lambda c: c[0])
def test_launch_model_geometry_equals_the_library(dev, case):
    """Each modelled launch's grid, threads and dynamic smem are what the
    library's geometry export (its launcher's own function) reports, and its
    static + dynamic smem fit the card's opt-in limit."""
    from repro_torch.analysis.kernel_lint import DEFAULT_SMEM_BUDGET
    from repro_torch.analysis.launch_probe import geometry_mismatches, materialize

    label, fn, args, kwargs = case
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    assert optin == DEFAULT_SMEM_BUDGET
    g = torch.Generator(device=dev).manual_seed(0)
    args, kwargs = materialize(torch, args, kwargs, dev, g)
    sites, device, problems = geometry_mismatches(fn, args, kwargs, optin)
    assert sites and not problems, problems


@pytest.mark.parametrize("case", _lint_cases(), ids=lambda c: c[0])
def test_launch_writes_every_output_element_and_no_guard(dev, case):
    """The real kernel, launched into NaN-filled outputs between sentinel
    guard bands, writes every element and touches no guard."""
    from repro_torch.analysis.launch_probe import materialize, probe_outputs

    label, fn, args, kwargs = case
    g = torch.Generator(device=dev).manual_seed(1)
    args, kwargs = materialize(torch, args, kwargs, dev, g)
    for name, r in probe_outputs(torch, fn, args, kwargs).items():
        assert r["unwritten"] == 0 and r["touched"] == 0, (label, name, r)


# -- the program's spans: device events on the host's clock -----------------


def test_spans_put_device_events_on_the_host_clock(dev):
    """A span opened on an idle stream reads a lead near 0; one opened behind
    a 20 ms sleep kernel reads the sleep as its lead."""
    from repro_torch import spans

    x = torch.zeros(1024, device=dev)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    torch.cuda._sleep(10**7)
    b.record()
    b.synchronize()
    cycles_per_ms = 10**7 / a.elapsed_time(b)
    with spans.tracing():
        torch.cuda.synchronize()
        with spans.span("round", x):
            x.add_(1)
        torch.cuda.synchronize()
        torch.cuda._sleep(int(20 * cycles_per_ms))
        with spans.span("round", x):
            x.add_(1)
    first, behind = spans.records()
    lead_ms = [(s.device_start_ns - s.start_ns) / 1e6 for s in (first, behind)]
    assert abs(lead_ms[0]) < 0.05, lead_ms
    assert lead_ms[1] >= 15, lead_ms
    assert all(s.device_end_ns >= s.device_start_ns for s in (first, behind))


@pytest.mark.parametrize("workload, device_metrics", [
    ("mistral123b-tp8.layer", {"round_GBps.coll", "lead_ms.mm_rs"}),
    ("mistral123b-tp8.colls", {"round_GBps.coll"}),
])
def test_a_traced_cell_reads_the_spans_device_metrics(dev, workload, device_metrics):
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run([sys.executable, "pcclbench/run.py", "--workload", workload,
                          "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "1"],
                         cwd=Path(__file__).resolve().parents[1], capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert device_metrics | {"plan_us.coll", "enqueue_us.round"} <= set(r["metrics"]), r["metrics"]


# -- the round kernel: a rank-stacked round in one pass ----------------------

def _round_schedules():
    from repro_torch.core import schedules as S

    return {
        "all_reduce-bucket2d": S.bucket_all_reduce((2, 4), 1.0),
        "reduce_scatter-bucket2d": S.bucket_reduce_scatter((2, 4), 1.0),
        "all_gather-bucket2d": S.bucket_all_gather((2, 4), 1.0),
        "all_to_all-dex": S.dex_all_to_all(8, 1.0),
        "all_to_all-direct": S.direct_all_to_all(8, 1.0),
        "all_reduce-ring": S.ring_all_reduce(8, 1.0),
        "reduce_scatter-ring": S.ring_reduce_scatter(8, 1.0),
        "all_gather-ring": S.ring_all_gather(8, 1.0),
    }


ROUND_CASES = ["all_reduce-bucket2d", "reduce_scatter-bucket2d", "all_gather-bucket2d",
               "all_to_all-dex", "all_to_all-direct", "all_reduce-ring", "reduce_scatter-ring",
               "all_gather-ring"]
# a chunk's shape: 8 KiB in bf16 (16-byte units), and 3 elements (one element a thread)
ROUND_CHUNKS = {"units16": (4, 1024), "ragged": (1, 3)}
ROUND_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _round_operand(sched, chunk, dtype, dev, seed=0):
    """The collective's rank-stacked operand: a chunk a rank of ``chunk``
    elements (an all-gather's shard is one chunk)."""
    lead = chunk[0] if sched.collective == "all_gather" else chunk[0] * sched.n
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((sched.n, lead, chunk[1]), generator=g, device=dev).to(dtype)


def _round_compiled(sched):
    from repro_torch.comm import exec_engine as E

    if sched.collective == "all_to_all":
        return E.compile_all_to_all(sched, sched.n, tuple(range(sched.n)))
    return E.compile_schedule(sched)


def _round_launches(compiled):
    """The round kernel's launches by route one call of the collective makes."""
    flags = [bool(f) for g in compiled.groups for f in g.staged]
    copies = 1 if compiled.collective != "all_reduce" else 0  # the diagonal, the final gather
    return {"inplace": flags.count(False), "staged": 2 * flags.count(True), "copy": copies}


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("dtype", ROUND_DTYPES, ids=lambda d: str(d).rsplit(".", 1)[1])
@pytest.mark.parametrize("chunk", list(ROUND_CHUNKS), ids=list(ROUND_CHUNKS))
@pytest.mark.parametrize("case", ROUND_CASES)
def test_round_kernel_collectives_bit_for_bit(dev, case, chunk, dtype):
    """Each collective through the round kernel equals the per-round
    reference interpreter on the card and the index path on the CPU, bit
    for bit, with the launches the compiled tables predict."""
    from repro_torch.comm import primitives as P

    sched = _round_schedules()[case]
    x = _round_operand(sched, ROUND_CHUNKS[chunk], dtype, dev)
    before = LAUNCHES.by_route("round")
    got = getattr(P, sched.collective)(x, sched)
    torch.cuda.synchronize()
    after = LAUNCHES.by_route("round")
    assert {r: after[r] - before[r] for r in after} == _round_launches(_round_compiled(sched))
    want = P.run_reference(sched.collective, x, sched)
    assert torch.equal(_bits(got), _bits(want))
    on_cpu = getattr(P, sched.collective)(x.cpu(), sched)
    assert torch.equal(_bits(got.cpu()), _bits(on_cpu))


@pytest.mark.parametrize("case", ROUND_CASES)
def test_round_kernel_takes_a_strided_operand(dev, case):
    """An operand that is not contiguous (a transposed view) still runs
    every round on the kernel: the collectives hand the engine a contiguous
    copy.  The engine refuses a strided CUDA buffer of its own."""
    from repro_torch.comm import exec_engine as E
    from repro_torch.comm import primitives as P

    sched = _round_schedules()[case]
    x = _round_operand(sched, ROUND_CHUNKS["units16"], torch.bfloat16, dev, seed=5)
    strided = x.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous() and torch.equal(strided, x)
    before = LAUNCHES.by_route("round")
    got = getattr(P, sched.collective)(strided, sched)
    torch.cuda.synchronize()
    after = LAUNCHES.by_route("round")
    assert {r: after[r] - before[r] for r in after} == _round_launches(_round_compiled(sched))
    assert torch.equal(_bits(got), _bits(P.run_reference(sched.collective, x, sched)))
    if sched.collective != "all_to_all":
        buf = torch.zeros((8, 8, 16), dtype=torch.bfloat16, device=dev).transpose(1, 2)
        with pytest.raises(E.ScheduleExecutionError, match="contiguous"):
            E.execute_compiled(buf, _round_compiled(sched))


def _guarded(torch, shape, dtype, dev, guard=4096):
    """A NaN-filled flat tensor and a view of ``shape`` inside it, with
    ``guard`` elements on each side."""
    n = math.prod(shape)
    flat = torch.full((n + 2 * guard,), float("nan"), dtype=dtype, device=dev)
    return flat, flat[guard:guard + n].view(shape), guard


@pytest.mark.parametrize("chunk", list(ROUND_CHUNKS), ids=list(ROUND_CHUNKS))
@pytest.mark.parametrize("case", ROUND_CASES)
def test_round_kernel_touches_no_guard(dev, case, chunk):
    """The engine's buffer between NaN guard bands: every round, and the
    compact all-to-all's final gather, writes what the reference writes and
    no guard element (the tables address only the buffer's rows)."""
    from repro_torch.comm import exec_engine as E
    from repro_torch.comm import primitives as P

    sched = _round_schedules()[case]
    compiled = _round_compiled(sched)
    x = _round_operand(sched, ROUND_CHUNKS[chunk], torch.bfloat16, dev, seed=1)
    n = sched.n
    if sched.collective == "all_gather":
        state = x.new_zeros((n, n) + tuple(x.shape[1:]))
        state[torch.arange(n), torch.arange(n)] = x
    else:
        state = x.reshape((n, n, -1) + tuple(x.shape[2:]))
    flat, buf, guard = _guarded(torch, tuple(state.shape), state.dtype, dev)
    buf.copy_(state)
    if sched.collective == "all_to_all":
        out = E.execute_all_to_all_compact(buf, compiled)
        assert torch.equal(_bits(out.reshape(x.shape)), _bits(P.run_reference("all_to_all", x, sched)))
    else:
        E.execute_compiled(buf, compiled)
        assert torch.equal(_bits(buf), _bits(P.execute_schedule_reference(state, sched)))
    torch.cuda.synchronize()
    assert torch.isnan(flat[:guard]).all() and torch.isnan(flat[guard + buf.numel():]).all()


@pytest.mark.parametrize("dtype, coll", [(torch.bfloat16, "all_reduce"), (torch.int8, "all_gather")],
                         ids=["bf16-all_reduce", "int8-all_gather"])
def test_round_kernel_past_two_to_the_31_elements(dev, dtype, coll):
    """A stacked buffer of more than 2**31 elements, moved one element a
    thread (a chunk of an odd number of elements), so that the element
    offsets pass 32 bits: bit for bit the per-round reference."""
    from repro_torch.comm import primitives as P
    from repro_torch.core import schedules as S

    c = 2**25 + 3  # elements a chunk; 64 chunks make 2**31 + 192
    g = torch.Generator(device=dev).manual_seed(2)
    if coll == "all_reduce":
        sched = S.bucket_all_reduce((2, 4), 1.0)
        x = torch.randn((8, 8 * c), generator=g, device=dev).to(dtype)
    else:
        sched = S.bucket_all_gather((2, 4), 1.0)
        x = torch.randint(-128, 128, (8, c), generator=g, device=dev, dtype=dtype)
    assert 64 * c > 2**31
    before = LAUNCHES.by_route("round")
    got = getattr(P, coll)(x, sched)
    torch.cuda.synchronize()
    assert sum(LAUNCHES.by_route("round").values()) > sum(before.values())
    want = P.run_reference(coll, x, sched)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                                   torch.int32, torch.int64],
                         ids=lambda d: str(d).rsplit(".", 1)[1])
def test_round_kernel_reduce_in_every_dtype_it_takes(dev, dtype):
    """A reduce round in each dtype the kernel adds, in 16-byte units and one
    element a thread, equals torch's ``a + b`` bit for bit; its launch is
    what the geometry export reports; a dtype it cannot add raises."""
    from repro_torch.analysis.kernel_lint import DEFAULT_SMEM_BUDGET
    from repro_torch.analysis.launch_probe import geometry_mismatches
    from repro_torch.kernels.rounds.kernel import stacked_round_cuda

    g = torch.Generator(device=dev).manual_seed(3)
    size = torch.empty(0, dtype=dtype).element_size()
    for elements in (4096 // size, 3):
        if dtype.is_floating_point:
            a, b = (torch.randn((16, elements), generator=g, device=dev).to(dtype) for _ in "ab")
        else:
            a, b = (torch.randint(-2**20, 2**20, (16, elements), generator=g, device=dev,
                                  dtype=dtype) for _ in "ab")
        ranks = torch.arange(4, device=dev).flip(0)  # receiver d reads rank 3 - d ...
        src_ids = torch.arange(8, device=dev).view(4, 2) % 2 + 2  # ... slots 2 and 3 ...
        dst_ids = torch.arange(8, device=dev).view(4, 2).flip(1) % 2  # ... into slots 1 and 0
        a, b = a.view(4, 4, elements), b.view(4, 4, elements)
        rows = torch.arange(4, device=dev)[:, None]
        want = a.clone()
        want[rows, dst_ids] = a[rows, dst_ids] + b[ranks[:, None], src_ids]
        stacked_round_cuda(b, ranks, src_ids, dst_ids, 4, 2, out=a, reduce=True, route="inplace")
        torch.cuda.synchronize()
        assert torch.equal(_bits(a), _bits(want)), elements
        _, _, problems = geometry_mismatches(stacked_round_cuda, (b, ranks, src_ids, dst_ids, 4, 2),
                                             {"reduce": True}, DEFAULT_SMEM_BUDGET)
        assert not problems, problems
    with pytest.raises(ValueError, match="no reduce"):
        t = torch.zeros((1, 2, 16), dtype=torch.int8, device=dev)
        stacked_round_cuda(t, None, None, None, 1, 1, out=t, reduce=True)


def test_round_kernel_runs_every_engine_round_of_the_layer_seams(dev):
    """The layer cell's calls at a small width: the AR+RMSNorm and the
    all-gather run every round on the kernel (their spans say so), the
    fused mm+RS's rounds stay on torch's indexing."""
    from repro_torch import PcclSession, spans
    from repro_torch.comm import fusion
    from repro_torch.core import cost_model as cm

    session = PcclSession(cm.H100_DGX, device=dev)
    comm = session.communicator("x", 8)
    ring = session.communicator("x", 8, algorithm="ring")  # the mm+RS streams its rounds
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(8, 256, 512, generator=g, device=dev).to(torch.bfloat16)
    xm = torch.randn(8, 256, 128, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(128, 512, generator=g, device=dev) / 16).to(torch.bfloat16)
    gamma = torch.ones(512, device=dev)
    fusion.fused_all_reduce_rmsnorm(comm, x, gamma)  # warm: plans and tables
    shard = fusion.fused_matmul_reduce_scatter(ring, xm, w)
    comm.all_gather(shard)
    torch.cuda.synchronize()
    before = LAUNCHES.by_route("round")
    with spans.tracing():
        fusion.fused_all_reduce_rmsnorm(comm, x, gamma)
        shard = fusion.fused_matmul_reduce_scatter(ring, xm, w)
        comm.all_gather(shard)
        torch.cuda.synchronize()
    recs = spans.records()
    after = LAUNCHES.by_route("round")
    ops = {i: s.attrs["op"] for i, s in enumerate(recs) if s.name == "collective"}
    rounds = {}
    for s in recs:
        if s.name == "round":
            rounds.setdefault(ops[s.root], []).append(s.attrs["route"])
    assert set(rounds["ar_rmsnorm"]) <= {"inplace", "staged"}
    assert set(rounds["all_gather"]) <= {"inplace", "staged"}
    assert set(rounds["mm_rs"]) == {"torch"}
    kernel_rounds = rounds["ar_rmsnorm"] + rounds["all_gather"]
    assert after["inplace"] - before["inplace"] == kernel_rounds.count("inplace")
    assert after["staged"] - before["staged"] == 2 * kernel_rounds.count("staged")
    assert after["copy"] - before["copy"] == 1  # the all-gather's diagonal store
