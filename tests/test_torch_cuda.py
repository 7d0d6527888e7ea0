"""The port on the card: its CUDA and Triton kernels and its main path.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode), so
each carries the ``cuda`` marker and skips without one.  On a machine with
a card and the CUDA toolkit::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports no JAX, so it runs where only the port is installed.
Tolerances: kernel against plain version fp32 rtol 2e-5 / atol 2e-4 (K1's
fp32 sum runs in another order), bf16 2e-2; everything else bit for bit.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
    from repro_torch.kernels.matmul import matmul, matmul_cuda, matmul_reference

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(300, 520, generator=g, device=dev).to(dtype)  # ragged edges
    w = (torch.randn(520, 200, generator=g, device=dev) / math.sqrt(520)).to(dtype)
    before = matmul_cuda.launches
    got = matmul(x, w)
    assert matmul_cuda.launches == before + 1
    torch.testing.assert_close(got.float(), matmul_reference(x, w).float(), **_tol(dtype))
    chunks = torch.cat([matmul(c, w) for c in x.split(100)])
    assert torch.equal(got, chunks)  # per-chunk calls == one whole-M call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, dtype):
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_reference, rmsnorm_triton

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(33, 300, generator=g, device=dev).to(dtype)  # d off a power of 2
    w = torch.randn(300, generator=g, device=dev) + 1.0
    before = rmsnorm_triton.launches
    got = rmsnorm(x, w)
    assert rmsnorm_triton.launches == before + 1
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
    from repro_torch.kernels.matmul import matmul_cuda
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_triton

    session = PcclSession(cm.H100_DGX)
    ring = session.communicator("x", 8, algorithm="ring")
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(8, 8 * 64, 256, generator=g, device=dev).to(dtype)
    w = (torch.randn(256, 384, generator=g, device=dev) / 16).to(dtype)
    k1, fused = matmul_cuda.launches, session.exec_stats().fused_dispatches
    out = fusion.fused_matmul_reduce_scatter(ring, x, w)
    assert matmul_cuda.launches == k1 + 8  # one launch per step for all ranks
    assert session.exec_stats().fused_dispatches == fused + 1
    unfused = fusion._unfused_matmul_reduce_scatter(ring, x, w, blocks=(128, 128, 128))
    assert torch.equal(out, unfused)

    comm = session.communicator("x", 8)
    a = torch.randn(8, 64, 384, generator=g, device=dev).to(dtype)
    gamma = torch.randn(384, generator=g, device=dev) + 1.0
    k2 = rmsnorm_triton.launches
    out = fusion.fused_all_reduce_rmsnorm(comm, a, gamma)
    assert rmsnorm_triton.launches == k2 + 1
    assert torch.equal(out, rmsnorm(comm.all_reduce(a), gamma))
