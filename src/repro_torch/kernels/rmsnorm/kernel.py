"""K2 on the card: RMSNorm × weight as a Triton kernel.

Replaces ``repro.kernels.rmsnorm.kernel.rmsnorm_pallas`` (body
``_rmsnorm_kernel``): row-wise ``x · rsqrt(Σx²/d + eps) · w`` in fp32, cast
to ``x.dtype`` on store, rows flattened to ``(rows, d)``.

What bounds it on an H100: it does a few operations per element and moves
every element twice (one read, one write), so it is bound by device memory
bandwidth (3.35 TB/s); the least time is ``2 · rows · d · itemsize`` bytes
over that rate.  What the design does about it: one program per row loads
the whole row once into registers (a masked ``next_pow2(d)`` block), reduces
it there and stores it once, so each byte crosses device memory exactly
once each way.  The TPU kernel padded lanes to 128 with zeros; the masked
load reads zeros there instead, and the sum is divided by the true ``d``.

Triton is imported, and the kernel compiled, at the first launch, never
when this module is imported.  :data:`~repro_torch.kernels.build.LAUNCHES`
counts its launches under ``"rmsnorm"`` (route ``"triton"``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.build import LAUNCHES, verify_launch

_DTYPES = (torch.float32, torch.bfloat16)

# ``triton.language``, bound at the first launch: the kernel body below is
# parsed by Triton, which resolves ``tl`` in this module's globals
tl = None
_JIT = None


def _rmsnorm_kernel(x_ptr, w_ptr, o_ptr, d, eps, BLOCK: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    offs = tl.arange(0, BLOCK)
    mask = offs < d
    x = tl.load(x_ptr + row * d + offs, mask=mask, other=0.0).to(tl.float32)
    w = tl.load(w_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    # masked lanes load 0.0 and add nothing; divide by the true d
    var = tl.sum(x * x, axis=0) / d
    y = x * tl.rsqrt(var + eps) * w
    tl.store(o_ptr + row * d + offs, y.to(o_ptr.dtype.element_ty), mask=mask)


def _jit():
    global tl, _JIT
    if _JIT is None:
        import triton
        import triton.language

        tl = triton.language
        _JIT = triton.jit(_rmsnorm_kernel)
    return _JIT


def check_operands(x: torch.Tensor, w: torch.Tensor) -> None:
    """The preconditions of ``rmsnorm_pallas``, with its messages."""
    d = x.shape[-1] if x.ndim else 0
    if d == 0:
        raise ValueError(f"rmsnorm: feature dim is 0 (shape {tuple(x.shape)})")
    if x.numel() // d == 0:
        raise ValueError(f"rmsnorm: input has no rows (shape {tuple(x.shape)})")
    if w.numel() != d:
        raise ValueError(f"rmsnorm: weight size {w.numel()} != feature dim {d}")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise ValueError(
            f"rmsnorm: need float32 or bfloat16, got {x.dtype} and {w.dtype}"
        )


def _next_pow2(v: int) -> int:
    return 1 << (v - 1).bit_length()


def launch_geometry(rows: int, d: int) -> Tuple[Tuple[int], int, int]:
    """What :func:`rmsnorm_triton` launches for ``rows`` rows of ``d``:
    the grid (one program per row), ``BLOCK`` (the row, masked to a power
    of two) and ``num_warps``.  The kernel lint's launch model reads the
    same function."""
    block = _next_pow2(d)
    return (rows,), block, max(1, min(16, block // 1024))


def rmsnorm_triton(
    x: torch.Tensor,
    w: torch.Tensor,
    *,
    eps: float = 1e-5,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """RMSNorm of every row of ``x`` by the Triton kernel.

    Takes contiguous CUDA tensors on one device and raises on anything
    else.  ``out`` (optional, same shape and dtype as ``x``) receives the
    result; it may be ``x`` itself, since each program reads its whole row
    before it writes it.
    """
    check_operands(x, w)
    verify_launch("rmsnorm:triton", rmsnorm_triton, (x, w), {"eps": eps})
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(
            f"rmsnorm_triton: need x and w on one CUDA device, got {x.device} "
            f"and {w.device}"
        )
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm_triton: x and w must be contiguous")
    if out is None:
        out = torch.empty_like(x)
    elif (out.shape != x.shape or out.dtype != x.dtype or out.device != x.device
          or not out.is_contiguous()):
        raise ValueError("rmsnorm_triton: out must be a contiguous tensor like x")
    d = x.shape[-1]
    grid, block, num_warps = launch_geometry(x.numel() // d, d)
    kernel = _jit()
    with torch.cuda.device(x.device):
        kernel[grid](x, w, out, d, float(eps), BLOCK=block, num_warps=num_warps)
    LAUNCHES.record("rmsnorm", "triton")
    return out
