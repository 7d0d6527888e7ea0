"""K2's launch model: what the Triton RMSNorm gives each program.

Mirrors :func:`~repro_torch.kernels.rmsnorm.kernel.rmsnorm_triton`'s
launch for the kernel lint: the grid, ``BLOCK`` and ``num_warps`` come
from the same :func:`~repro_torch.kernels.rmsnorm.kernel.launch_geometry`
the wrapper launches with; each program reads and writes its row through
a ``BLOCK``-wide load masked at ``d``.  The kernel body, plain Python, is
the call site's kernel, so the lint's body rules read it.
"""

from __future__ import annotations

import inspect
from typing import Dict, List

from repro_torch.analysis.launch_model import (
    Box, CallSite, Footprint, dtype_name, repo_path,
)
from repro_torch.kernels.rmsnorm import kernel as k2


def out_buffers(x, w, **_) -> Dict[str, tuple]:
    """(shape, dtype) of what ``rmsnorm_triton(x, w, out=...)`` writes."""
    return {"out": (tuple(x.shape), x.dtype)}


def device_geometry(x, w, *, eps: float = 1e-5, **_) -> List[dict]:
    """What Triton compiles and launches for ``rmsnorm_triton(x, w)``: the
    grid the wrapper passes, and from the compiled kernel its threads
    (``num_warps`` x 32) and shared memory.  Reads only shapes and dtypes:
    it compiles by launching the kernel once on one zero row of width ``d``
    (the compiled kernel depends on ``BLOCK`` and ``num_warps``, not on the
    rows), on the card, outside the launch counts."""
    import torch

    d = x.shape[-1]
    rows = 1
    for n in x.shape[:-1]:
        rows *= n
    grid, block, num_warps = k2.launch_geometry(rows, d)
    dev = x.device if x.device.type == "cuda" else torch.device("cuda")
    row = torch.zeros((1, d), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        compiled = k2._jit()[(1,)](row, torch.ones(d, dtype=w.dtype, device=dev),
                                   torch.empty_like(row), d, float(eps), BLOCK=block,
                                   num_warps=num_warps)
    meta = compiled.metadata  # Triton's launch returns the CompiledKernel it ran
    return [{"grid": tuple(grid) + (1,) * (3 - len(grid)), "threads": 32 * meta.num_warps,
             "smem": 0, "static_smem": int(meta.shared), "max_threads": 1024}]


def call_sites(x, w, **_) -> List[CallSite]:
    """The launch of ``rmsnorm_triton(x, w)``: rows of ``x`` flattened."""
    d = x.shape[-1]
    rows = 1
    for n in x.shape[:-1]:
        rows *= n
    grid, block, num_warps = k2.launch_geometry(rows, d)

    def row(r):  # kernel.py:38-41, 46: offs < d
        return [Box((r, 0), (1, block))]

    def weight(r):  # kernel.py:42
        return [Box((0,), (block,))]

    source = inspect.getsourcefile(k2)
    lines, _ = inspect.findsource(k2)
    line = next(n for n, text in enumerate(lines, 1) if "kernel[grid](" in text)
    return [CallSite(
        name="_rmsnorm_kernel", grid=grid,
        in_names=("x_ptr", "w_ptr"),
        in_blocks=(Footprint(row, masked=(1,)), Footprint(weight, masked=(0,))),
        in_shapes=((rows, d), (d,)), in_dtypes=(dtype_name(x.dtype), dtype_name(w.dtype)),
        out_names=("o_ptr",), out_blocks=(Footprint(row, masked=(1,)),),
        out_shapes=((rows, d),), out_dtypes=(dtype_name(x.dtype),),
        route="triton", threads=32 * num_warps, kernel=k2._rmsnorm_kernel,
        source=repo_path(source), line=line,
    )]
