"""K1's launch model: what each of its two CUDA launches gives each block.

A pure-Python mirror of ``csrc/matmul_sm90.cu`` (wgmma) and
``csrc/matmul.cu`` (fma), line by line, for the kernel lint
(:mod:`repro_torch.analysis.kernel_lint`): the grid, the block's
footprints in x, w and out, its threads and shared memory.  Tile sizes are
read from the sources.  No device is touched.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.launch_model import (
    Box, CallSite, CudaKernel, Footprint, cdiv, dtype_name, launch_line, repo_path,
    source_constants,
)
from repro_torch.kernels.matmul import kernel as k1
from repro_torch.kernels.matmul.kernel import SOURCE, SOURCE_SM90, matmul_route


def call_sites(x, w, **_) -> List[CallSite]:
    """The launch of ``matmul_cuda(x, w)``: one site on either route."""
    M, K = x.shape
    N = w.shape[1]
    site = wgmma_site if matmul_route(x.shape, w.shape, x.dtype) == "wgmma" else fma_site
    return [site(M, N, K, dtype_name(x.dtype))]


def out_buffers(x, w, **_) -> Dict[str, tuple]:
    """(shape, dtype) of what ``matmul_cuda(x, w, out=...)`` writes."""
    return {"out": ((x.shape[0], w.shape[1]), x.dtype)}


def device_geometry(x, w, **_) -> List[dict]:
    """What the built library's ``*_geometry`` export says the launch of
    ``matmul_cuda(x, w)`` is given (:func:`~repro_torch.kernels.build.device_geometry`);
    needs the card."""
    from repro_torch.kernels.build import device_geometry as read

    M, N = x.shape[0], w.shape[1]
    lib = k1._library(matmul_route(x.shape, w.shape, x.dtype))
    if matmul_route(x.shape, w.shape, x.dtype) == "wgmma":
        return [read(lib.pccl_matmul_sm90_geometry, M, N)]
    return [read(lib.pccl_matmul_geometry, k1._DTYPES[x.dtype], M, N)]


def wgmma_site(M: int, N: int, K: int, dt: str) -> CallSite:
    c = source_constants(SOURCE_SM90, ("BM", "BN", "BK", "STAGES", "THREADS", "GROUP_M"))
    BM, BN, BK, STAGES, GROUP_M = c["BM"], c["BN"], c["BK"], c["STAGES"], c["GROUP_M"]
    stage_bytes = BM * BK * 2 + (BN // 64) * BK * 64 * 2  # matmul_sm90.cu:49-52
    smem = 1024 + STAGES * stage_bytes + 2 * STAGES * 8  # :53 SMEM_BYTES
    tiles_m, tiles_n, n_k = cdiv(M, BM), cdiv(N, BN), cdiv(K, BK)  # :100-101, 108

    def tile(bx):  # :102-107, the grouped raster: GROUP_M row tiles a group
        per_group = GROUP_M * tiles_n
        first_m = (bx // per_group) * GROUP_M
        group_m = min(GROUP_M, tiles_m - first_m)
        in_group = bx % per_group
        return (first_m + in_group % group_m) * BM, (in_group // group_m) * BN

    def x(bx):  # :132, TMA box (BK, BM) at (kt * BK, m0) for kt < n_k
        m0, _ = tile(bx)
        return [Box((m0, 0), (BM, n_k * BK))]

    def wt(bx):  # :135, TMA boxes (64, BK) at (n0 + 64 j, kt * BK)
        _, n0 = tile(bx)
        return [Box((0, n0), (n_k * BK, BN))]

    def out(bx):  # :182-194, stores guarded by row < M and col < N
        m0, n0 = tile(bx)
        return [Box((m0, n0), (BM, BN))]

    return CallSite(
        name="matmul_sm90_kernel", grid=(tiles_m * tiles_n,),  # launch_geometry
        in_names=("x", "w"), in_blocks=(Footprint(x, tma=True), Footprint(wt, tma=True)),
        in_shapes=((M, K), (K, N)), in_dtypes=(dt, dt),
        out_names=("out",), out_blocks=(Footprint(out, masked=(0, 1)),),
        out_shapes=((M, N),), out_dtypes=(dt,),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,
        smem_need=1023 + STAGES * stage_bytes + 2 * STAGES * 8,  # :95-98, base aligned to 1024
        kernel=CudaKernel(SOURCE_SM90, "matmul_sm90_kernel"),
        source=repo_path(SOURCE_SM90), line=launch_line(SOURCE_SM90, "matmul_sm90_kernel"),
    )


def fma_site(M: int, N: int, K: int, dt: str) -> CallSite:
    c = source_constants(SOURCE, ("BM", "BN", "BK", "STAGES", "THREADS", "XPAD"))
    BM, BN, BK, STAGES, XPAD = c["BM"], c["BN"], c["BK"], c["STAGES"], c["XPAD"]
    smem = 4 * STAGES * BK * (BM + XPAD + BN)  # matmul.cu SMEM_BYTES, the cp.async ring
    n_k = cdiv(K, BK)  # matmul_kernel: slices k0 = kt * BK for kt < n_k

    def x(bx, by):  # load_x: rows row0 + r, k k0 + c, copies masked by gr < M && gc < K
        return [Box((bx * BM, 0), (BM, n_k * BK))]

    def wt(bx, by):  # load_w: k k0 + r, columns col0 + c, masked by gr < K && gc < N
        return [Box((0, by * BN), (n_k * BK, BN))]

    def out(bx, by):  # the epilogue: stores guarded by gr < M and gc (+ j) < N
        return [Box((bx * BM, by * BN), (BM, BN))]

    return CallSite(
        name="matmul_kernel", grid=(cdiv(M, BM), cdiv(N, BN)),  # launch_geometry
        in_names=("x", "w"), in_blocks=(Footprint(x, masked=(0, 1)), Footprint(wt, masked=(0, 1))),
        in_shapes=((M, K), (K, N)), in_dtypes=(dt, dt),
        out_names=("out",), out_blocks=(Footprint(out, masked=(0, 1)),),
        out_shapes=((M, N),), out_dtypes=(dt,),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,  # launch's attribute
        smem_need=STAGES * 4 * (BK * (BM + XPAD) + BK * BN),  # the body's STAGES slots
        kernel=CudaKernel(SOURCE, "matmul_kernel"),
        source=repo_path(SOURCE), line=launch_line(SOURCE, "matmul_kernel"),
    )


def fma_feed(M: int, N: int, K: int) -> dict:
    """What feeds the FMAs of ``matmul_kernel`` at (M, K) @ (K, N), from the
    source's tile sizes: a thread's register tile (rows, columns), the
    16-byte shared loads of one k-step, the FMAs they feed, and a block's
    shared memory."""
    c = source_constants(SOURCE, ("BM", "BN", "THREADS"))
    warps_m = c["THREADS"] // 32 // (c["BN"] // 128)  # WARPS_N = BN / 128: warps of 128 columns
    tm, tn = c["BM"] // warps_m // 4, 128 // 8  # lanes (ty, tx) = (lane >> 3, lane & 7)
    loads = tm // 4 + tn // 4  # a0, a1 along the rows, b4[0..3] along the columns
    return dict(tile=(tm, tn), loads=loads, fmas=tm * tn, smem=fma_site(M, N, K, "float32").smem)
