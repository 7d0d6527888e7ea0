"""K3's launch model: what each of its two CUDA launches gives each block.

A pure-Python mirror of ``csrc/flash_sm90.cu`` (wgmma) and
``csrc/flash.cu`` (fma), line by line, for the kernel lint
(:mod:`repro_torch.analysis.kernel_lint`): the grid of (b·H + h, q tile)
blocks, heavy causal tiles first; each block's q and o rows, and the k/v
rows up to its causal limit, of its kv head (GQA); threads and shared
memory.  Tile sizes are read from the sources.  No device is touched.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.launch_model import (
    Box, CallSite, CudaKernel, Footprint, cdiv, dtype_name, launch_line, repo_path,
    source_constants,
)
from repro_torch.kernels.flash import kernel as k3
from repro_torch.kernels.flash.kernel import MAX_HEAD_DIM, SOURCE, SOURCE_SM90, flash_route


def call_sites(q, k, v, *, causal: bool = True, **_) -> List[CallSite]:
    """The launch of ``flash_attention_cuda(q, k, v, causal=causal)``: one
    site on either route; none for a head dim over 128 (the launcher
    refuses it)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if D > MAX_HEAD_DIM:
        return []
    site = wgmma_site if flash_route(q.dtype, D) == "wgmma" else fma_site
    return [site(B, S, T, H, K, D, bool(causal), dtype_name(q.dtype))]


def out_buffers(q, k, v, **_) -> Dict[str, tuple]:
    """(shape, dtype) of what ``flash_attention_cuda(q, k, v, out=...)`` writes."""
    return {"out": (tuple(q.shape), q.dtype)}


def device_geometry(q, k, v, **_) -> List[dict]:
    """What the built library's ``*_geometry`` export says the launch is
    given (:func:`~repro_torch.kernels.build.device_geometry`); needs the card."""
    from repro_torch.kernels.build import device_geometry as read

    B, S, H, D = q.shape
    if D > MAX_HEAD_DIM:
        return []
    route = flash_route(q.dtype, D)
    lib = k3._library(route)
    if route == "wgmma":
        return [read(lib.pccl_flash_fwd_sm90_geometry, B, S, H, D)]
    return [read(lib.pccl_flash_fwd_geometry, k3._DTYPES[q.dtype], B, S, H, D)]


def wgmma_site(B, S, T, H, K, D, causal, dt) -> CallSite:
    c = source_constants(SOURCE_SM90, ("BQ", "BKV", "THREADS"))
    BQ, BKV = c["BQ"], c["BKV"]
    box_bytes = BQ * 64 * 2  # flash_sm90.cu:54, a TMA box of BQ rows x 64 bf16
    NB = cdiv(D, 64)  # :221, 64-column boxes per row of D
    smem = 1024 + NB * box_bytes + 2 * (2 * NB * box_bytes) + 5 * 8  # :212-214 smem_bytes
    nq = cdiv(S, BQ)

    def tile(bh, y):  # :233-238
        b, h = divmod(bh, H)
        q0 = (nq - 1 - y) * BQ  # heavy (late) tiles first
        n_kv = cdiv(T, BKV)
        if causal:
            n_kv = min(n_kv, (min(q0 + BQ, S) - 1) // BKV + 1)
        return b, h, h // (H // K), q0, n_kv

    def qo(bh, y):  # :260, TMA boxes (64, 1, BQ, 1) at (64 nb, h, q0, b)
        b, h, _, q0, _ = tile(bh, y)
        return [Box((b, q0, h, 0), (1, BQ, 1, NB * 64))]

    def kv(bh, y):  # :268-269, boxes at (64 nb, kh, kt * BKV, b) for kt < n_kv
        b, _, kh, _, n_kv = tile(bh, y)
        return [Box((b, 0, kh, 0), (1, n_kv * BKV, 1, NB * 64))]

    def out(bh, y):  # :382-395, columns 8 j + c0 (+1) for j < D / 8, rows < S
        b, h, _, q0, _ = tile(bh, y)
        return [Box((b, q0, h, 0), (1, BQ, 1, 8 * (D // 8)))]

    return CallSite(
        name="flash_sm90_kernel", grid=(B * H, nq),  # launch_geometry
        in_names=("q", "k", "v"),
        in_blocks=(Footprint(qo, tma=True), Footprint(kv, tma=True), Footprint(kv, tma=True)),
        in_shapes=((B, S, H, D), (B, T, K, D), (B, T, K, D)), in_dtypes=(dt, dt, dt),
        out_names=("o",), out_blocks=(Footprint(out, masked=(1,)),),
        out_shapes=((B, S, H, D),), out_dtypes=(dt,),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,
        smem_need=1023 + NB * box_bytes + 2 * (2 * NB * box_bytes) + 5 * 8,  # :224-228
        kernel=CudaKernel(SOURCE_SM90, "flash_sm90_kernel"),
        source=repo_path(SOURCE_SM90), line=launch_line(SOURCE_SM90, "flash_sm90_kernel"),
    )


def fma_site(B, S, T, H, K, D, causal, dt) -> CallSite:
    c = source_constants(SOURCE, ("BQ", "BK", "STAGES", "THREADS"))
    BQ, BK, STAGES = c["BQ"], c["BK"], c["STAGES"]
    D4 = 4 * cdiv(D, 4)  # flash.cu d4_of
    DP = D4 + (8 if D4 & 4 else 4)  # dp_of: an odd number of 16-byte pieces a row
    VP = 32 * cdiv(D4, 32)  # vp_of: V's row, the 32-float pieces the lanes read
    smem = 4 * (BQ * DP + STAGES * BK * (DP + VP))  # smem_bytes: Q, then the K/V ring
    nq = cdiv(S, BQ)

    def tile(bh, y):  # flash_fwd_kernel's block indices and kv tile count
        b, h = divmod(bh, H)
        q0 = (nq - 1 - y) * BQ  # heavy (late) tiles first
        n_kv = cdiv(T, BK)
        if causal:
            n_kv = min(n_kv, (min(q0 + BQ, S) - 1) // BK + 1)
        return b, h, h // (H // K), q0, n_kv

    def qo(bh, y):  # load_rows of Q, the stores: rows q0 + r guarded by r < S - q0, d < D
        b, h, _, q0, _ = tile(bh, y)
        return [Box((b, q0, h, 0), (1, BQ, 1, D))]

    def kv(bh, y):  # load_rows of K and V: rows kt * BK + r for kt < n_kv, guarded by t < T
        b, _, kh, _, n_kv = tile(bh, y)
        return [Box((b, 0, kh, 0), (1, n_kv * BK, 1, D))]

    return CallSite(
        name="flash_fwd_kernel", grid=(B * H, nq),  # launch_geometry
        in_names=("q", "k", "v"),
        in_blocks=(Footprint(qo, masked=(1,)), Footprint(kv, masked=(1,)),
                   Footprint(kv, masked=(1,))),
        in_shapes=((B, S, H, D), (B, T, K, D), (B, T, K, D)), in_dtypes=(dt, dt, dt),
        out_names=("o",), out_blocks=(Footprint(qo, masked=(1,)),),
        out_shapes=((B, S, H, D),), out_dtypes=(dt,),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,
        smem_need=4 * BQ * DP + 4 * STAGES * BK * (DP + VP),  # Qs, ring: the body's carve-out
        kernel=CudaKernel(SOURCE, "flash_fwd_kernel"),
        source=repo_path(SOURCE), line=launch_line(SOURCE, "flash_fwd_kernel"),
    )


def fma_feed(D: int) -> dict:
    """What feeds the FMAs of ``flash_fwd_kernel`` at head width ``D``, from
    the source's tile sizes: a lane's score tile (rows, kv columns); in
    Q K^T the 16-byte shared loads of 4 d and the FMAs they feed; in P V
    the loads and shuffles of one kv column and the FMAs they feed; and a
    block's shared memory."""
    c = source_constants(SOURCE, ("BK", "WQ"))
    rows, cols = c["WQ"] // 4, c["BK"] // 8  # lane (ty, tx) = (lane >> 3, lane & 7)
    dm = cdiv(4 * cdiv(D, 4), 32)  # DM: the accumulator's 16-byte d-pieces a lane holds
    return dict(tile=(rows, cols), qk_loads=rows + cols, qk_fmas=4 * rows * cols,
                pv_loads=dm, pv_shuffles=rows, pv_fmas=4 * rows * dm,
                smem=fma_site(1, 1, 1, 1, 1, D, True, "float32").smem)
