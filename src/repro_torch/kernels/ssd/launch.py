"""K4's launch model: what each of the scan's three launches gives each block.

A pure-Python mirror of ``csrc/ssd_sm90.cu`` (wgmma),
``csrc/ssd_sm90_tiled.cu`` (wgmma_tiled) and ``csrc/ssd.cu`` (fma), with
the recurrence all three share in ``csrc/ssd_common.cuh``, line by line,
for the kernel lint (:mod:`repro_torch.analysis.kernel_lint`):

1. chunk states: one block per (b, h, chunk) — on the wgmma_tiled and fma
   routes one per P-tile of it, and on the fma route one more, the last of
   each chunk, that writes the chunk's masked scores instead of states;
2. the recurrence: one thread per element of the ``B·H`` states of
   ``P·N`` elements (on wgmma_tiled its own kernel, one thread per four
   elements, which stores each state before a chunk as a hi + lo pair), so a block's flat range crosses from one (b, h) to
   the next wherever ``P·N`` is not a multiple of its threads; its
   operands are modelled as that pass indexes them, ``states`` and
   ``before`` as ``(B·H, nc, P·N)``, ``totals`` as ``(B·H, nc)``,
   ``init`` and ``fin`` flat;
3. outputs: one block per (b, h, chunk) and P-tile (one P-tile at P = 64).

Tile sizes are read from the sources; the shapes of the buffers the passes
write come from what the wrapper allocates (``kernel.buffers``), so a grid
that disagrees with them shows.  No device is touched.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.launch_model import (
    Box, CallSite, CudaKernel, Footprint, cdiv, dtype_name, launch_line, repo_path, row_runs,
    source_constants,
)
from repro_torch.kernels.ssd import kernel as k4
from repro_torch.kernels.ssd.kernel import (
    SOURCE, SOURCE_SM90, SOURCE_SM90_TILED, buffers, ssd_route,
)

COMMON = SOURCE.parent / "ssd_common.cuh"


def call_sites(X, la, Bm, Cm, *, chunk: int = 64, initial_state=None, **_) -> List[CallSite]:
    """The three launches of ``ssd_cuda(X, la, Bm, Cm, chunk=..., initial_state=...)``."""
    B, S, H, P = X.shape
    N = Bm.shape[-1]
    dt = dtype_name(X.dtype)
    route = ssd_route(X.dtype, P, N, chunk)
    alloc = {name: shape for name, (shape, _) in buffers(X.shape, N, chunk, X.dtype, route).items()}
    shapes = dict(B=B, S=S, H=H, P=P, N=N, L=chunk, per_head=len(Bm.shape) == 4,
                  init=initial_state is not None, dt=dt, alloc=alloc)
    if route == "wgmma":
        return [wgmma_states_site(**shapes), recurrence_site(**shapes, route="wgmma"),
                wgmma_outputs_site(**shapes)]
    if route == "wgmma_tiled":
        return [tiled_states_site(**shapes), recurrence_site(**shapes, route="wgmma_tiled"),
                tiled_outputs_site(**shapes)]
    return [fma_states_site(**shapes), recurrence_site(**shapes, route="fma"),
            fma_outputs_site(**shapes)]


def out_buffers(X, la, Bm, Cm, *, chunk: int = 64, **_) -> Dict[str, tuple]:
    """(shape, dtype) of every buffer ``ssd_cuda(..., out=...)`` writes."""
    N = Bm.shape[-1]
    return buffers(X.shape, N, chunk, X.dtype, ssd_route(X.dtype, X.shape[3], N, chunk))


def device_geometry(X, la, Bm, Cm, *, chunk: int = 64, **_) -> List[dict]:
    """What the built library's ``*_geometry`` export says each of the three
    launches is given (:func:`~repro_torch.kernels.build.device_geometry`);
    needs the card."""
    from repro_torch.kernels.build import device_geometry as read

    B, S, H, P = X.shape
    N = Bm.shape[-1]
    route = ssd_route(X.dtype, P, N, chunk)
    lib = k4._library(route)
    if route == "wgmma":
        return [read(lib.pccl_ssd_sm90_geometry, p, B, S, H) for p in (1, 2, 3)]
    if route == "wgmma_tiled":
        return [read(lib.pccl_ssd_sm90_tiled_geometry, p, B, S, H, P, N) for p in (1, 2, 3)]
    return [read(lib.pccl_ssd_geometry, k4._DTYPES[X.dtype], p, B, S, H, P, N, chunk)
            for p in (1, 2, 3)]


def _chunk_of(x, H, nc):  # ssd_common.cuh:40-47, h fastest
    h = x % H
    x //= H
    return x // nc, h, x % nc  # b, h, c


def _bc(per_head, B, S, H, N):
    """Shape of B and C, and the box of chunk rows [s0, s0 + L) of head h."""
    if per_head:
        return (B, S, H, N), lambda b, h, s0, L: Box((b, s0, h, 0), (1, L, 1, N))
    return (B, S, N), lambda b, h, s0, L: Box((b, s0, 0), (1, L, N))


def fma_states_site(B, S, H, P, N, L, per_head, init, dt, alloc) -> CallSite:
    c = source_constants(SOURCE, ("THREADS", "TILE"))
    TILE = c["TILE"]
    nc = cdiv(S, L)
    pt, nt, lt, ptiles = min(P, TILE), min(N, TILE), min(L, TILE), cdiv(P, TILE)  # ssd.cu Widths
    smem = 4 * (2 * L + max(L * pt + L * (nt + 1), 2 * lt * (nt + 1)))  # states_smem
    bc_shape, bc = _bc(per_head, B, S, H, N)

    def role(x):  # ssd.cu:175-176, 182: P-tiles 0 .. ptiles-1, then the scores block
        tile = x % (ptiles + 1)
        b, h, ch = _chunk_of(x // (ptiles + 1), H, nc)
        return tile, tile == ptiles, b, h, ch

    def xs(x):  # :220, load_rows of rows < valid, columns p0 .. p0 + pc
        tile, scores, b, h, ch = role(x)
        return [] if scores else [Box((b, ch * L, h, tile * TILE), (1, L, 1, TILE))]

    def las(x):  # :179, chunk_cumsum of steps < valid
        _, _, b, h, ch = role(x)
        return [Box((b, ch * L, h), (1, L, 1))]

    def bs(x):  # :195-196 (scores), :221, 230 (states): rows < valid, every N-slice
        _, _, b, h, ch = role(x)
        return [bc(b, h, ch * L, L)]

    def cs(x):  # :195, the scores block only
        _, scores, b, h, ch = role(x)
        return [bc(b, h, ch * L, L)] if scores else []

    def states(x):  # :225-238, store_tile of rows < pc
        tile, scores, b, h, ch = role(x)
        return [] if scores else [Box((b, h, ch, tile * TILE, 0), (1, 1, 1, TILE, N))]

    def totals(x):  # :239, P-tile 0
        tile, _, b, h, ch = role(x)
        return [Box((b, h, ch), (1, 1, 1))] if tile == 0 else []

    def scores_tile(x):  # :185-211, every (t, s) of the chunk, 0 above the diagonal
        _, scores, b, h, ch = role(x)
        return [Box((b, h, ch, 0, 0), (1, 1, 1, L, L))] if scores else []

    return CallSite(
        name="ssd_states_kernel", grid=(B * H * nc * (ptiles + 1),),  # states_geometry
        in_names=("X", "la", "Bm", "Cm"),
        in_blocks=(Footprint(xs, masked=(1, 3)), Footprint(las, masked=(1,)),
                   Footprint(bs, masked=(1,)), Footprint(cs, masked=(1,))),
        in_shapes=((B, S, H, P), (B, S, H), bc_shape, bc_shape),
        in_dtypes=(dt, "float32", dt, dt),
        out_names=("states", "totals", "scores"),
        out_blocks=(Footprint(states, masked=(3,)), Footprint(totals), Footprint(scores_tile)),
        out_shapes=(alloc["states"], alloc["totals"], alloc["scores"]),
        out_dtypes=("float32", "float32", "float32"),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,
        smem_need=4 * (2 * L + max(L * pt + L * (nt + 1), 2 * lt * (nt + 1))),  # :170-217
        kernel=CudaKernel(SOURCE, "ssd_states_kernel"),
        source=repo_path(SOURCE), line=launch_line(SOURCE, "ssd_states_kernel"),
    )


def recurrence_site(B, S, H, P, N, L, per_head, init, dt, alloc, route) -> CallSite:
    RT = source_constants(COMMON, ("RECURRENCE_THREADS",))["RECURRENCE_THREADS"]
    BH, PN, nc = B * H, P * N, alloc["states"][2]  # chunks the buffers hold
    pair = route == "wgmma_tiled"  # ssd_sm90_tiled.cu's kernel: PAIR_VEC elements a thread,
    if pair:                       # the state before each chunk as hi and lo
        source, name = SOURCE_SM90_TILED, "ssd_recurrence_pair_kernel"
        V = source_constants(source, ("PAIR_VEC",))["PAIR_VEC"]
    else:
        source, name, V = COMMON, "ssd_recurrence_kernel", 1
    span = RT * V  # elements a block covers
    before_dt = "float32" if route == "fma" else dt

    def flat(x):  # ssd_common.cuh:98-99, 104, 121: element i, guarded by i < BH * PN
        return [Box((x * span,), (span,))]

    def runs(x):
        return row_runs(x * span, x * span + span, PN)

    def rows(x):  # :100-103, 110, 116: element e of state bh, every chunk
        return [Box((r, 0, e), (nr, nc, ne)) for r, nr, e, ne in runs(x)]

    def pairs(x):  # the pair kernel's before: hi and lo of element e of state bh, every chunk
        return [Box((r, 0, 0, e), (nr, nc, 2, ne)) for r, nr, e, ne in runs(x)]

    def chunk_totals(x):  # :102, 111
        return [Box((r, 0), (nr, nc)) for r, nr, _, _ in runs(x)]

    ins = [("states", Footprint(rows, masked=(0,)), (BH, nc, PN), "float32"),
           ("totals", Footprint(chunk_totals, masked=(0,)), (BH, nc), "float32")]
    if init:
        ins.append(("init", Footprint(flat, masked=(0,)), (BH * PN,), "float32"))
    return CallSite(
        name=name, grid=(cdiv(BH * PN // V, RT),),  # (pair_)recurrence_geometry
        in_names=tuple(i[0] for i in ins), in_blocks=tuple(i[1] for i in ins),
        in_shapes=tuple(i[2] for i in ins), in_dtypes=tuple(i[3] for i in ins),
        out_names=("before", "fin"),
        out_blocks=(Footprint(pairs if pair else rows, masked=(0,)), Footprint(flat, masked=(0,))),
        out_shapes=((BH, nc, 2, PN) if pair else (BH, nc, PN), (BH * PN,)),
        out_dtypes=(before_dt, dt),
        route="cuda", threads=RT, smem=0, kernel=CudaKernel(source, name),
        source=repo_path(source), line=launch_line(source, name),
    )


def fma_outputs_site(B, S, H, P, N, L, per_head, init, dt, alloc) -> CallSite:
    c = source_constants(SOURCE, ("THREADS", "TILE"))
    TILE = c["TILE"]
    nc = cdiv(S, L)
    pt, nt, lt, ptiles = min(P, TILE), min(N, TILE), min(L, TILE), cdiv(P, TILE)  # ssd.cu Widths
    smem = 4 * (2 * L + L * pt + lt * (L + 1) + lt * (nt + 1) + pt * (nt + 1))  # outputs_smem
    bc_shape, bc = _bc(per_head, B, S, H, N)

    def role(x):  # ssd.cu:262-263
        tile = x % ptiles
        b, h, ch = _chunk_of(x // ptiles, H, nc)
        return tile, b, h, ch

    def xy(x):  # :267 loads, :295-304 stores: rows < valid, columns p < pc
        tile, b, h, ch = role(x)
        return [Box((b, ch * L, h, tile * TILE), (1, L, 1, TILE))]

    def las(x):  # :268
        _, b, h, ch = role(x)
        return [Box((b, ch * L, h), (1, L, 1))]

    def cs(x):  # :285, rows < valid, every N-slice
        _, b, h, ch = role(x)
        return [bc(b, h, ch * L, L)]

    def ws(x):  # :273, 279, the chunk's L x L scores
        _, b, h, ch = role(x)
        return [Box((b, h, ch, 0, 0), (1, 1, 1, L, L))]

    def rs(x):  # :272, 286, rows p0 .. p0 + pc of the state before the chunk
        tile, b, h, ch = role(x)
        return [Box((b, h, ch, tile * TILE, 0), (1, 1, 1, TILE, N))]

    return CallSite(
        name="ssd_outputs_kernel", grid=(B * H * nc * ptiles,),  # outputs_geometry
        in_names=("X", "la", "Cm", "scores", "before"),
        in_blocks=(Footprint(xy, masked=(1, 3)), Footprint(las, masked=(1,)),
                   Footprint(cs, masked=(1,)), Footprint(ws), Footprint(rs, masked=(3,))),
        in_shapes=((B, S, H, P), (B, S, H), bc_shape, alloc["scores"], alloc["before"]),
        in_dtypes=(dt, "float32", dt, "float32", "float32"),
        out_names=("Y",), out_blocks=(Footprint(xy, masked=(1, 3)),),
        out_shapes=(alloc["Y"],), out_dtypes=(dt,),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,
        smem_need=4 * (2 * L + L * pt + lt * (L + 1) + lt * (nt + 1) + pt * (nt + 1)),  # :254-259
        kernel=CudaKernel(SOURCE, "ssd_outputs_kernel"),
        source=repo_path(SOURCE), line=launch_line(SOURCE, "ssd_outputs_kernel"),
    )


def wgmma_states_site(B, S, H, P, N, L, per_head, init, dt, alloc) -> CallSite:
    c = source_constants(SOURCE_SM90, ("L", "THREADS"))
    tile_bytes = c["L"] * c["L"] * 2  # ssd_sm90.cu:62 TILE, a bf16 64 x 64 tile
    smem = 1024 + 3 * tile_bytes + 16 + c["L"] * 4  # :63 STATES_SMEM
    nc = cdiv(S, L)
    bc_shape, bc = _bc(per_head, B, S, H, N)

    def xs(x):  # :139, TMA box (64, 1, L, 1) at (0, h, s0, b)
        b, h, ch = _chunk_of(x, H, nc)
        return [Box((b, ch * L, h, 0), (1, L, 1, P))]

    def bs(x):  # :140, load_bc
        b, h, ch = _chunk_of(x, H, nc)
        return [bc(b, h, ch * L, L)]

    def las(x):  # :142, chunk_cumsum of steps < valid
        b, h, ch = _chunk_of(x, H, nc)
        return [Box((b, ch * L, h), (1, L, 1))]

    def states(x):  # :185-193, the whole 64 x 64 tile
        b, h, ch = _chunk_of(x, H, nc)
        return [Box((b, h, ch, 0, 0), (1, 1, 1, P, N))]

    def totals(x):  # :194
        b, h, ch = _chunk_of(x, H, nc)
        return [Box((b, h, ch), (1, 1, 1))]

    return CallSite(
        name="ssd_states_sm90_kernel", grid=(B * H * nc,),  # states_geometry
        in_names=("X", "Bm", "la"),
        in_blocks=(Footprint(xs, tma=True), Footprint(bs, tma=True), Footprint(las, masked=(1,))),
        in_shapes=((B, S, H, P), bc_shape, (B, S, H)), in_dtypes=(dt, dt, "float32"),
        out_names=("states", "totals"),
        out_blocks=(Footprint(states), Footprint(totals)),
        out_shapes=(alloc["states"], alloc["totals"]), out_dtypes=("float32", "float32"),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,
        smem_need=1023 + 3 * tile_bytes + 16 + c["L"] * 4,  # :122-127
        kernel=CudaKernel(SOURCE_SM90, "ssd_states_sm90_kernel"),
        source=repo_path(SOURCE_SM90), line=launch_line(SOURCE_SM90, "ssd_states_sm90_kernel"),
    )


def wgmma_outputs_site(B, S, H, P, N, L, per_head, init, dt, alloc) -> CallSite:
    c = source_constants(SOURCE_SM90, ("L", "THREADS"))
    tile_bytes = c["L"] * c["L"] * 2  # ssd_sm90.cu:62 TILE
    smem = 1024 + 4 * tile_bytes + 16 + c["L"] * 4  # :64 OUTPUTS_SMEM
    nc = cdiv(S, L)
    bc_shape, bc = _bc(per_head, B, S, H, N)

    def xy(x):  # :223 load, :286-297 stores of rows < valid
        b, h, ch = _chunk_of(x, H, nc)
        return [Box((b, ch * L, h, 0), (1, L, 1, P))]

    def bcs(x):  # :224-225, load_bc of B and C
        b, h, ch = _chunk_of(x, H, nc)
        return [bc(b, h, ch * L, L)]

    def rs(x):  # :226, TMA box (64, 64) at (0, bhc * 64) of the 2-D view of before
        b, h, ch = _chunk_of(x, H, nc)
        return [Box((b, h, ch, 0, 0), (1, 1, 1, P, N))]

    def las(x):  # :228
        b, h, ch = _chunk_of(x, H, nc)
        return [Box((b, ch * L, h), (1, L, 1))]

    return CallSite(
        name="ssd_outputs_sm90_kernel", grid=(B * H * nc,),  # outputs_geometry
        in_names=("X", "Bm", "Cm", "before", "la"),
        in_blocks=(Footprint(xy, tma=True), Footprint(bcs, tma=True), Footprint(bcs, tma=True),
                   Footprint(rs, tma=True), Footprint(las, masked=(1,))),
        in_shapes=((B, S, H, P), bc_shape, bc_shape, alloc["before"], (B, S, H)),
        in_dtypes=(dt, dt, dt, dt, "float32"),
        out_names=("Y",), out_blocks=(Footprint(xy, masked=(1,)),),
        out_shapes=(alloc["Y"],), out_dtypes=(dt,),
        route="cuda", threads=c["THREADS"], smem=smem, smem_attr=smem,
        smem_need=1023 + 4 * tile_bytes + 16 + c["L"] * 4,  # :205-210
        kernel=CudaKernel(SOURCE_SM90, "ssd_outputs_sm90_kernel"),
        source=repo_path(SOURCE_SM90), line=launch_line(SOURCE_SM90, "ssd_outputs_sm90_kernel"),
    )


def _tiled_constants(pass_stages: str):
    """The tile width W (``L``) and threads of ``ssd_sm90_tiled.cu``, and
    what a block of the pass carves out of its dynamic smem past the 1024
    bytes of alignment slack (STATES_SMEM, OUTPUTS_SMEM): bf16 tiles (X and
    its lo and the ring on states, X and four a ring stage on outputs), the
    states pass's fp32 staging tile of OUT_ROW-float rows, an mbarrier a
    ring stage and X's, and the chunk's cumsum."""
    c = source_constants(SOURCE_SM90_TILED, ("L", "THREADS", "OUT_ROW", pass_stages))
    W, stages = c["L"], c[pass_stages]
    if pass_stages == "STATES_STAGES":
        tiles, staging = 2 + stages, W * c["OUT_ROW"] * 4
    else:
        tiles, staging = 1 + 4 * stages, 0
    return W, c["THREADS"], tiles * W * W * 2 + staging + 8 * (stages + 1) + W * 4


def tiled_states_site(B, S, H, P, N, L, per_head, init, dt, alloc) -> CallSite:
    W, threads, carved = _tiled_constants("STATES_STAGES")
    smem = 1024 + carved  # STATES_SMEM
    nc, ptiles = cdiv(S, L), P // W
    bc_shape, bc = _bc(per_head, B, S, H, N)

    def role(x):  # ssd_sm90_tiled.cu tile_of_block: P-tiles fastest
        b, h, ch = _chunk_of(x // ptiles, H, nc)
        return (x % ptiles) * W, b, h, ch

    def xs(x):  # tma_load_4d of X, box (64, 1, L, 1) at (p0, h, s0, b)
        p0, b, h, ch = role(x)
        return [Box((b, ch * L, h, p0), (1, L, 1, W))]

    def bs(x):  # load_bc of every N-slice (the first stages, then each refill)
        _, b, h, ch = role(x)
        return [bc(b, h, ch * L, L)]

    def las(x):  # chunk_cumsum of steps < valid
        _, b, h, ch = role(x)
        return [Box((b, ch * L, h), (1, L, 1))]

    def states(x):  # the staged float4 stores: rows p0 .. p0 + 63, every N-slice
        p0, b, h, ch = role(x)
        return [Box((b, h, ch, p0, 0), (1, 1, 1, W, N))]

    def totals(x):  # the P-tile at p0 = 0
        p0, b, h, ch = role(x)
        return [Box((b, h, ch), (1, 1, 1))] if p0 == 0 else []

    return CallSite(
        name="ssd_states_sm90_tiled_kernel", grid=(B * H * nc * ptiles,),  # states_geometry
        in_names=("X", "Bm", "la"),
        in_blocks=(Footprint(xs, tma=True), Footprint(bs, tma=True), Footprint(las, masked=(1,))),
        in_shapes=((B, S, H, P), bc_shape, (B, S, H)), in_dtypes=(dt, dt, "float32"),
        out_names=("states", "totals"),
        out_blocks=(Footprint(states), Footprint(totals)),
        out_shapes=(alloc["states"], alloc["totals"]), out_dtypes=("float32", "float32"),
        route="cuda", threads=threads, smem=smem, smem_attr=smem,
        smem_need=1023 + carved,  # the carve-out after aligning smem_raw to 1024
        kernel=CudaKernel(SOURCE_SM90_TILED, "ssd_states_sm90_tiled_kernel"),
        source=repo_path(SOURCE_SM90_TILED),
        line=launch_line(SOURCE_SM90_TILED, "ssd_states_sm90_tiled_kernel"),
    )


def tiled_outputs_site(B, S, H, P, N, L, per_head, init, dt, alloc) -> CallSite:
    W, threads, carved = _tiled_constants("OUTPUTS_STAGES")
    smem = 1024 + carved  # OUTPUTS_SMEM
    nc, ptiles = cdiv(S, L), P // W
    bc_shape, bc = _bc(per_head, B, S, H, N)

    def role(x):  # tile_of_block
        b, h, ch = _chunk_of(x // ptiles, H, nc)
        return (x % ptiles) * W, b, h, ch

    def xy(x):  # tma_load_4d of X; Y's stores of rows < valid
        p0, b, h, ch = role(x)
        return [Box((b, ch * L, h, p0), (1, L, 1, W))]

    def bcs(x):  # load_outputs_slice's load_bc of B and C, every N-slice
        _, b, h, ch = role(x)
        return [bc(b, h, ch * L, L)]

    def rs(x):  # load_outputs_slice, TMA boxes (64, 64) at (n0, 2 bhc P + p0) and P rows on
        p0, b, h, ch = role(x)
        return [Box((b, h, ch, 0, p0, 0), (1, 1, 1, 2, W, N))]

    def las(x):  # chunk_cumsum of steps < valid
        _, b, h, ch = role(x)
        return [Box((b, ch * L, h), (1, L, 1))]

    return CallSite(
        name="ssd_outputs_sm90_tiled_kernel", grid=(B * H * nc * ptiles,),  # outputs_geometry
        in_names=("X", "Bm", "Cm", "before", "la"),
        in_blocks=(Footprint(xy, tma=True), Footprint(bcs, tma=True), Footprint(bcs, tma=True),
                   Footprint(rs, tma=True), Footprint(las, masked=(1,))),
        in_shapes=((B, S, H, P), bc_shape, bc_shape, alloc["before"], (B, S, H)),
        in_dtypes=(dt, dt, dt, dt, "float32"),
        out_names=("Y",), out_blocks=(Footprint(xy, masked=(1,)),),
        out_shapes=(alloc["Y"],), out_dtypes=(dt,),
        route="cuda", threads=threads, smem=smem, smem_attr=smem,
        smem_need=1023 + carved,  # the carve-out after aligning smem_raw to 1024
        kernel=CudaKernel(SOURCE_SM90_TILED, "ssd_outputs_sm90_tiled_kernel"),
        source=repo_path(SOURCE_SM90_TILED),
        line=launch_line(SOURCE_SM90_TILED, "ssd_outputs_sm90_tiled_kernel"),
    )
