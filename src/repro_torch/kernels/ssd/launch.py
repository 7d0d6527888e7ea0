"""K4's launch model: what each of the scan's three launches gives each block.

A pure-Python mirror of ``csrc/ssd_sm90.cu`` (wgmma),
``csrc/ssd_sm90_tiled.cu`` (wgmma_tiled) and ``csrc/ssd.cu`` (fma), with
the recurrence all three share in ``csrc/ssd_common.cuh``, line by line,
for the kernel lint (:mod:`repro_torch.analysis.kernel_lint`):

1. chunk states: one block per (b, h, chunk) — on the wgmma_tiled route one
   per P-tile of it; on the fma route the scores blocks first (four 64 x 64
   tiles of a chunk's raw C Bᵀ each, once per (b, chunk) where B and C are
   shared), then blocks of four 256 x 64 states tiles each, heads side by
   side where B and C are shared and P is 64 or 128;
2. the recurrence: one thread per element of the ``B·H`` states of
   ``P·N`` elements (on wgmma_tiled its own kernel, one thread per four
   elements, which stores each state before a chunk as a hi + lo pair), so a block's flat range crosses from one (b, h) to
   the next wherever ``P·N`` is not a multiple of its threads; its
   operands are modelled as that pass indexes them, ``states`` and
   ``before`` as ``(B·H, nc, P·N)``, ``totals`` as ``(B·H, nc)``,
   ``init`` and ``fin`` flat;
3. outputs: one block per (b, h, chunk), and P-tile on wgmma_tiled; on the
   fma route blocks of four 64 x 256 tiles (steps by X columns) each.

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
    alloc = {name: shape for name, (shape, _)
             in buffers(X.shape, N, chunk, X.dtype, route, per_head=Bm.ndim == 4).items()}
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
    return buffers(X.shape, N, chunk, X.dtype, ssd_route(X.dtype, X.shape[3], N, chunk),
                   per_head=Bm.ndim == 4)


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
    return [read(lib.pccl_ssd_geometry, k4._DTYPES[X.dtype], p, B, S, H, P, N, chunk,
                 int(Bm.ndim == 4)) for p in (1, 2, 3)]


def _chunk_of(x, H, nc):  # ssd_common.cuh:40-47, h fastest
    h = x % H
    x //= H
    return x // nc, h, x % nc  # b, h, c


def _bc(per_head, B, S, H, N):
    """Shape of B and C, and the box of chunk rows [s0, s0 + L) of head h."""
    if per_head:
        return (B, S, H, N), lambda b, h, s0, L: Box((b, s0, h, 0), (1, L, 1, N))
    return (B, S, N), lambda b, h, s0, L: Box((b, s0, 0), (1, L, N))


_FMA_CONSTANTS = ("THREADS", "TILE", "BK", "BKN", "SCORE_BK", "PAD", "WIDE", "HEADS", "SCORE_TILES",
                  "STATES_ITEMS", "OUTPUTS_ITEMS", "FILL", "STATES_STAGES", "OUTPUTS_STAGES",
                  "FACTS")


def fma_plan(B, S, H, P, N, L, per_head) -> dict:
    """``ssd.cu``'s ``Plan`` and shared memory, from the source's tile sizes:
    how the fma route cuts a scan into tiles and blocks.  Columns of a tile
    are X's columns of a head group: all ``H·P`` side by side (``flat``: B
    and C shared, P = 64 or 128), else one head's P."""
    c = source_constants(SOURCE, _FMA_CONSTANTS)
    W, T = c["WIDE"], c["TILE"]
    nc = cdiv(S, L)
    flat = not per_head and P in (64, 128)
    gm, groups = (H * P, 1) if flat else (P, H)
    lt, mt, nt = cdiv(L, T), cdiv(gm, W), cdiv(N, T)
    score_items = B * (H if per_head else 1) * nc * lt * lt
    states_items, outputs_items = B * nc * groups * mt * nt, B * nc * groups * lt * mt
    states_per = min(max(states_items // c["FILL"], 1), c["STATES_ITEMS"])  # Plan::per_block
    outputs_per = min(max(outputs_items // c["FILL"], 1), c["OUTPUTS_ITEMS"])
    xrow, brow = W + c["PAD"], T + c["PAD"]
    stage1 = max(c["BK"] * (xrow + brow), 2 * c["SCORE_BK"] * xrow)  # STAGE1
    stage3 = T * c["BKN"] + W * c["BKN"]  # STAGE3: a C and an R slice
    return dict(
        c, nc=nc, flat=flat, stage1=stage1, stage3=stage3,
        lg=(6 if P == 64 else 7) if flat else 30, gm=gm, groups=groups,
        heads=W // P if flat else 1, lt=lt, mt=mt, nt=nt, score_items=score_items,
        score_blocks=cdiv(score_items, c["SCORE_TILES"]), states_items=states_items,
        states_per=states_per, states_blocks=cdiv(states_items, states_per),
        outputs_items=outputs_items, outputs_per=outputs_per,
        outputs_blocks=cdiv(outputs_items, outputs_per),
        smem1=4 * (c["FACTS"] + c["STATES_ITEMS"] * c["HEADS"] * L
                   + c["STATES_STAGES"] * stage1),  # states_smem
        smem3=4 * (c["FACTS"] + 2 * c["OUTPUTS_ITEMS"] * c["HEADS"] * L
                   + c["OUTPUTS_STAGES"] * stage3))  # outputs_smem


def _fma_tile(pl, x, states):
    """``tile_of``: (b, c, hg, m0, r0) of tile x of pass 1 (``states``; r0
    the first N column) or pass 3 (r0 the first step of the chunk)."""
    inner, outer = (pl["nt"], pl["mt"]) if states else (pl["mt"], pl["lt"])
    a, x = x % inner, x // inner
    o, x = x % outer, x // outer
    m0, r0 = ((o, a) if states else (a, o))
    hg, x = x % pl["groups"], x // pl["groups"]
    return x // pl["nc"], x % pl["nc"], hg, m0 * pl["WIDE"], r0 * pl["TILE"]


def _fma_heads(pl, P, hg, m0):
    """The first head of a tile's columns and how many it spans."""
    return (m0 // P, pl["heads"]) if pl["flat"] else (hg, 1)


def _fma_cols(pl, P, hg, m0, lead):
    """The box of a tile's 256 X columns over (..., H, P) after ``lead``
    offsets and sizes: whole heads side by side, or P-range m0.. of head hg."""
    h0, nh = _fma_heads(pl, P, hg, m0)
    lo, ls = lead
    if pl["flat"]:
        return Box((*lo, h0, 0), (*ls, nh, P))
    return Box((*lo, hg, m0), (*ls, 1, pl["WIDE"]))


def fma_states_site(B, S, H, P, N, L, per_head, init, dt, alloc) -> CallSite:
    pl = fma_plan(B, S, H, P, N, L, per_head)
    T, nc, sb = pl["TILE"], pl["nc"], pl["score_blocks"]
    bc_shape, bc = _bc(per_head, B, S, H, N)
    last = len(bc_shape) - 1

    def score_tiles(x):  # ssd.cu scores_block: tile (b, group, c, ti, tj), SCORE_TILES a block
        out = []
        for q in range(pl["SCORE_TILES"]):
            y = x * pl["SCORE_TILES"] + q
            if y >= pl["score_items"]:
                break
            tj, y = y % pl["lt"], y // pl["lt"]
            ti, y = y % pl["lt"], y // pl["lt"]
            ch, y = y % nc, y // nc
            out.append((y // (H if per_head else 1), y % (H if per_head else 1), ch, ti, tj))
        return out

    def state_tiles(x):  # ssd_states_kernel: states_per tiles after the scores blocks
        first = (x - sb) * pl["states_per"]
        return [_fma_tile(pl, y, True)
                for y in range(first, min(first + pl["states_per"], pl["states_items"]))]

    def xs(x):  # issue: X, every step of the chunk, the tile's columns
        return [] if x < sb else [_fma_cols(pl, P, hg, m0, ((b, ch * L), (1, L)))
                                  for b, ch, hg, m0, _ in state_tiles(x)]

    def las(x):  # prepare: chunk_cumsum of each head of each tile
        out = []
        for b, ch, hg, m0, _ in ([] if x < sb else state_tiles(x)):
            h0, nh = _fma_heads(pl, P, hg, m0)
            out.append(Box((b, ch * L, h0), (1, L, nh)))
        return out

    def bs(x):  # scores: rows tj * 64.. of the chunk; states: every step, columns n0..n0+63
        if x < sb:
            return [bc(b, g, ch * L + tj * T, min(T, L - tj * T))
                    for b, g, ch, _, tj in score_tiles(x)]
        out = []
        for b, ch, hg, _, n0 in state_tiles(x):
            box = bc(b, hg, ch * L, L)
            out.append(Box((*box.offset[:-1], n0), (*box.size[:-1], T)))
        return out

    def cs(x):  # scores blocks only: rows ti * 64.. of the chunk, every column
        return [bc(b, g, ch * L + ti * T, min(T, L - ti * T))
                for b, g, ch, ti, _ in score_tiles(x)] if x < sb else []

    def states(x):  # compute's epilogue: the tile's rows (h, p), columns n0..n0+63
        out = []
        for b, ch, hg, m0, n0 in ([] if x < sb else state_tiles(x)):
            h0, nh = _fma_heads(pl, P, hg, m0)
            out.append(Box((b, h0, ch, 0, n0), (1, nh, 1, P, T)) if pl["flat"]
                       else Box((b, hg, ch, m0, n0), (1, 1, 1, pl["WIDE"], T)))
        return out

    def totals(x):  # prepare: each head's total_c, from the tile holding its row 0, n0 = 0
        out = []
        for b, ch, hg, m0, n0 in ([] if x < sb else state_tiles(x)):
            h0, nh = _fma_heads(pl, P, hg, m0)
            out += [Box((b, h, ch), (1, 1, 1)) for h in range(h0, min(h0 + nh, H))
                    if n0 == 0 and ((h - hg) << pl["lg"]) >= m0]
        return out

    def scores_tiles(x):  # scores_block's stores: (t, s) of the tile below L
        return [Box((b, g, ch, ti * T, tj * T) if per_head else (b, ch, ti * T, tj * T),
                    (1, 1, 1, T, T) if per_head else (1, 1, T, T))
                for b, g, ch, ti, tj in (score_tiles(x) if x < sb else [])]

    scores_rank = len(alloc["scores"])
    return CallSite(
        name="ssd_states_kernel", grid=(sb + pl["states_blocks"],),  # states_geometry
        in_names=("X", "la", "Bm", "Cm"),
        in_blocks=(Footprint(xs, masked=(1, 2, 3)), Footprint(las, masked=(1, 2)),
                   Footprint(bs, masked=(1, last)), Footprint(cs, masked=(1,))),
        in_shapes=((B, S, H, P), (B, S, H), bc_shape, bc_shape),
        in_dtypes=(dt, "float32", dt, dt),
        out_names=("states", "totals", "scores"),
        out_blocks=(Footprint(states, masked=(1, 3, 4)), Footprint(totals),
                    Footprint(scores_tiles, masked=(scores_rank - 2, scores_rank - 1))),
        out_shapes=(alloc["states"], alloc["totals"], alloc["scores"]),
        out_dtypes=("float32", "float32", "float32"),
        route="cuda", threads=pl["THREADS"], smem=pl["smem1"], smem_attr=pl["smem1"],
        smem_need=4 * (pl["FACTS"] + pl["STATES_ITEMS"] * pl["HEADS"] * L)  # facts, dte
        + 4 * pl["STATES_STAGES"] * pl["stage1"],  # and the ring: the body's carve-out
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
    pl = fma_plan(B, S, H, P, N, L, per_head)
    T, nc = pl["TILE"], pl["nc"]
    bc_shape, bc = _bc(per_head, B, S, H, N)

    def tiles(x):  # ssd_outputs_kernel: outputs_per tiles a block
        first = x * pl["outputs_per"]
        return [_fma_tile(pl, y, False)
                for y in range(first, min(first + pl["outputs_per"], pl["outputs_items"]))]

    def xs(x):  # issue: X, every step of the chunk (W X), the tile's columns
        return [_fma_cols(pl, P, hg, m0, ((b, ch * L), (1, L))) for b, ch, hg, m0, _ in tiles(x)]

    def ys(x):  # compute's epilogue: steps t0..t0+63 below L and S, the tile's columns
        return [_fma_cols(pl, P, hg, m0, ((b, ch * L + t0), (1, min(T, L - t0))))
                for b, ch, hg, m0, t0 in tiles(x)]

    def las(x):  # prepare: chunk_cumsum of each head of each tile
        out = []
        for b, ch, hg, m0, _ in tiles(x):
            h0, nh = _fma_heads(pl, P, hg, m0)
            out.append(Box((b, ch * L, h0), (1, L, nh)))
        return out

    def cs(x):  # issue: C rows t0..t0+63 of the chunk, every N-slice
        return [bc(b, hg, ch * L + t0, min(T, L - t0)) for b, ch, hg, _, t0 in tiles(x)]

    def ws(x):  # issue: the scores' rows t0..t0+63 (below L), every column
        return [Box((b, hg, ch, t0, 0), (1, 1, 1, T, L)) if per_head
                else Box((b, ch, t0, 0), (1, 1, T, L)) for b, ch, hg, _, t0 in tiles(x)]

    def rs(x):  # issue: R^T, the state before the chunk of each of the tile's columns
        out = []
        for b, ch, hg, m0, _ in tiles(x):
            h0, nh = _fma_heads(pl, P, hg, m0)
            out.append(Box((b, h0, ch, 0, 0), (1, nh, 1, P, N)) if pl["flat"]
                       else Box((b, hg, ch, m0, 0), (1, 1, 1, pl["WIDE"], N)))
        return out

    scores_rank = len(alloc["scores"])
    return CallSite(
        name="ssd_outputs_kernel", grid=(pl["outputs_blocks"],),  # outputs_geometry
        in_names=("X", "la", "Cm", "scores", "before"),
        in_blocks=(Footprint(xs, masked=(1, 2, 3)), Footprint(las, masked=(1, 2)),
                   Footprint(cs, masked=(1,)), Footprint(ws, masked=(scores_rank - 2,)),
                   Footprint(rs, masked=(1, 3))),
        in_shapes=((B, S, H, P), (B, S, H), bc_shape, alloc["scores"], alloc["before"]),
        in_dtypes=(dt, "float32", dt, "float32", "float32"),
        out_names=("Y",), out_blocks=(Footprint(ys, masked=(1, 2, 3)),),
        out_shapes=(alloc["Y"],), out_dtypes=(dt,),
        route="cuda", threads=pl["THREADS"], smem=pl["smem3"], smem_attr=pl["smem3"],
        smem_need=4 * (pl["FACTS"] + 2 * pl["OUTPUTS_ITEMS"] * pl["HEADS"] * L)  # cum, exp
        + 4 * pl["OUTPUTS_STAGES"] * pl["stage3"],  # and the ring: the body's carve-out
        kernel=CudaKernel(SOURCE, "ssd_outputs_kernel"),
        source=repo_path(SOURCE), line=launch_line(SOURCE, "ssd_outputs_kernel"),
    )


def fma_feed(B, S, H, P, N, L, per_head) -> dict:
    """What feeds the FMAs of the fma route's products at a shape, from the
    source's tile sizes: a lane's register tile (rows, columns) in a warp's
    32 x TILE tile; for each product of passes 1 and 3 the 16-byte shared
    loads of one reduction step and the FMAs they feed; the rings' stages,
    a block's shared memory in passes 1 and 3, and each pass's blocks."""
    pl = fma_plan(B, S, H, P, N, L, per_head)
    tile = (32 // 4, pl["TILE"] // 8)  # lanes (ty, tx) = (lane >> 3, lane & 7)
    step = (tile[0] // 4 + tile[1] // 4, tile[0] * tile[1])  # float4 of A and of B a step
    return dict(tile=tile, products={p: step for p in ("states", "scores", "C R^T", "W X")},
                stages=(pl["STATES_STAGES"], pl["OUTPUTS_STAGES"]),
                smem=(pl["smem1"], pl["smem3"]),
                blocks=(pl["score_blocks"] + pl["states_blocks"], pl["outputs_blocks"]),
                flat=pl["flat"])


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
