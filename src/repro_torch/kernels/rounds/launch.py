"""The round kernel's launch model: what each block of ``csrc/rounds.cu`` is
given, for the kernel lint (:mod:`repro_torch.analysis.kernel_lint`).

The kernel moves rows by tables that are data: which row of the buffer a
pair reads and writes is not a function of the block index, so the lint
cannot follow it.  The model works in the round's *pair space* instead,
``(n, k, elements)``: block ``(tile, slot, receiver)`` reads and writes
elements ``[tile · TILE_E, (tile + 1) · TILE_E)`` of pair ``(receiver,
slot)``, masked at the row's end, and its table entries (the sending rank
at the receiver, the two slots at the pair).  The lint
proves that space covered exactly once (every element of every pair moved,
none twice) and every access in bounds.  That each pair's destination row
is a distinct row of the buffer is proven by the engine when it compiles a
schedule (``round_tables`` refuses a repeated receive slot), and the card
test that runs every collective into a buffer between NaN guard bands
checks what the tables address.  Tile sizes are read from the source.  No
device is touched.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.analysis.launch_model import (
    Box, CallSite, CudaKernel, Footprint, cdiv, dtype_name, launch_line, repo_path,
    source_constants,
)
from repro_torch.kernels.rounds import kernel as rk
from repro_torch.kernels.rounds.kernel import SOURCE, op_of, unit_of


def _unit(src, out) -> int:
    """The wrapper's unit: what the row's bytes and the bases of ``src`` and
    ``out`` (where given) allow; a meta tensor's base reads 0."""
    size = src.element_size()
    bases = (src.data_ptr(),) + (() if out is None else (out.data_ptr(),))
    return unit_of(src.shape[2] * size, size, *bases)


def call_sites(src, src_ranks, src_ids, dst_ids, n, k, *, out=None, reduce=False,
               **_) -> List[CallSite]:
    """The launch of ``stacked_round_cuda(src, src_ranks, src_ids, dst_ids, n, k,
    out=...)``."""
    c = source_constants(SOURCE, ("THREADS", "UNROLL"))
    size = src.element_size()
    E = src.shape[2]
    unit = _unit(src, out)
    tile = c["THREADS"] * c["UNROLL"] * unit // size  # elements a block takes of one pair
    tiles = cdiv(E * size // unit, c["THREADS"] * c["UNROLL"])
    dt = dtype_name(src.dtype)

    def pair(bx, by, bz):  # rounds.cu: pair = receiver * k + slot, units masked at row_units
        return [Box((bz, by, bx * tile), (1, 1, tile))]

    def rank(bx, by, bz):  # the sending rank's entry, at the receiver
        return [Box((bz,), (1,))]

    def slot(bx, by, bz):  # a slot table's entry, at the pair
        return [Box((bz * k + by,), (1,))]

    names, blocks, shapes, dtypes = ["src"], [Footprint(pair, masked=(2,))], [(n, k, E)], [dt]
    for name, table, at, entries in (("src_ranks", src_ranks, rank, n),
                                     ("src_ids", src_ids, slot, n * k),
                                     ("dst_ids", dst_ids, slot, n * k)):
        if table is not None:
            names.append(name)
            blocks.append(Footprint(at))
            shapes.append((entries,))
            dtypes.append("int64")
    if reduce:  # a reduce reads the destination before it writes it
        names.append("dst")
        blocks.append(Footprint(pair, masked=(2,)))
        shapes.append((n, k, E))
        dtypes.append(dt)
    return [CallSite(
        name="stacked_round_kernel", grid=(tiles, k, n),  # launch_geometry
        in_names=tuple(names), in_blocks=tuple(blocks), in_shapes=tuple(shapes),
        in_dtypes=tuple(dtypes),
        out_names=("dst",), out_blocks=(Footprint(pair, masked=(2,)),),
        out_shapes=((n, k, E),), out_dtypes=(dt,),
        route="cuda", threads=c["THREADS"], smem=0,
        kernel=CudaKernel(SOURCE, "stacked_round_kernel"),
        source=repo_path(SOURCE), line=launch_line(SOURCE, "stacked_round_kernel"),
    )]


def out_buffers(src, src_ranks, src_ids, dst_ids, n, k, **_) -> Dict[str, tuple]:
    """(shape, dtype) of the ``out`` a launch writes whole: ``n`` ranks of
    ``k`` slots, which the identity destination table, or one holding a
    permutation of the ``k`` slots in each rank's row, writes once each."""
    return {"out": ((n, k, src.shape[2]), src.dtype)}


def device_geometry(src, src_ranks, src_ids, dst_ids, n, k, *, out=None, reduce=False,
                    **_) -> List[dict]:
    """What the built library's geometry export says the launch is given;
    needs the card."""
    from repro_torch.kernels.build import device_geometry as read

    unit = _unit(src, out)
    return [read(rk._library().pccl_stacked_round_geometry, op_of(src.dtype, reduce), unit,
                 src.shape[2] * src.element_size() // unit, n, k)]
