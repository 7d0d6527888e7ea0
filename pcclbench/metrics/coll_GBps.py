"""Collective bytes the window completed, over the window's seconds, in GB/s.
A call's bytes are the larger of its rank-stacked operand and result; a
fused seam's, the collective operand it reduces."""


def read(r):
    b = r.work.get("coll_bytes")
    return b / r.window_s / 1e9 if b else None
