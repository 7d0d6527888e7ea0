"""The engine's share of its bytes roofline: the collectives' least bytes
(stacked operand read once, result written once) at 3.35 TB/s, over the
device time of every operation in the window that is not one of the port's
hand-written kernels (the engine's gathers, permutations, scatter-adds and
copies), in %."""

from pcclbench.profiled import kernel_of


def read(r):
    if r.trace is None or not r.work.get("coll_bound_s"):
        return None
    t = sum(s for name, s in r.trace.device_s.items() if kernel_of(name) is None)
    return 100.0 * r.work["coll_bound_s"] / t if t > 0 else None
