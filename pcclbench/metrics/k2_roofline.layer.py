"""K2's share of its roofline: RMSNorm's least time (its bytes at 3.35
TB/s), over the device time of the kernels named as K2 in the trace, in %."""


def read(r):
    if r.trace is None or not r.work.get("k2_bound_s"):
        return None
    t = r.trace.kernel_s("k2")
    return 100.0 * r.work["k2_bound_s"] / t if t > 0 else None
