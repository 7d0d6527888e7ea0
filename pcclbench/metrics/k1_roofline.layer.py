"""K1's share of its roofline: the down-projection's least time (its
operations at 989 TFLOP/s or its bytes at 3.35 TB/s, the larger), over
the device time of the kernels named as K1 in the trace, in %."""


def read(r):
    if r.trace is None or not r.work.get("k1_bound_s"):
        return None
    t = r.trace.kernel_s("k1")
    return 100.0 * r.work["k1_bound_s"] / t if t > 0 else None
