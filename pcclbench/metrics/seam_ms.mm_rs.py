"""Device ms of one fused matmul → reduce-scatter call: the kernels its
span launched (K1 and the rounds), per call, from the trace."""


def read(r):
    if r.trace is None or not r.trace.span_count.get("mm_rs"):
        return None
    s = r.trace.span_device_s["mm_rs"]
    return 1e3 * s / r.trace.span_count["mm_rs"] if s > 0 else None
