"""Device ms of one fused all-reduce → RMSNorm call: the kernels its span
launched (the rounds and K2), per call, from the trace."""


def read(r):
    if r.trace is None or not r.trace.span_count.get("ar_rmsnorm"):
        return None
    s = r.trace.span_device_s["ar_rmsnorm"]
    return 1e3 * s / r.trace.span_count["ar_rmsnorm"] if s > 0 else None
