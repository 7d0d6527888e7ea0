"""How far the device trailed the host inside the fused matmul →
reduce-scatter: at the start of each ``tile`` and ``round`` span of a
top-level ``mm_rs`` call, the device time its CUDA event ran at less the
host time the span opened, mean, in ms.  Near 0 the stream had drained and
the card waited for the host's enqueue.  None on the CPU and where the
program records no spans."""


def read(r):
    try:
        from repro_torch.spans import records
    except ImportError:
        return None
    spans = records()
    calls = {i for i, s in enumerate(spans)
             if s.name == "collective" and s.parent is None and s.attrs.get("op") == "mm_rs"}
    leads = [s.device_start_ns - s.start_ns for s in spans
             if s.name in ("tile", "round") and s.root in calls and s.device_start_ns is not None]
    return sum(leads) / len(leads) / 1e6 if leads else None
