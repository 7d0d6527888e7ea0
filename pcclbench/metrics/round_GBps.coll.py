"""The engine's rate on the bytes its rounds really gather: the sum of the
``round`` spans' ``bytes`` over the sum of their device intervals (each
round's CUDA events, from the stream reaching its start to its end), in
GB/s.  None on the CPU, which records no device events, and where the
program records no spans."""


def read(r):
    try:
        from repro_torch.spans import records
    except ImportError:
        return None
    rounds = [s for s in records() if s.name == "round" and s.device_start_ns is not None]
    ns = sum(s.device_end_ns - s.device_start_ns for s in rounds)
    return sum(s.attrs["bytes"] for s in rounds) / ns if ns > 0 else None
