"""Host µs the program takes to enqueue one round of a collective: the
mean length of its ``round`` spans (the engine's rounds, the ``ring_ef8``
wire's and the fused matmul → reduce-scatter's) over the traced window.
None where the program records no spans."""


def read(r):
    try:
        from repro_torch.spans import records
    except ImportError:
        return None
    rounds = [s.end_ns - s.start_ns for s in records() if s.name == "round"]
    return sum(rounds) / len(rounds) / 1e3 if rounds else None
