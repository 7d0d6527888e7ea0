"""Host µs a collective call spends finding or building its schedule and
tables: the program's ``plan`` spans (the session's plan cache, schedule
compiles, device tables, the stream program and its upload) inside each
top-level ``collective`` span, per call, over the traced window's calls.
None where the program records no spans."""


def read(r):
    try:
        from repro_torch.spans import records
    except ImportError:
        return None
    spans = records()
    calls = {i for i, s in enumerate(spans) if s.name == "collective" and s.parent is None}
    if not calls:
        return None
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "plan" and s.root in calls)
    return ns / 1e3 / len(calls)
