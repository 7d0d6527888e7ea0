"""Host ms a collective call spends before it returns (the benchmark's spans
around each call into the session's communicators and fusion seams), the
mean over the traced window's calls."""


def read(r):
    times = [t for ts in r.call_s.values() for t in ts]
    return 1e3 * sum(times) / len(times) if times else None
