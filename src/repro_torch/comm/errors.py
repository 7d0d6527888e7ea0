"""JAX-free error types shared by the schedule interpreter and backends.

Lives outside ``primitives`` so device-free code paths (the ``sim`` backend)
can raise the exact same exceptions without importing JAX.
"""

from __future__ import annotations


class ScheduleExecutionError(ValueError):
    pass
