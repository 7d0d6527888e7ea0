"""Executable PCCL collectives of the port, on rank-stacked tensors."""

from .errors import ScheduleExecutionError
from .exec_engine import (
    CompiledSchedule,
    ExecStats,
    clear_exec_caches,
    compile_all_to_all,
    compile_schedule,
    exec_stats,
    execute_compiled,
)
from .pccl_collectives import (
    ErrorFeedbackState,
    PcclComm,
    compressed_all_reduce,
    compressed_all_reduce_ef,
)
from .primitives import (
    all_gather,
    all_reduce,
    all_to_all,
    all_to_all_dense,
    execute_schedule,
    execute_schedule_reference,
    reduce_scatter,
    run_reference,
)

__all__ = [k for k in dir() if not k.startswith("_")]
