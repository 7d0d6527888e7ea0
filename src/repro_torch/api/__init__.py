"""Top-level PCCL API of the port: sessions, communicators, backends.

The front door for application code::

    from repro_torch.api import PcclSession
    from repro_torch.core import cost_model as cm

    session = PcclSession(cm.H100_DGX)                # runs on CUDA
    plan = session.plan("reduce_scatter", 256 * 2**20)   # cached + threaded

    comm = session.communicator("x", 8)               # interp backend
    y = comm.all_reduce(x)        # x: rank-stacked (8, *local) CUDA tensor
    tp = comm.split([r % 2 for r in range(8)])        # DP×TP sub-groups
"""

from repro_torch.core.pccl import ConcurrentCollectiveRequest, ConcurrentPcclPlan

from .backends import (
    Backend,
    InterpBackend,
    NativeBackend,
    SimBackend,
    get_backend,
    register_backend,
)
from .communicator import Communicator, subgroup_schedule
from .session import (
    AnyPlanRequest,
    CacheStats,
    ConcurrentPlanRequest,
    HierarchicalPlanRequest,
    PcclSession,
    PlanCache,
    PlanRequest,
    PlanSweepRequest,
    ReplanRequest,
    StructureCache,
)

__all__ = [
    "AnyPlanRequest",
    "Backend",
    "CacheStats",
    "Communicator",
    "ConcurrentCollectiveRequest",
    "ConcurrentPcclPlan",
    "ConcurrentPlanRequest",
    "HierarchicalPlanRequest",
    "InterpBackend",
    "NativeBackend",
    "PcclSession",
    "PlanCache",
    "PlanRequest",
    "PlanSweepRequest",
    "ReplanRequest",
    "SimBackend",
    "StructureCache",
    "get_backend",
    "register_backend",
    "subgroup_schedule",
]
