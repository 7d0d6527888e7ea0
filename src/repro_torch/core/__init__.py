"""PCCL core — the paper's planner, copied from ``repro.core`` unchanged.

These modules are numpy (plus lazily imported scipy) and never touched a
device; the port keeps its own copy so that it imports nothing of the JAX
package.  A copy must give the same ``Schedule.fingerprint()``, algorithm
choice and plan cost as the original (``tests/test_torch_planner.py``).

Layers:
* ``topology``   — circuit-graph zoo (ring/torus/grid/hypercube/ideal).
* ``schedules``  — collective algorithm round schedules (ring, RHD, bucket,
                   swing, DEX, direct, p2p) with chunk-level semantics.
* ``cost_model`` — extended α–β model with congestion + dilation (Alg. 2).
* ``planner``    — the reconfiguration scheduler (Alg. 1) as an exact DP,
                   plus brute-force and MILP oracles.
* ``pccl``       — user-facing planning facade.

``simulate``, ``circuits`` and ``fibers`` are not copied yet.
"""

from .cost_model import (
    H100_DGX,
    PRESETS,
    TPU_V5E_OCS,
    TPU_V5E_PHOTONIC,
    HardwareParams,
    RoundCost,
    ScheduleCost,
    comm_cost_round,
    compressed_ef_error_bound,
    ideal_cost,
    reconfig_cost,
    schedule_cost_fixed,
)
from .pccl import (
    CollectiveRequest,
    PcclPlan,
    baseline_cost,
    choose_algorithm,
    plan_collective,
    plan_collective_sweep,
    theoretical_cost,
)
from .planner import (
    Plan,
    PlanStep,
    PlanStructure,
    build_structure,
    plan,
    plan_bruteforce,
    plan_milp,
    plan_sweep,
)
from .schedules import Round, Schedule, Transfer, get_schedule, split_for_fanout
from .topology import (
    Topology,
    from_transfers,
    fully_connected,
    grid2d,
    grid3d,
    hypercube,
    line,
    ring,
    standard_topologies,
    topology_by_name,
    torus2d,
    torus3d,
)

__all__ = [k for k in dir() if not k.startswith("_")]
