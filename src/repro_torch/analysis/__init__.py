"""Static analysis for schedules, plans and the port's own code.

A copy of ``repro.analysis`` but for its Pallas kernel analyzer.  Three
passes, no device execution:

* :mod:`repro_torch.analysis.verify` — chunk-dataflow verifier: abstract
  interpretation proving a schedule's collective postcondition.
* :mod:`repro_torch.analysis.invariants` — plan/circuit invariant checker:
  round feasibility, Alg. 3/4 realizability, Alg. 1 plan accounting,
  reconfig-mode monotonicity, concurrent joint-plan accounting.
* :mod:`repro_torch.analysis.lint_concurrency` — AST lint for the
  shared-state bug classes (unguarded cache mutation, function-attribute
  state, mutable defaults).

The reference's fourth pass, the Pallas kernel analyzer (``kernel_lint``
and ``pallas_model``), captures ``pl.pallas_call`` grids; the port's
kernels are CUDA C++ and Triton, and their lint is ROADMAP item 15.  Its
names raise :class:`AttributeError` here, and ``python -m
repro_torch.analysis --kernels`` exits non-zero, each citing that item.

``python -m repro_torch.analysis`` runs the schedule/plan passes over the
built-in generator zoo; ``python -m repro_torch.analysis.lint_concurrency``
runs the lint over ``src/repro_torch``.  Set ``PCCL_VERIFY=1`` to also
verify every schedule at exec-engine compile time
(``comm/exec_engine.py::compile_schedule``, on a cache miss, before any
table is built).  The reference's per-dispatch kernel gate
(``kernels/*/ops.py``) comes with item 15.
"""

from .verify import (  # noqa: F401
    ScheduleVerificationError,
    UnverifiableScheduleError,
    VerificationResult,
    Violation,
    assert_verified,
    verify_schedule,
)
from .invariants import (  # noqa: F401
    InvariantViolation,
    PlanInvariantError,
    assert_invariants,
    check_circuit_realizability,
    check_concurrent_plan,
    check_mode_monotonicity,
    check_plan,
    check_round_feasibility,
    check_schedule,
)
_LINT_EXPORTS = ("Finding", "lint_module", "lint_paths")
# the reference's Pallas kernel analyzer: not ported until ROADMAP item 15
_KERNEL_EXPORTS = (
    "KernelLintError",
    "KernelReport",
    "KernelSummary",
    "KernelViolation",
    "analyze_call_site",
    "analyze_callable",
    "assert_kernel_clean",
    "shipped_kernel_cases",
    "summarize_kernel",
    "verify_entry_point",
)
_MODEL_EXPORTS = ("BlockModel", "Box", "CallSite", "CaptureError",
                  "capture_call_sites", "whole_array_box")
KERNEL_LINT_GAP = (
    "the Pallas kernel analyzer (repro.analysis.kernel_lint / pallas_model) is not "
    "ported: a kernel lint for the port's CUDA C++ and Triton kernels is ROADMAP item 15"
)


def __getattr__(name):
    # lazy (PEP 562): an eager import here makes ``python -m
    # repro_torch.analysis.lint_concurrency`` warn about double execution
    if name in _LINT_EXPORTS:
        from . import lint_concurrency

        return getattr(lint_concurrency, name)
    if name in _KERNEL_EXPORTS or name in _MODEL_EXPORTS:
        raise AttributeError(f"{__name__}.{name}: {KERNEL_LINT_GAP}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
