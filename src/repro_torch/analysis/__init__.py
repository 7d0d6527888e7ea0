"""Static analysis for schedules, plans, kernels and the port's own code.

The counterpart of ``repro.analysis``.  Four passes, no device execution:

* :mod:`repro_torch.analysis.verify` — chunk-dataflow verifier: abstract
  interpretation proving a schedule's collective postcondition.
* :mod:`repro_torch.analysis.invariants` — plan/circuit invariant checker:
  round feasibility, Alg. 3/4 realizability, Alg. 1 plan accounting,
  reconfig-mode monotonicity, concurrent joint-plan accounting.
* :mod:`repro_torch.analysis.lint_concurrency` — AST lint for the
  shared-state bug classes (unguarded cache mutation, function-attribute
  state, mutable defaults).

* :mod:`repro_torch.analysis.kernel_lint` over
  :mod:`repro_torch.analysis.launch_model` — the kernel lint: a
  pure-Python model of each CUDA and Triton launch (grid, per-block
  footprints, threads, shared memory; tile sizes read from the ``.cu``
  sources) proves every output element written by exactly one block, no
  access out of bounds past the kernel's masks, shared memory within
  Hopper's budget and as launched, and the body rules (dead parameters,
  fp32 upcasts, casts on store).  It cannot see the arithmetic, nor a
  launcher that differs from its model: the parity tests and the card's
  geometry and NaN-probe checks (``chip_smoke.py`` path 13) cover those.

``python -m repro_torch.analysis`` runs the schedule/plan passes over the
built-in generator zoo, ``--kernels`` the kernel lint over every route at
edge shapes and the main paths' shapes; ``python -m
repro_torch.analysis.lint_concurrency`` runs the lint over
``src/repro_torch``.  Set ``PCCL_VERIFY=1`` to also verify every schedule
at exec-engine compile time (``comm/exec_engine.py::compile_schedule``, on
a cache miss, before any table is built) and every kernel launch's model
before the launch (``kernels/build.py::verify_launch``, memoized).
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


def __getattr__(name):
    # lazy (PEP 562): an eager import here makes ``python -m
    # repro_torch.analysis.lint_concurrency`` warn about double execution
    if name in _LINT_EXPORTS:
        from . import lint_concurrency

        return getattr(lint_concurrency, name)
    if name in _KERNEL_EXPORTS:
        from . import kernel_lint

        return getattr(kernel_lint, name)
    if name in _MODEL_EXPORTS:
        from . import launch_model

        return getattr(launch_model, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
