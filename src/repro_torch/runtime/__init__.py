"""Fault tolerance: failure injection, link failures, stragglers (``repro.runtime``)."""
from .fault import (  # noqa: F401
    FailureInjector,
    InjectedFailure,
    LinkFailure,
    StragglerConfig,
    StragglerDetector,
    fail_link,
    replan_after_failure,
    reshard_tree,
    shrink_mesh,
)
