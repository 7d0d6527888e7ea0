"""Shared pytest configuration: marker registry + optional-dep helpers."""

import pytest


def hypothesis_or_stubs():
    """``(given, settings, st)`` — the real hypothesis API, or stand-ins that
    skip *only* the property tests so the rest of the module still runs
    (a missing optional dep must not silence plain unit tests)."""
    try:
        from hypothesis import given, settings
        from hypothesis import strategies as st

        return given, settings, st
    except ImportError:
        class _AnyStrategy:
            """Absorbs any strategy construction/chaining at import time."""

            def __getattr__(self, name):
                return self

            def __call__(self, *args, **kwargs):
                return self

        def given(*args, **kwargs):
            return pytest.mark.skip(reason="hypothesis not installed")

        def settings(*args, **kwargs):
            return lambda f: f

        return given, settings, _AnyStrategy()


@pytest.fixture
def dataflow_verifier():
    """The static chunk-dataflow verifier, raise-on-failure form.

    Every new schedule generator must pass this fixture (see
    CONTRIBUTING.md): ``dataflow_verifier(schedule)`` proves the
    collective's postcondition statically and raises
    ``ScheduleVerificationError`` with an attributable failure
    (round/rank/chunk, expected vs. abstract state) otherwise.  Pass
    ``groups=`` for ``replicate_groups`` compositions.
    """
    from repro.analysis.verify import assert_verified

    return assert_verified


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running test (multi-minute subprocess or sweep)",
    )
    config.addinivalue_line(
        "markers",
        "multidevice: drives >1 host device via an XLA_FLAGS subprocess",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); skips without one",
    )
