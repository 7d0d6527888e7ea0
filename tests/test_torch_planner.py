"""The port's copy of the planner against the JAX package's planner.

Same ``Schedule.fingerprint()``, algorithm and plan cost for the four
collectives × n ∈ {4, 8, 16} × three buffer sizes × ``auto`` / ``ring`` on
``H100_DGX`` — the copy is numpy, so equality is exact.
"""

import pytest

pytest.importorskip("torch")

from repro.api import PcclSession as RefSession
from repro.core import cost_model as ref_cm
from repro_torch.api import PcclSession
from repro_torch.core import cost_model as cm

COLLECTIVES = ["all_reduce", "reduce_scatter", "all_gather", "all_to_all"]
SIZES = [4.0 * 2**10, 2.0 * 2**20, 96.0 * 2**20]


@pytest.mark.parametrize("algorithm", ["auto", "ring"])
@pytest.mark.parametrize("nbytes", SIZES, ids=["4KiB", "2MiB", "96MiB"])
@pytest.mark.parametrize("n", [4, 8, 16])
@pytest.mark.parametrize("collective", COLLECTIVES)
def test_plan_matches_reference(collective, n, nbytes, algorithm):
    ref = RefSession(ref_cm.H100_DGX).plan(collective, nbytes, n=n, algorithm=algorithm)
    got = PcclSession(cm.H100_DGX, device="cpu").plan(
        collective, nbytes, n=n, algorithm=algorithm
    )
    assert got.algorithm == ref.algorithm
    assert got.schedule.fingerprint() == ref.schedule.fingerprint()
    assert got.cost == ref.cost
    assert got.num_reconfigs == ref.num_reconfigs
    assert got.candidates == ref.candidates


@pytest.mark.parametrize("n", [4, 8])
def test_threaded_fabric_matches_reference(n):
    """Back-to-back plans thread the fabric state the same way."""
    ref_s = RefSession(ref_cm.H100_DGX)
    got_s = PcclSession(cm.H100_DGX, device="cpu")
    for collective in COLLECTIVES * 2:
        ref = ref_s.plan(collective, 2.0 * 2**20, n=n, algorithm="auto")
        got = got_s.plan(collective, 2.0 * 2**20, n=n, algorithm="auto")
        assert got.schedule.fingerprint() == ref.schedule.fingerprint()
        assert got.cost == ref.cost
    assert got_s.fabric(n).edges == ref_s.fabric(n).edges


def test_error_bound_matches_reference():
    for n in (2, 4, 8, 16):
        assert cm.compressed_ef_error_bound(n) == ref_cm.compressed_ef_error_bound(n)
