"""The benchmark's tests: the checkout's ``src`` on the path, and the card
marker (a test marked ``cuda`` decides in a fixture whether there is a card)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (a CUDA kernel has no CPU mode); skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's runs measure the card")
    return torch.device("cuda", 0)


# The cells at a size a CPU test holds: every width and count cut, the
# structure (ranks, seams, kinds, the fused paths) kept.
TINY = {
    "mistral123b-tp8.layer": {"cfg": {"hidden_size": 256, "intermediate_size": 1024},
                              "traffic": {"tokens_per_rank": 64}},
    "mistral123b-tp8.colls": {"traffic": {"columns": 64, "buffer_mib": [1, 2]}},
}


@pytest.fixture
def tiny():
    return TINY


@pytest.fixture
def in_process(monkeypatch):
    """A run inside the test process: its look for forbidden modules sees
    only those the run itself loads (the process's other tests may hold
    JAX and the reference package; a fresh process holds the whole check),
    and torch on one thread, as a worker among several."""
    import torch

    from pcclbench import harness

    before = set(harness.forbidden(sys.modules))
    orig = harness.forbidden
    monkeypatch.setattr(harness, "forbidden", lambda mods: sorted(set(orig(mods)) - before))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
