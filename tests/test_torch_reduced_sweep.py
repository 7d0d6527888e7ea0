"""Every architecture's reduced config × train, prefill and decode, counted
on a fake 2 × 2 mesh (``python -m repro_torch.launch.dryrun --reduced``):
each runs, with no op falling back to gathered inputs (``ROADMAP.md`` F4),
on the running torch.  ``chip_smoke.py`` path 11d holds the card's torch
to the same."""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import dryrun as D


@pytest.fixture(scope="module", autouse=True)
def _no_group_left_behind():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(configs.ARCH_IDS))
def test_a_reduced_cell_counts_with_no_fallback(arch, kind):
    D._quiet()
    rec = D.reduced_cell(arch, kind)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["fallbacks"] == 0, rec["fallback_ops"]
    assert rec["flops"] > 0
