"""Production mesh builders (``repro.launch.mesh``) on ``torch.distributed``.

Functions, not module-level constants, so importing this module never touches
the process group.  Single pod = 16 × 16 = 256 ranks (data × model);
multi-pod adds a leading "pod" axis: 2 × 16 × 16 = 512 ranks.  Every
builder takes the current default process group, which the caller sets up
(``torch.distributed.init_process_group``); the dry run's is a fake group of
the mesh's size (:func:`init_fake_world`), on which nothing is allocated
and no byte moves.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def production_shape(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_fake_world(world_size: int) -> None:
    """A fake default process group of ``world_size`` ranks, this process
    rank 0 (``torch.testing._internal.distributed.fake_pg``): collectives
    return at once without moving data.  The dry run's world."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", rank=0, world_size=world_size, store=FakeStore())


def _device_type(device_type: Optional[str]) -> str:
    return device_type or resolve_device(None).type


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the current group's ranks
    (on CUDA unless ``device_type`` says otherwise)."""
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks, have {world} — run the dry run "
            f"(python -m repro_torch.launch.dryrun), which builds a fake group of {n}"
        )
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None) -> DeviceMesh:
    shape, axes = production_shape(multi_pod)
    return make_mesh(shape, axes, device_type)


def make_host_mesh(n: Optional[int] = None, axis: str = "data",
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A one-axis mesh over ``n`` ranks (the whole group by default)."""
    n = n or dist.get_world_size()
    return make_mesh((n,), (axis,), device_type)
