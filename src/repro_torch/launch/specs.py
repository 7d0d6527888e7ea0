"""Meta-device DTensor input builders for every (arch × shape) cell
(``repro.launch.specs``).

``batch_specs`` / ``decode_specs`` / ``param_specs`` return DTensors whose
global shapes are the cell's and whose placements come from
:func:`repro_torch.sharding.spec_for` (fit-or-drop against the shape), with
each rank's local shard a meta tensor: nothing is ever allocated.  They are
the reference's sharding-annotated ``ShapeDtypeStruct`` s.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import build_model
from repro_torch.models.module import ParamSpec, ParamTree, axes_of, children, shapes_of
from repro_torch.sharding import partition


def local_shape(shape: Sequence[int], place, mesh: DeviceMesh) -> Tuple[int, ...]:
    """Rank 0's shard of a tensor of global ``shape`` under ``place``: each
    sharded dimension split in mesh order, the first chunk the largest
    (``torch.chunk``'s sizes, as DTensor splits)."""
    out = list(shape)
    for mesh_dim, p in enumerate(place):
        if isinstance(p, Shard):
            out[p.dim] = math.ceil(out[p.dim] / mesh.size(mesh_dim))
    return tuple(out)


def local_numel(shape: Sequence[int], axes, mesh: DeviceMesh, rules) -> int:
    """Elements rank 0 holds of a tensor of ``shape`` with logical ``axes``."""
    with partition._installed(mesh, rules):
        spec = partition.spec_for(axes, tuple(shape))
    return math.prod(local_shape(shape, partition.placements(spec, len(shape), mesh), mesh))


def meta_dtensor(shape: Sequence[int], dtype: torch.dtype, axes, mesh: DeviceMesh, rules) -> DTensor:
    """A DTensor of global ``shape`` placed by ``spec_for(axes, shape)``,
    its local shard on the meta device."""
    shape = tuple(int(s) for s in shape)
    with partition._installed(mesh, rules):
        spec = partition.spec_for(axes, shape)
    place = partition.placements(spec, len(shape), mesh)
    local = torch.empty(local_shape(shape, place, mesh), dtype=dtype, device="meta")
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh, rules) -> Dict[str, Any]:
    """Training / prefill batch."""
    B, S = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {}
    if cfg.vlm:
        n_img = cfg.vlm.n_img_tokens
        out["tokens"] = meta_dtensor((B, S - n_img), torch.int64, ("batch", "seq"), mesh, rules)
        out["img_embeds"] = meta_dtensor((B, n_img, cfg.d_model), torch.bfloat16,
                                         ("batch", None, "act_embed"), mesh, rules)
    else:
        out["tokens"] = meta_dtensor((B, S), torch.int64, ("batch", "seq"), mesh, rules)
    if cfg.enc_dec:
        out["enc_frames"] = meta_dtensor((B, cfg.enc_dec.enc_seq, cfg.d_model), torch.bfloat16,
                                         ("batch", None, "act_embed"), mesh, rules)
    return out


def _zip_state(fn, state, axes):
    """``fn(leaf, leaf_axes)`` over a decode-state tree and its axes tree
    (dicts and named tuples)."""
    if isinstance(state, torch.Tensor):
        return fn(state, axes)
    if isinstance(state, dict):
        return {k: _zip_state(fn, v, axes[k]) for k, v in state.items()}
    return type(state)(*(_zip_state(fn, v, a) for v, a in zip(state, axes)))


def whole_shapes():
    """A block whose tensors a count does not see: the whole (meta) tensors
    a placed state is shaped from are no storage a rank holds."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


def state_specs(state, axes, mesh: DeviceMesh, rules):
    """A tree of (meta) tensors as meta DTensors of the same shapes and
    dtypes placed by the tree of logical ``axes``: only each rank's part is
    made."""
    return _zip_state(lambda t, ax: meta_dtensor(t.shape, t.dtype, ax, mesh, rules), state, axes)


def decode_state_specs(model, batch: int, max_len: int, mesh: DeviceMesh, rules):
    """``model.init_decode_state(batch, max_len)`` as meta DTensors placed
    by ``model.decode_state_axes()``."""
    with whole_shapes():
        state = model.init_decode_state(batch, max_len, device="meta")
    return state_specs(state, model.decode_state_axes(), mesh, rules)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, mesh: DeviceMesh, rules):
    """(tokens, state) for one decode step at the cell's cache length."""
    B, S = shape.global_batch, shape.seq_len
    tokens = meta_dtensor((B, 1), torch.int64, ("batch", None), mesh, rules)
    return tokens, decode_state_specs(build_model(cfg), B, S, mesh, rules)


def param_specs(cfg: ModelConfig, mesh: DeviceMesh, rules):
    """(parameter tree of meta DTensors, ``{name: Sharding}``)."""
    model = build_model(cfg)
    specs = model.specs()

    def build(node):
        if isinstance(node, ParamSpec):
            return meta_dtensor(node.full_shape, torch.float32, node.full_axes, mesh, rules)
        if isinstance(node, list):
            return [build(v) for _, v in children(node)]
        return {k: build(v) for k, v in node.items()}

    shardings = partition.param_sharding(axes_of(specs), mesh, rules,
                                         shapes_tree=shapes_of(specs))
    return ParamTree(build(specs)), shardings
