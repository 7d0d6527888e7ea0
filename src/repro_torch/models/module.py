"""Parameter trees of the port's models: specs, initializers, ``ParamTree``.

The reference's init functions return trees of ``Box`` (an array plus its
logical axes).  Here an init function returns a tree of :class:`ParamSpec`
— a shape and how to fill it — and :func:`init_tree` materializes that tree
with an explicit ``torch.Generator`` on an explicit device.  The shapes are
known without drawing a number, which is what weight conversion checks
against (:func:`shapes_of`).  Logical axes wait until sharding is ported: on
one device the reference's ``shard`` is a no-op.

A materialized tree is a :class:`ParamTree`, an ``nn.Module`` whose
``state_dict`` keys are the reference tree's paths joined by ``.``
(``mamba.p.in_proj``, ``shared.attn.wq``), with the reference's stacked
``(L, …)`` layer layout, so carrying weights across is a copy name for name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

Device = Union[str, torch.device]


@dataclass(frozen=True)
class ParamSpec:
    """One parameter: its shape and its initializer.

    ``kind`` is ``normal`` (truncated normal on [-2, 2] times ``scale``),
    ``zeros``, ``ones`` or ``const`` (``value()`` gives the tensor).
    ``layers`` > 0 stacks that many independent draws along a new leading
    axis (the reference's ``stack_init``).
    """

    shape: Tuple[int, ...]
    kind: str
    scale: float = 1.0
    value: Optional[Callable[[], torch.Tensor]] = None
    layers: int = 0

    @property
    def full_shape(self) -> Tuple[int, ...]:
        return ((self.layers,) if self.layers else ()) + tuple(self.shape)


# ------------------------------------------------------------- initializers


def normal_init(shape, *, scale: Optional[float] = None,
                fan_in: Optional[int] = None) -> ParamSpec:
    """Truncated normal with ``1/sqrt(fan_in)`` scale (fan_in = shape[0]
    unless given), as the reference's ``normal_init``."""
    if scale is None:
        fi = fan_in if fan_in is not None else shape[0]
        scale = 1.0 / math.sqrt(max(fi, 1))
    return ParamSpec(tuple(shape), "normal", scale=float(scale))


def zeros_init(shape) -> ParamSpec:
    return ParamSpec(tuple(shape), "zeros")


def ones_init(shape) -> ParamSpec:
    return ParamSpec(tuple(shape), "ones")


def const_init(value: Callable[[], torch.Tensor]) -> ParamSpec:
    """A fixed fp32 tensor; ``value`` is called when the tree is built."""
    return ParamSpec(tuple(value().shape), "const", value=value)


def stack_init(tree, n: int):
    """The tree of ``n`` independently drawn layers, stacked on a leading axis."""
    if isinstance(tree, ParamSpec):
        return replace(tree, layers=n)
    return {k: stack_init(v, n) for k, v in tree.items()}


def _truncated_normal(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] by inverting the CDF, as
    ``jax.random.truncated_normal`` does (the streams differ)."""
    def cdf(z: float) -> float:
        return (1.0 + math.erf(z / math.sqrt(2.0))) / 2.0

    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(cdf(-2.0), cdf(2.0), generator=generator)
    return u.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)


def _materialize(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    shape = spec.full_shape
    if spec.kind == "normal":
        return _truncated_normal(shape, generator, device).mul_(spec.scale)
    if spec.kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    if spec.kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if spec.kind == "const":
        return spec.value().to(device=device, dtype=torch.float32).expand(shape).contiguous()
    raise ValueError(f"unknown initializer {spec.kind!r}")


# -------------------------------------------------------------- ParamTree


class ParamTree(nn.Module):
    """Nested parameters, read like the reference's dict tree.

    ``tree["mamba"]["p"]["in_proj"]`` is a tensor, ``tree["mamba"]`` a
    subtree; ``dict(tree)`` gives one level.  Parameters carry no gradient
    (this slice serves; training comes with ROADMAP item 11).
    """

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        self._names = list(tree)
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def keys(self):
        return list(self._names)

    def items(self):
        return [(k, self[k]) for k in self._names]

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor]) -> "ParamTree":
        """The tree whose ``state_dict()`` is ``state`` (keys ``a.b.c``)."""
        nested: Dict[str, Any] = {}
        for key, value in state.items():
            node = nested
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value
        return cls(nested)


def init_tree(tree, generator: torch.Generator, device: Device) -> ParamTree:
    """Materialize a spec tree, depth first in key order, on ``device``.

    ``generator`` must live on ``device`` (a CUDA generator for CUDA)."""
    device = torch.device(device)

    def build(node):
        if isinstance(node, ParamSpec):
            return _materialize(node, generator, device)
        return {k: build(v) for k, v in node.items()}

    return ParamTree(build(tree))


def shapes_of(tree, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    """Flat ``{"a.b.c": shape}`` of a spec tree, in ``state_dict`` order."""
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, ParamSpec):
            out[name] = v.full_shape
        else:
            out.update(shapes_of(v, name + "."))
    return out


def layer(tree, i: int):
    """Layer ``i`` of a stacked tree, as a nested dict of views."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer(v, i) for k, v in tree.items()}


def param_count(tree) -> int:
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    return sum(math.prod(s) for s in shapes_of(tree).values())
