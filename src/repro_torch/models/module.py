"""Parameter trees of the port's models: specs, initializers, ``ParamTree``.

The reference's init functions return trees of ``Box`` (an array plus its
logical axes).  Here an init function returns a tree of :class:`ParamSpec`
— a shape and how to fill it — and :func:`init_tree` materializes that tree
with an explicit ``torch.Generator`` on an explicit device.  The shapes are
known without drawing a number, which is what weight conversion checks
against (:func:`shapes_of`).  Each spec also carries the reference's
*logical axes*, one name (or ``None``) per dimension, which
:mod:`repro_torch.sharding` maps onto a device mesh (:func:`axes_of`).

A materialized tree is a :class:`ParamTree`, an ``nn.Module`` whose
``state_dict`` keys are the reference tree's paths joined by ``.``
(``mamba.p.in_proj``, ``shared.attn.wq``; a list node's entries by their
index, ``layers.ffn.shared.0.wi_gate``), with the reference's stacked
``(L, …)`` layer layout, so carrying weights across is a copy name for name.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

Device = Union[str, torch.device]
Axes = Tuple[Optional[str], ...]


@dataclass(frozen=True)
class ParamSpec:
    """One parameter: its shape and its initializer.

    ``kind`` is ``normal`` (truncated normal on [-2, 2] times ``scale``),
    ``zeros``, ``ones`` or ``const`` (``value()`` gives the tensor).
    ``axes`` are the logical axis names of ``shape``, one per dimension
    (the reference's ``Box.axes``).  ``layers`` are the stacked axes in
    front of ``shape``, outermost first: each :func:`stack_init` adds one
    (xLSTM's ``groups.mlstm`` has two, ``(G, Mg)``), every entry is an
    independent draw, and their logical axis is ``None``.
    """

    shape: Tuple[int, ...]
    axes: Axes
    kind: str
    scale: float = 1.0
    value: Optional[Callable[[], torch.Tensor]] = None
    layers: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} rank != value rank {self.shape}")

    @property
    def full_shape(self) -> Tuple[int, ...]:
        return tuple(self.layers) + tuple(self.shape)

    @property
    def full_axes(self) -> Axes:
        return (None,) * len(self.layers) + tuple(self.axes)


# ------------------------------------------------------------- initializers


def normal_init(shape, axes: Axes, *, scale: Optional[float] = None,
                fan_in: Optional[int] = None) -> ParamSpec:
    """Truncated normal with ``1/sqrt(fan_in)`` scale (fan_in = shape[0]
    unless given), as the reference's ``normal_init``."""
    if scale is None:
        fi = fan_in if fan_in is not None else shape[0]
        scale = 1.0 / math.sqrt(max(fi, 1))
    return ParamSpec(tuple(shape), tuple(axes), "normal", scale=float(scale))


def zeros_init(shape, axes: Axes) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), "zeros")


def ones_init(shape, axes: Axes) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), "ones")


def const_init(value: Callable[[], torch.Tensor], axes: Axes) -> ParamSpec:
    """A fixed fp32 tensor; ``value`` is called when the tree is built."""
    return ParamSpec(tuple(value().shape), tuple(axes), "const", value=value)


def stack_init(tree, n: int):
    """The tree of ``n`` independently drawn layers, stacked on a new leading
    axis (in front of any it already has), whose logical axis is ``None``."""
    if isinstance(tree, ParamSpec):
        return replace(tree, layers=(n, *tree.layers))
    if isinstance(tree, list):
        return [stack_init(v, n) for v in tree]
    return {k: stack_init(v, n) for k, v in tree.items()}


def _is_list(node) -> bool:
    return isinstance(node, (list, tuple)) or getattr(node, "is_list", False)


def children(node) -> Iterator[Tuple[str, Any]]:
    """(name, child) pairs of a dict or list node; a list's names are its
    indices, as ``state_dict`` keys spell them."""
    if _is_list(node):
        return ((str(i), v) for i, v in enumerate(node))
    return iter(node.items())


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
    """Nested parameters, read like the reference's tree of dicts and lists.

    ``tree["mamba"]["p"]["in_proj"]`` is a tensor, ``tree["mamba"]`` a
    subtree; ``dict(tree)`` gives one level.  A list node (DeepSeek's
    ``shared`` experts) is a subtree with ``is_list`` set: it is indexed
    by position and iterates over its entries in order.  Parameters are
    made without a gradient, which serving (under ``torch.inference_mode()``)
    never needs; training turns it on (``requires_grad_()``, as
    :func:`repro_torch.train.train_step.make_train_step` does).
    """

    def __init__(self, tree: Union[Mapping[str, Any], Sequence[Any]]):
        super().__init__()
        self.is_list = isinstance(tree, (list, tuple))
        self._names = []
        for name, value in children(tree):
            self._names.append(name)
            if isinstance(value, (Mapping, list, tuple)):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: Union[str, int]):
        if self.is_list and isinstance(name, int):
            name = self._names[name]
        if name not in self._names:
            raise KeyError(name)
        return getattr(self, name)

    def __iter__(self):
        """A list node's entries; a dict node's names, as a dict iterates."""
        return (self[k] for k in self._names) if self.is_list else iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def keys(self):
        return list(self._names)

    def items(self):
        return [(k, self[k]) for k in self._names]

    @classmethod
    def from_state_dict(cls, state: Mapping[str, torch.Tensor]) -> "ParamTree":
        """The tree whose ``state_dict()`` is ``state`` (keys ``a.b.c``); a
        node whose names are ``0 … n-1`` is a list node."""
        nested: Dict[str, Any] = {}
        for key, value in state.items():
            node = nested
            *path, leaf = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = value

        def lists(node):
            if not isinstance(node, dict):
                return node
            node = {k: lists(v) for k, v in node.items()}
            if list(node) == [str(i) for i in range(len(node))]:
                return list(node.values())
            return node

        return cls(lists(nested))


def init_tree(tree, generator: torch.Generator, device: Device) -> ParamTree:
    """Materialize a spec tree, depth first in key order, on ``device``.

    ``generator`` must live on ``device`` (a CUDA generator for CUDA)."""
    device = torch.device(device)

    def build(node):
        if isinstance(node, ParamSpec):
            return _materialize(node, generator, device)
        if isinstance(node, list):
            return [build(v) for v in node]
        return {k: build(v) for k, v in node.items()}

    return ParamTree(build(tree))


def shapes_of(tree, prefix: str = "") -> Dict[str, Tuple[int, ...]]:
    """Flat ``{"a.b.c": shape}`` of a spec tree, in ``state_dict`` order."""
    out: Dict[str, Tuple[int, ...]] = {}
    for k, v in children(tree):
        name = f"{prefix}{k}"
        if isinstance(v, ParamSpec):
            out[name] = v.full_shape
        else:
            out.update(shapes_of(v, name + "."))
    return out


def axes_of(tree, prefix: str = "") -> Dict[str, Axes]:
    """Flat ``{"a.b.c": logical axes}`` of a spec tree, in ``state_dict``
    order, the stacked layer axes first (``None``)."""
    out: Dict[str, Axes] = {}
    for k, v in children(tree):
        name = f"{prefix}{k}"
        if isinstance(v, ParamSpec):
            out[name] = v.full_axes
        else:
            out.update(axes_of(v, name + "."))
    return out


def unstack(tree) -> list:
    """The layers of a stacked tree, in order, each as nested dicts (and
    lists) of views.  One ``unbind`` per tensor: a gradient flows back into
    the stacked parameter as one stack of the layers' gradients, where
    indexing layer by layer would add one zero-padded full-size gradient a
    layer."""
    if isinstance(tree, torch.Tensor):
        return list(tree.unbind(0))
    if _is_list(tree):
        return [list(entries) for entries in zip(*(unstack(v) for v in tree))]
    names = list(tree.keys())
    return [dict(zip(names, leaves)) for leaves in zip(*(unstack(tree[k]) for k in names))]


def param_count(tree) -> int:
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    return sum(math.prod(s) for s in shapes_of(tree).values())
