"""Logical-axis → mesh-axis sharding rules (``repro.sharding.partition``).

Model code names tensor dimensions with *logical* axes ("batch", "embed",
"heads", …).  A rule table maps logical names to mesh axes; the launcher
installs the active ``torch.distributed`` :class:`DeviceMesh` and rules in a
thread-local context, :func:`shard` constrains activations, and
:func:`param_sharding` maps parameter trees.  When no mesh is active
everything is a no-op, so the same model code runs from one device to the
2 × 16 × 16 production mesh.

Axis semantics:

* batch            → DP over ("pod", "data")
* embed / residual → FSDP over ("pod", "data") when ``fsdp=True`` (ZeRO-3)
* heads / kv_heads / mlp / experts / q_lora / vocab → TP/EP over "model"
* seq              → sequence parallelism over "model" when ``sp=True``

A spec (:data:`Spec`) is a tuple with one entry per tensor dimension:
``None`` (replicated) or the tuple of mesh axes that dimension is split
over, trailing ``None`` s dropped — the reference's ``PartitionSpec``.
:func:`placements` turns it into DTensor placements, one per mesh
dimension.  DTensor splits a tensor dimension over several mesh dimensions
in mesh order, so a spec whose axis tuple is not in mesh order raises
(:func:`default_rules` never makes one).
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.placement_types import _MaskPartial

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Optional[Tuple[str, ...]], ...]


@dataclass(frozen=True)
class Rules:
    """Mapping from logical axis names to mesh axes."""

    table: Tuple[Tuple[str, MeshAxes], ...]

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for name, axes in self.table:
            if name == logical:
                return axes
        return None

    def override(self, **kw: MeshAxes) -> "Rules":
        tab = [(k, v) for k, v in self.table if k not in kw]
        tab.extend(kw.items())
        return Rules(tuple(tab))


def default_rules(
    *,
    multi_pod: bool = False,
    fsdp: bool = True,
    sp: bool = False,
) -> Rules:
    dp: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    return Rules(
        (
            ("batch", dp),
            ("embed", dp if fsdp else None),     # FSDP shards params' embed dim
            ("act_embed", None),                  # activations keep embed local
            ("seq", ("model",) if sp else None),  # sequence parallelism
            ("heads", ("model",)),
            ("kv_heads", ("model",)),
            ("mlp", ("model",)),
            ("experts", ("model",)),
            ("expert_mlp", None),
            ("q_lora", ("model",)),
            ("kv_lora", None),
            ("vocab", ("model",)),
            ("conv", None),
            ("state", None),
            ("ssm_heads", ("model",)),
            ("ssm_inner", ("model",)),
            # decode-state axes: cache length shards over whatever the batch
            # dim doesn't claim (fit-or-drop resolves conflicts per leaf)
            ("kv_seq", ("data", "model")),
        )
    )


@dataclass
class _Ctx:
    mesh: Optional[DeviceMesh] = None
    rules: Optional[Rules] = None


_CTX = threading.local()


def _ctx() -> _Ctx:
    if not hasattr(_CTX, "v"):
        _CTX.v = _Ctx()
    return _CTX.v


class SiteCounts:
    """How many times :func:`shard` constrained a tensor under an active
    mesh, under one lock (the model's ``shard`` sites a step reaches)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._n = 0

    def record(self) -> None:
        with self._lock:
            self._n += 1

    def total(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


SITES = SiteCounts()


@contextlib.contextmanager
def use_partitioning(mesh: DeviceMesh, rules: Rules):
    """Install mesh + rules; the model's sharding helpers become active."""
    with _installed(mesh, rules):
        yield


@contextlib.contextmanager
def _installed(mesh, rules):
    prev = _ctx().mesh, _ctx().rules
    _ctx().mesh, _ctx().rules = mesh, rules
    try:
        yield
    finally:
        _ctx().mesh, _ctx().rules = prev


def active_mesh() -> Optional[DeviceMesh]:
    return _ctx().mesh


def active_rules() -> Optional[Rules]:
    return _ctx().rules


def _axis_names(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh: DeviceMesh, name: str) -> int:
    return int(mesh.shape[_axis_names(mesh).index(name)])


def spec_for(
    axes: Sequence[Optional[str]], shape: Optional[Sequence[int]] = None
) -> Spec:
    """Logical axes → spec under the active rules.

    With ``shape`` given, mesh axes that do not divide the dimension are
    dropped ("fit-or-drop"): e.g. a kv_heads=8 dim under a 16-way model axis
    replicates instead of erroring, and a batch=1 long-context decode keeps
    its batch dim unsharded.  Mesh axes are never used twice in one spec.
    """
    rules = _ctx().rules
    if rules is None:
        return ()
    mesh = _ctx().mesh
    names = None if mesh is None else _axis_names(mesh)
    used: set = set()
    parts: List[Optional[Tuple[str, ...]]] = []
    for i, a in enumerate(axes):
        ma = rules.mesh_axes(a)
        if ma is None:
            parts.append(None)
            continue
        if isinstance(ma, str):
            ma = (ma,)
        ma = tuple(m for m in ma if names is None or m in names)
        ma = tuple(m for m in ma if m not in used)
        if shape is not None and mesh is not None and ma:
            # drop trailing axes until the dim divides the shard product
            dim = shape[i]
            while ma:
                prod = math.prod(_axis_size(mesh, m) for m in ma)
                if dim % prod == 0:
                    break
                ma = ma[:-1]
        used.update(ma)
        parts.append(ma if ma else None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: Spec, ndim: int, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """DTensor placements of a tensor of rank ``ndim`` under ``spec``: one
    per mesh dimension, ``Shard(i)`` where tensor dimension ``i`` is split
    over it, else ``Replicate()``."""
    names = _axis_names(mesh)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than a rank-{ndim} tensor")
    out: List[Any] = [Replicate() for _ in names]
    for i, ma in enumerate(spec):
        if ma is None:
            continue
        idx = [names.index(m) for m in ma]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: mesh axes {ma} of dimension {i} are not in the mesh's "
                f"order {names}; DTensor splits one dimension over mesh dimensions in order"
            )
        for j in idx:
            out[j] = Shard(i)
    return tuple(out)


def _shard_sizes(spec: Spec, mesh: DeviceMesh) -> Tuple[int, ...]:
    return tuple(1 if ma is None else math.prod(_axis_size(mesh, m) for m in ma) for ma in spec)


def shard(x: torch.Tensor, axes: Sequence[Optional[str]], fit: bool = False) -> torch.Tensor:
    """Constrain an activation to the logical axes' mesh mapping.

    A no-op with no mesh active, or when ``axes`` has more entries than
    ``x`` has dimensions (caller shapes vary, e.g. flattened tokens).  A
    :class:`DTensor` is redistributed to the spec's placements.  A plain
    tensor is checked against the spec (its dimensions must split evenly)
    and returned as it is: it is a rank's whole tensor, which a one-rank
    mesh leaves where it is.  With ``fit`` the spec is fit-or-drop against
    ``x``'s shape, as a parameter's is: a mesh axis a dimension does not
    divide passes to the next dimension that names it."""
    mesh = _ctx().mesh
    if mesh is None or _ctx().rules is None:
        return x
    if len(axes) > x.ndim:
        return x
    spec = spec_for(axes, tuple(x.shape) if fit else None)
    place = placements(spec, x.ndim, mesh)
    SITES.record()
    if isinstance(x, DTensor):
        return x.redistribute(mesh, place)
    for dim, n in zip(x.shape, _shard_sizes(spec, mesh)):
        if dim % n:
            raise ValueError(f"shard: dimension {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways under {spec}")
    return x


def _zip(fn, tree, axes):
    """``fn(leaf, leaf_axes)`` over a tree of tensors (dicts and named
    tuples of them) and its tree of logical axes."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, axes)
    if isinstance(tree, dict):
        return {k: _zip(fn, v, axes[k]) for k, v in tree.items()}
    return type(tree)(*(_zip(fn, v, a) for v, a in zip(tree, axes)))


def placed(tree, axes):
    """A tree of whole tensors (a fresh decode state, the same on every
    rank) placed on the active mesh by its logical ``axes``, fit-or-drop
    against each leaf's shape: each rank keeps its part, and nothing moves.
    DTensors pass as they are; with no mesh, or a mesh of one rank, the
    tree is returned as it is (a rank's whole tensors, as :func:`shard`
    leaves them)."""
    mesh = _ctx().mesh
    if mesh is None or _ctx().rules is None or mesh.size() == 1:
        return tree

    def one(t, ax):
        if isinstance(t, DTensor):
            return t
        place = placements(spec_for(ax, tuple(t.shape)), t.ndim, mesh)
        return distribute_tensor(t, mesh, place, src_data_rank=None)

    return _zip(one, tree, axes)


def unflattenable(y: torch.Tensor, lead: int) -> torch.Tensor:
    """``y``, about to have its last dimension viewed as ``(lead, ...)``
    (a product's heads × width): as it is, or where DTensor split that
    dimension over mesh dimensions whose size does not divide ``lead`` (2
    KV heads over 16 ranks), whole along it, since no placement of the
    view describes that split.  The gradient passes back as it comes: split
    back along the flattened dimension, it would meet the view again."""
    if not isinstance(y, DTensor):
        return y
    last = y.ndim - 1
    ways = math.prod(y.device_mesh.size(i) for i, p in enumerate(y.placements)
                     if isinstance(p, Shard) and p.dim == last)
    if lead % ways == 0:
        return y
    return _Gathered.apply(y, [Replicate() if isinstance(p, Shard) and p.dim == last else p
                               for p in y.placements])


def whole_along(y: torch.Tensor, dim: int) -> torch.Tensor:
    """``y`` gathered along ``dim`` where it is a DTensor split along it;
    anything else as it is."""
    if not isinstance(y, DTensor) or not any(isinstance(p, Shard) and p.dim == dim
                                             for p in y.placements):
        return y
    return y.redistribute(y.device_mesh, [Replicate() if isinstance(p, Shard) and p.dim == dim
                                          else p for p in y.placements])


def flatten_last(y: torch.Tensor, n: int) -> torch.Tensor:
    """``y`` with its last ``n`` dimensions viewed as one, whose gradient is
    viewed back through :func:`unflattenable` (a gradient split along the
    flattened dimension in a way no placement of ``y``'s describes is
    gathered first).  A plain tensor: the view."""
    shape = (*y.shape[:-n], math.prod(y.shape[-n:]))
    if not isinstance(y, DTensor):
        return y.reshape(shape)
    return _Flattened.apply(y, n)


class _Flattened(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, n):
        ctx.inner = tuple(y.shape[-n:])
        return y.reshape(*y.shape[:-n], math.prod(ctx.inner))

    @staticmethod
    def backward(ctx, grad):
        return unflattenable(grad, ctx.inner[0]).reshape(*grad.shape[:-1], *ctx.inner), None


class _Gathered(torch.autograd.Function):
    """``y`` redistributed to ``place``; its gradient passes back as it comes."""

    @staticmethod
    def forward(ctx, y, place):
        return y.redistribute(y.device_mesh, place)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def local_part(x: DTensor, place, grad_place=None) -> torch.Tensor:
    """``x`` redistributed to ``place``, and this rank's local tensor of it,
    for a computation on each rank's shards; the gradient that comes back
    is placed as ``grad_place`` (default ``place``: a ``Partial`` where
    each rank's gradient is a part of the sum).  The gradient that comes back
    through it is this rank's, contiguous: DTensor wraps it with ``x``'s
    global strides, and a later view of a transposed local gradient (an
    einsum's backward leaves one) would fail; and where a recompute on
    autograd's CUDA thread hands it back as a DTensor (a remat'd layer
    under implicit replication), wrapping that again would nest one
    DTensor in another."""
    local = x.redistribute(x.device_mesh, place).to_local(
        grad_placements=None if grad_place is None else tuple(grad_place))
    if local.requires_grad:
        local.register_hook(_local_gradient)
    return local


def _local_gradient(g: torch.Tensor) -> torch.Tensor:
    return (g.to_local() if isinstance(g, DTensor) else g).contiguous()


def _settled(x):
    """``x`` with its masked partial sums (a gather or an embedding lookup
    on a vocab-sharded dimension) reduced at once: DTensor keeps the mask
    of the op's shape, which a view of the output no longer has, and a
    later reduction of it into a shard fails.  Anything else as it is."""
    if isinstance(x, DTensor) and any(isinstance(p, _MaskPartial) for p in x.placements):
        place = [Replicate() if isinstance(p, _MaskPartial) else p for p in x.placements]
        return x.redistribute(x.device_mesh, place)
    return x


@dataclass(frozen=True)
class Sharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: DeviceMesh
    spec: Spec


def _is_axes(x) -> bool:
    return x is None or (
        isinstance(x, tuple) and not hasattr(x, "_fields")
        and all(isinstance(t, (str, type(None))) for t in x)
    )


def _tree_map(fn, tree, *rest):
    if _is_axes(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v, *(getattr(r, f) for r in rest))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    raise TypeError(f"param_sharding: not an axes tree node: {tree!r}")


def param_sharding(
    axes_tree,
    mesh: Optional[DeviceMesh] = None,
    rules: Optional[Rules] = None,
    shapes_tree=None,
):
    """Map a tree of logical-axis tuples (dicts, lists and named tuples of
    them, e.g. :func:`~repro_torch.models.module.axes_of`'s flat dict) to
    :class:`Sharding` s.

    ``shapes_tree`` (same structure; leaves are shapes or have ``.shape``)
    activates fit-or-drop divisibility handling per leaf.
    """
    mesh = mesh or _ctx().mesh
    rules = rules or _ctx().rules
    if mesh is None or rules is None:
        raise RuntimeError("param_sharding needs an active mesh/rules")

    def one(axes, shape=None):
        if axes is None:
            return Sharding(mesh, ())
        shape = getattr(shape, "shape", shape)
        with _installed(mesh, rules):
            return Sharding(mesh, spec_for(axes, None if shape is None else tuple(shape)))

    if shapes_tree is None:
        return _tree_map(one, axes_tree)
    return _tree_map(one, axes_tree, shapes_tree)
