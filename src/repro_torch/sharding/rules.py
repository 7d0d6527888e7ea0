"""The port's DTensor rules for the ops some torch releases cannot place.

DTensor places an op's output from a rule per op.  Where the running torch
has none for an op, or one that refuses the placements the models give it,
the op cannot run on a sharded mesh, and the dry run's count falls back to
gathering its inputs whole, which charges bytes no rank needs and runs the
op unsplit.  Torch 2.11 does so for four ops of the models' train steps;
torch 2.13 places all of them itself:

* ``aten.flip.default`` (the backward of ``cumsum``): no rule.  Here it is
  local on every dimension it does not flip; a split of a flipped
  dimension is replicated.
* ``aten.scatter_.src``: the rule replicates every operand, so the
  in-place op fails on a split target.  Here it is local on every
  dimension but the scattered one where the target, the index and the
  source have the same size.
* ``aten.index_put.default`` (the backward of indexing, ``x[:, idx]``): the
  rule fails on an index list that holds ``None``.  Here it is local on
  every dimension the indices do not address, where the values have the
  same size there.
* ``aten._unsafe_view.default``: the view rule refuses to flatten two split
  dimensions into one, which an einsum does with its batch letters (the
  SSD scan's, split over the batch and the heads).  No placement of torch
  2.11 describes such a flattened split, so :func:`einsum` runs that
  product on each rank's shards instead.

Each rule computes on a rank's shards what the op computes on the whole
tensors, or replicates what it cannot keep split: it never gives a wrong
local result.  :func:`install` (run when :mod:`repro_torch.sharding` is
imported) registers a rule only where the running torch's own one fails,
and leaves every op torch places itself on torch's rule.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Callable, Dict, List

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .partition import local_part

aten = torch.ops.aten


def _plain_shard(p) -> bool:
    """A ``Shard`` (of either class a release builds it from), not a
    ``_StridedShard``."""
    return p.is_shard() and not hasattr(p, "split_factor")


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` of two operands, on each rank's
    shards when DTensor would flatten two split dimensions into one.

    An einsum runs as a batched product over all its batch letters (those
    of both operands and the output) flattened into one dimension.  Where
    every split of ``a`` and ``b`` is along a batch letter, two or more of
    them, the product is independent per rank: each rank multiplies its own
    shards (an operand whole along a letter the other splits takes its own
    part of it first, a slice) and the result is placed along the same
    letters, as DTensor places it where its view rule can flatten such
    splits.  Used only where the running torch's view rule refuses to
    (torch 2.11's does, and the einsum would gather whole operands);
    anything else is DTensor's."""
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or flattens_splits():
        return torch.einsum(equation, a, b)
    ins, out = equation.replace(" ", "").split("->")
    la, lb = ins.split(",")
    batch = set(la) & set(lb) & set(out)
    place, letters = [], set()
    for pa, pb in zip(a.placements, b.placements):
        split = {t[p.dim] for t, p in ((la, pa), (lb, pb)) if _plain_shard(p)}
        if not split:
            if not (pa.is_replicate() and pb.is_replicate()):
                return torch.einsum(equation, a, b)
            place.append(Replicate())
            continue
        if len(split) > 1 or not split <= batch \
                or not all(p.is_replicate() or _plain_shard(p) for p in (pa, pb)):
            return torch.einsum(equation, a, b)
        letters |= split
        place.append(split.pop())
    if len(letters) < 2:
        return torch.einsum(equation, a, b)
    # an operand whole along a split letter takes its own part: no collective
    local = torch.einsum(equation, *(
        local_part(t, [Shard(letters_of.index(c)) if isinstance(c, str) else c for c in place])
        for t, letters_of in ((a, la), (b, lb)))).contiguous()
    sizes = {**dict(zip(la, a.shape)), **dict(zip(lb, b.shape))}
    shape = tuple(sizes[c] for c in out)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, a.device_mesh,
                              [Shard(out.index(c)) if isinstance(c, str) else c for c in place],
                              run_check=False, shape=torch.Size(shape), stride=stride)


@functools.cache
def flattens_splits() -> bool:
    """Whether the running torch's view rule flattens two split dimensions
    into one (torch 2.13's does; 2.11's refuses)."""
    from torch.distributed.tensor._ops._view_ops import propagate_shape_and_sharding, view_groups

    try:
        propagate_shape_and_sharding([Shard(0), Shard(1)], (4, 4), view_groups((4, 4), (16,)),
                                     (2, 2), strict_view=True)
    except RuntimeError:
        return False
    return True


# ----------------------------------------------------------- the strategies


def _expand(op_schema, options, inplace: bool = False):
    from torch.distributed.tensor._ops.utils import expand_to_full_mesh_op_strategy

    return expand_to_full_mesh_op_strategy(op_schema.get_mesh_from_args(), op_schema, options,
                                           inplace_op=inplace)


def _flip_strategy(op_schema):
    """Local on every dimension ``flip`` does not reverse; partial sums
    pass through (it is linear)."""
    source, dims = op_schema.args_schema[:2]
    flipped = {d % source.ndim for d in dims}
    options = [[Replicate(), Replicate()]]
    options += [[Shard(d), Shard(d)] for d in range(source.ndim) if d not in flipped]
    options += [[Partial(r), Partial(r)] for r in ("sum", "avg", "max", "min")]
    return _expand(op_schema, options)


def _scatter_strategy(op_schema):
    """``scatter_(dim, index, src)``: local on every dimension but ``dim``
    where the target, the index and the source have the same size."""
    from torch.distributed.tensor._op_schema import OpStrategy

    target, dim, index = op_schema.args_schema[:3]
    src = op_schema.args_schema[3] if len(op_schema.args_schema) > 3 else None
    src = src if isinstance(src, OpStrategy) else None
    n = 4 if src is not None else 3
    dim %= target.ndim
    options = [[Replicate()] * n]
    if target.ndim == index.ndim:
        for d in range(target.ndim):
            if d != dim and target.shape[d] == index.shape[d] \
                    and (src is None or src.shape[d] == index.shape[d]):
                options.append([Shard(d)] * n)
    return _expand(op_schema, options, inplace=op_schema.is_inplace_op())


def _index_put_strategy(op_schema):
    """``index_put(indices, values)``: local on every dimension the indices
    do not address (they address one run of dimensions, and are
    replicated), where the values have the same size there."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy, TupleStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    target, indices, values = op_schema.args_schema[:3]
    indices = list(indices.children if isinstance(indices, TupleStrategy) else indices)
    taken = [i for i, t in enumerate(indices) if t is not None]
    # torch 2.11 hands an index of a list that holds None over as a bare
    # spec: one strategy, the placement it has
    index = [t if isinstance(t, OpStrategy) else OpStrategy([OpSpec(t)])
             for t in (indices[i] for i in taken)]
    inputs = [target, *index, values]
    options = [[Replicate()] * (2 + len(inputs) - 1)]
    if taken and taken == list(range(taken[0], taken[-1] + 1)):
        k = len(torch.broadcast_shapes(*(tuple(t.shape) for t in index)))
        if values.ndim == target.ndim - len(taken) + k:
            for d in range(target.ndim):
                if d in taken:
                    continue
                vd = d if d < taken[0] else d - len(taken) + k
                if values.shape[vd] == target.shape[d]:
                    options.append([Shard(d), Shard(d)] + [Replicate()] * len(index)
                                   + [Shard(vd)])
    mesh = target.mesh
    out = OpStrategy([])
    for combo in itertools.product(options, repeat=mesh.ndim):
        specs = [_spec(mesh, [c[j] for c in combo]) for j in range(len(options[0]))]
        wanted = [_spec(mesh, w.placements, t.strategies[0].output_spec.tensor_meta)
                  for w, t in zip(specs[1:], inputs)]
        if not all(_splits_evenly(t.shape, w, mesh) for t, w in zip(inputs, wanted)):
            continue
        out.strategies.append(OpSpec(
            output_specs=specs[0], input_specs=tuple(wanted),
            redistribute_cost=[generate_redistribute_costs(t, w) for t, w in zip(inputs, wanted)]))
    return out


def _spec(mesh, placements, tensor_meta=None):
    from torch.distributed.tensor._dtensor_spec import DTensorSpec

    return DTensorSpec(mesh=mesh, placements=tuple(placements), tensor_meta=tensor_meta)


def _splits_evenly(shape, spec, mesh) -> bool:
    ways: Dict[int, int] = {}
    for i, p in enumerate(spec.placements):
        if p.is_shard():
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    return all(shape[d] % n == 0 for d, n in ways.items())


# ---------------------------------------------------------------- install


def _keeps_target(op_schema, strategy) -> bool:
    """Whether an in-place op's strategy offers the target's placement."""
    have = tuple(op_schema.args_schema[0].strategies[0].output_spec.placements)
    return any(tuple(s.output_spec.placements) == have for s in strategy.strategies)


def _behind(theirs: Callable, ours: Callable) -> Callable:
    """A strategy that asks torch's rule first and the port's where torch's
    raises or offers no placement that keeps an in-place op's target."""

    def strategy(op_schema):
        try:
            got = theirs(op_schema)
        except (RuntimeError, AssertionError):
            got = None
        if got is not None and (not op_schema.is_inplace_op() or _keeps_target(op_schema, got)):
            return got
        return ours(op_schema)

    return strategy


# op → (the port's strategy, the arguments of its schema info where torch
# registered none)
_RULES: Dict = {
    aten.flip.default: (_flip_strategy, (1,)),
    aten.scatter_.src: (_scatter_strategy, (1,)),
    aten.index_put.default: (_index_put_strategy, None),
}
COVERED = tuple(_RULES)


def install() -> List[str]:
    """Register the port's rule for each op of :data:`COVERED` the running
    torch needs it for: none where torch has a single-dimension rule (which
    DTensor asks first), the port's where torch has no rule, and else the
    port's behind torch's (:func:`_behind`).  Returns the ops registered;
    calling it again registers nothing new."""
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo

    prop = DTensor._op_dispatcher.sharding_propagator
    done = []
    for op, (ours, info) in _RULES.items():
        if op in getattr(prop, "op_single_dim_strategy_funcs", {}):
            continue
        theirs = prop.op_strategy_funcs.get(op)
        if not getattr(theirs, "port_rule", False):
            rule = ours if theirs is None else _behind(theirs, ours)
            rule.port_rule = True
            prop.op_strategy_funcs[op] = rule
            if op not in prop.op_to_schema_info and info is not None:
                prop.op_to_schema_info[op] = RuntimeSchemaInfo(*info)
        done.append(str(op))
    clear_caches()
    return done


def clear_caches() -> None:
    """Forget the placements DTensor worked out before a rule changed: its
    Python cache and, where the release has one, its C++ one."""
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear is not None:
        clear()
