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
  SSD scan's, split over the batch and the heads; MLA's scores).  No
  placement of torch 2.11 describes such a flattened split, so
  :func:`einsum` runs that product on each rank's shards instead.
* ``aten.log_sigmoid_backward.default`` (the mLSTM's forget gate): no rule
  on either release.  Here it is elementwise (:func:`_pointwise_strategy`).
* the pointwise ops: torch 2.11's rule follows the operand with the most
  splits, so an activation whole over "model" meeting a parameter split
  over it gathers the parameter and the op, and what follows, runs whole
  (Zamba2's conv, ``dt_bias``, ``A_log``, ``D``, the norm's scale).  There
  the port offers every placement split alike on all operands beside it
  (:func:`_with_cheaper`), and DTensor takes the cheapest, as torch 2.13's
  rule, which decides each mesh dimension on its own, does.

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
    every split of ``a`` and ``b`` is along a letter the output keeps (a
    batch letter, or one of a single operand's), the product is
    independent per rank: each rank multiplies its own shards (an operand
    whole along a letter the other splits takes its own part of it first,
    a slice, or stays whole where it has no such letter; one split along
    another letter is moved to the first operand's) and the result is
    placed along the same letters, as DTensor places it where its view
    rule can flatten such splits.  Used only where the running torch's view rule refuses to
    (torch 2.11's does, and the einsum would gather whole operands);
    anything else is DTensor's."""
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or flattens_splits():
        return torch.einsum(equation, a, b)
    # pending sums are reduced first, as DTensor reduces them for a product
    a, b = (t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                           for p in t.placements])
            if any(p.is_partial() for p in t.placements) else t for t in (a, b))
    ins, out = equation.replace(" ", "").split("->")
    la, lb = ins.split(",")
    kept = set(out)  # the product is independent along every letter it keeps
    place, letters = [], set()
    for pa, pb in zip(a.placements, b.placements):
        split = {t[p.dim] for t, p in ((la, pa), (lb, pb)) if _plain_shard(p)}
        if not split:
            if not (pa.is_replicate() and pb.is_replicate()):
                return torch.einsum(equation, a, b)
            place.append(Replicate())
            continue
        if not split <= kept or not all(p.is_replicate() or _plain_shard(p) for p in (pa, pb)):
            return torch.einsum(equation, a, b)
        # split along two letters: ``b`` moves to ``a``'s
        letter = la[pa.dim] if _plain_shard(pa) else lb[pb.dim]
        letters.add(letter)
        place.append(letter)
    if not letters:
        return torch.einsum(equation, a, b)
    # an operand whole along a split letter takes its own part: no collective
    local = torch.einsum(equation, *(
        local_part(t, [c if not isinstance(c, str) else
                       Shard(letters_of.index(c)) if c in letters_of else Replicate()
                       for c in place])
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


def _pointwise_strategy(op_schema, inplace: bool = False):
    """An elementwise op: local on the first and last dimension of the
    output and on any an input is split along, each input split along it
    where it has the output's size there and whole where it broadcasts (an
    empty input, a CUDA ``log_sigmoid`` buffer, is whole); pending sums
    through the linear ops; or whole."""
    from torch.distributed.tensor._op_schema import OpStrategy

    ins = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    out = torch.broadcast_shapes(*(tuple(a.shape) for a in ins if math.prod(a.shape)))
    options = []
    for d in range(len(out)):
        row = [Shard(d)]
        for a in ins:
            lead = len(out) - a.ndim
            keeps = math.prod(a.shape) and d >= lead and a.shape[d - lead] == out[d]
            row.append(Shard(d - lead) if keeps else Replicate())
        # the first and the last dimension, or one some operand is split
        # along already: a new split of a middle one (a sequence) meets the
        # views that flatten it with the rows, which torch 2.11 cannot take
        if d in (0, len(out) - 1) or any(
                isinstance(r, Shard) and any(isinstance(p, Shard) and p.dim == r.dim
                                             for p in a.strategies[0].output_spec.placements)
                for r, a in zip(row[1:], ins)):
            options.append(row)
    options += _partial_rules(op_schema.op, len(ins)) + [[Replicate()] * (1 + len(ins))]
    got = _expand(op_schema, options, inplace=inplace)
    # only even splits: an uneven one moved between dimensions leaves a
    # local tensor whose strides its DTensor does not describe
    mesh = ins[0].mesh
    got.strategies = [s for s in got.strategies
                      if _splits_evenly(out, s.output_spec, mesh)
                      and all(_splits_evenly(a.shape, w, mesh) for a, w in zip(ins, s.input_specs))]
    # of two placements at the same cost DTensor takes the first: the one
    # that moves operands on fewer mesh dimensions, as a release that
    # decides each mesh dimension on its own keeps a dimension where
    # nothing needs to move
    got.strategies.sort(key=lambda s: (sum(map(sum, s.redistribute_cost)), _moved(s, ins)))
    return got


def _moved(spec, inputs) -> int:
    """The mesh dimensions on which ``spec`` moves one of ``inputs``."""
    have = [t.strategies[0].output_spec.placements for t in inputs]
    want = [w.placements for w in spec.input_specs]
    return sum(any(h[i] != w[i] for h, w in zip(have, want)) for i in range(len(have[0])))


# linear pointwise ops and the pending sums they pass on, by the number of
# tensor operands: [output, *operands] (torch 2.13's rules for them)
_SUMS = ("sum", "avg")
_LINEAR = {
    "unary": {1: [[Partial(r), Partial(r)] for r in _SUMS]},
    "add": {2: [[Partial(r)] * 3 for r in _SUMS]},
    "mul": {1: [[Partial(r), Partial(r)] for r in _SUMS],
            2: [[Partial(r), Partial(r), Replicate()] for r in _SUMS]
            + [[Partial(r), Replicate(), Partial(r)] for r in _SUMS]},
    "div": {1: [[Partial(r), Partial(r)] for r in _SUMS],
            2: [[Partial(r), Partial(r), Replicate()] for r in _SUMS]},
}
_KIND = {"add": "add", "add_": "add", "sub": "add", "sub_": "add", "mul": "mul", "mul_": "mul",
         "div": "div", "div_": "div", "neg": "unary", "neg_": "unary", "to": "unary",
         "_to_copy": "unary", "clone": "unary"}


def _partial_rules(op, n: int) -> list:
    kind = _KIND.get(op._overloadpacket.__name__)
    return [list(r) for r in _LINEAR.get(kind, {}).get(n, [])]


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


def _with_cheaper(theirs: Callable) -> Callable:
    """Torch's pointwise strategy that follows one operand (the one with the
    most splits), offered after the port's (:func:`_pointwise_strategy`:
    every output dimension split on every operand that has it), so that
    DTensor takes the cheapest of both, as a release that decides each mesh
    dimension on its own does: a whole activation meeting a parameter split
    over "model" is then sliced, not the parameter gathered."""

    def strategy(op_schema):
        from torch.distributed.tensor._op_schema import OpStrategy

        got = theirs(op_schema)
        if not isinstance(got, OpStrategy) or op_schema.is_out_variant_op():
            return got
        try:
            more = _pointwise_strategy(op_schema, inplace=op_schema.is_inplace_op())
        except (RuntimeError, AssertionError, ValueError):
            return got
        # the port's first: of two placements at the same cost DTensor takes
        # the first, and the port's keep what they can where it is
        return OpStrategy(list(more.strategies) + list(got.strategies))

    strategy.port_rule = strategy.cheaper = True
    return strategy


def _follows_one_operand(fn) -> bool:
    """Whether ``fn`` is torch's pointwise strategy that follows one operand."""
    return (getattr(fn, "__module__", "").endswith("_pointwise_ops")
            and getattr(fn, "__qualname__", "") in _FOLLOWING)


_FOLLOWING = ("pointwise_strategy", "linear_pointwise_strategy",
              "partial_preserving_pointwise_strategy")
CHEAPER = "pointwise ops: the cheapest placement"  # install()'s entry for them


# op → (the port's strategy, the arguments of its schema info where torch
# registered none)
_RULES: Dict = {
    aten.flip.default: (_flip_strategy, (1,)),
    aten.scatter_.src: (_scatter_strategy, (1,)),
    aten.index_put.default: (_index_put_strategy, None),
    aten.log_sigmoid_backward.default: (_pointwise_strategy, None),
}
COVERED = tuple(_RULES)


def install() -> List[str]:
    """Register the port's rule for each op of :data:`COVERED` the running
    torch needs it for: none where torch has a single-dimension rule (which
    DTensor asks first), the port's where torch has no rule, and else the
    port's behind torch's (:func:`_behind`); and each pointwise op whose
    rule follows one operand, the port's placements beside it
    (:func:`_with_cheaper`, listed as :data:`CHEAPER`).  Returns what it
    registered; calling it again registers nothing new."""
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
    for op, theirs in list(prop.op_strategy_funcs.items()):
        if _follows_one_operand(theirs):
            prop.op_strategy_funcs[op] = _with_cheaper(theirs)
    if any(getattr(f, "cheaper", False) for f in prop.op_strategy_funcs.values()):
        done.append(CHEAPER)
    clear_caches()
    return done


def clear_caches() -> None:
    """Forget the placements DTensor worked out before a rule changed: its
    Python cache and, where the release has one, its C++ one."""
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear is not None:
        clear()
