"""The port's DTensor rules, so that every torch release places a sharded
step as torch 2.13 does.

DTensor places an op's output from a rule per op.  Where the running torch
has none for an op, or one that refuses the placements the models give it,
the op cannot run on a sharded mesh, and the dry run's count falls back to
gathering its inputs whole; where its rule chooses otherwise than torch
2.13's, the count differs by release.  Torch 2.13's rules are the
reference (the CPU tests run on it; its counts are the records a card's
torch 2.11 is held to).  The port registers, in :func:`install`, its own
rule for each op below wherever the running torch has no single-dimension
rule for it (torch 2.13 has one for every op marked so, and DTensor asks it
first): one rule then decides on every release.

* ``aten.flip.default`` (the backward of ``cumsum``; 2.11 has no rule):
  local on every dimension it does not flip; a split of a flipped
  dimension is replicated.  2.13: single-dimension rule.
* ``aten.scatter_.src`` and ``aten.scatter.src`` (the MoE dispatch and the
  router's backward; 2.11's rule replicates every operand, and fails on a
  split target in place): local on every dimension but the scattered one
  where the target, the index and the source have the same size, as torch
  2.13's rule for both.
* ``aten.index_put.default`` (the backward of indexing, ``x[:, idx]``;
  2.11's rule fails on an index list that holds ``None``): local on every
  dimension the indices do not address, where the values have the same
  size there.  2.13: single-dimension rule.
* ``aten.log_sigmoid_backward.default`` (the mLSTM's forget gate): no rule
  on either release; elementwise (:func:`_pointwise_strategy`).
* the elementwise ops and ``aten.clone.default``: torch 2.11's rule follows
  the operand with the most splits (an activation whole over "model"
  meeting a parameter split over it gathers the parameter), and its
  ``clone`` keeps a pending sum, which 2.13's reduces onto a split (every
  einsum's and product's reshape clones).  Here: torch 2.13's
  single-dimension pointwise rule (:func:`_pointwise_strategy`), each mesh
  dimension on its own, pending sums only through the ops linear in them.
* ``aten.view.default`` and ``aten._unsafe_view.default``: torch 2.11's
  rule refuses to flatten a split that does not lead its group of
  dimensions, which torch 2.13 places as a strided split that no placement
  of 2.11 describes.  Where a model's einsum flattens such splits (MLA's
  scores, the SSD scan's products: batch and heads split), :func:`einsum`
  runs the product on each rank's shards, placed as 2.13 places it.  Where
  the backward of a product views its gradient so (DeepSeek's train step,
  a gradient split along the sequence), the split is gathered first
  (:func:`_gathering_view`): the one place where the releases' counts
  still part, by its bytes.

Each rule computes on a rank's shards what the op computes on the whole
tensors, or replicates what it cannot keep split: it never gives a wrong
local result.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import math
import sys
from typing import Callable, Dict, List

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard


aten = torch.ops.aten


def _plain_shard(p) -> bool:
    """A ``Shard`` (of either class a release builds it from), not a
    ``_StridedShard``."""
    return p.is_shard() and not hasattr(p, "split_factor")


def einsum(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, a, b)`` of two operands, with the product on
    each rank's shards where the running torch cannot flatten the splits of
    its batch (torch 2.11).

    ATen runs such an einsum as one batched product: each operand permuted
    to its letters' order, a reshape that flattens the letters of both
    operands (the batch), those of one (rows or columns) and the contracted
    ones, ``bmm``, and views back.  On DTensors each of those ops is placed
    by its rule.  Torch 2.13's view rule describes a flattened split of an
    inner letter (a strided split); 2.11's refuses it, which a count would
    charge as the op on whole tensors.  Here the same ops run in the same
    order (:func:`_pair`): as DTensor ops where the running torch can place
    them, and only the flattening reshape, ``bmm`` and the view back on
    each rank's local tensors where it cannot.  Each rank then holds its
    part of the product, placed as DTensor places it where its view rule
    takes the flattened splits, with the same collectives before it (a
    pending sum the reshape's ``clone`` reduces, as torch 2.13's rule
    reduces it).  Anything else, or a torch that flattens such splits
    itself, is ``torch.einsum``'s."""
    if not (isinstance(a, DTensor) and isinstance(b, DTensor)) or flattens_splits():
        return torch.einsum(equation, a, b)
    return _pair(equation, a, b)


def _pair(equation: str, a: DTensor, b: DTensor) -> torch.Tensor:
    """ATen's two-operand einsum (``sumproduct_pair``), op for op, with the
    flattening reshapes, ``bmm`` and the view back on local tensors where
    the running torch cannot place the flattening (:func:`einsum`)."""
    ins, out = equation.replace(" ", "").split("->")
    la, lb = ins.split(",")
    layout = list(out) + sorted(set(la + lb) - set(out))  # ATen's order of the letters
    ops = []
    for t, letters in ((a, la), (b, lb)):
        missing = [c for c in layout if c not in letters]
        for _ in missing:
            t = t.unsqueeze(-1)
        have = list(letters) + missing
        ops.append(t.permute([have.index(c) for c in layout]))
    a, b = ops
    sums = []
    for d in range(len(out), len(layout)):
        if a.shape[d] != 1 and b.shape[d] != 1:
            sums.append(d)
        elif a.shape[d] != 1:
            a = a.sum(d, keepdim=True)
        elif b.shape[d] != 1:
            b = b.sum(d, keepdim=True)
    lro, lo, ro = [], [], []
    for d in range(len(layout)):
        if d not in sums:
            (lro if a.shape[d] != 1 and b.shape[d] != 1 else lo if a.shape[d] != 1 else ro).append(d)
    lperm, rperm = lro + lo + sums + ro, lro + sums + ro + lo
    out_ids = lro + lo + sums + ro
    out_size = [a.shape[d] for d in lro + lo] + [1] * len(sums) + [b.shape[d] for d in ro]
    left = _Operand.permuted(a, lperm, (len(lro), len(lo)))
    right = _Operand.permuted(b, rperm, (len(lro), len(sums)))
    groups = (range(len(lro)), range(len(lro), len(lro) + len(lo) + len(sums)),
              range(len(lro) + len(lo) + len(sums), len(out_ids)))
    # the backward's products may flatten splits the forward's did not
    y = _LocalProduct.apply(left.t, right.t, (left, right, out_ids, out_size, groups))
    operm = [0] * len(layout)
    for i, d in enumerate(out_ids):
        operm[d] = i
    y = y.permute(operm)
    return y.view([y.shape[d] for d in range(len(out))])


class _Operand:
    """An operand of ``bmm`` before ATen flattens it to three dimensions:
    the DTensor, the letter (a dimension of the einsum's layout) of each of
    its dimensions, its three groups of dimensions, and whether the reshape
    copies (``clone`` and ``_unsafe_view``, else ``view``)."""

    def __init__(self, t: DTensor, ids, groups, copy: bool = False):
        self.t, self.ids, self.groups, self.copy = t, list(ids), groups, copy

    @classmethod
    def permuted(cls, t: DTensor, perm, lead) -> "_Operand":
        """``t.permute(perm)``, grouped as the first ``lead[0]`` dimensions,
        the next ``lead[1]`` and the rest; the copy ATen's reshape makes
        where the strides allow no view is made here, by DTensor (whose rule
        reduces a pending sum)."""
        t = t.permute(perm)
        n0, n1 = lead
        groups = (range(n0), range(n0, n0 + n1), range(n0 + n1, t.ndim))
        copy = not _viewable(t, tuple(math.prod(t.shape[d] for d in g) for g in groups))
        if copy:
            t = t.clone(memory_format=torch.contiguous_format)
        return cls(t, perm, groups, copy)

    def swapped(self) -> "_Operand":
        """The operand transposed in its last two groups (``bmm``'s backward
        takes the other operand so)."""
        return _Operand(self.t, self.ids, (self.groups[0], self.groups[2], self.groups[1]))

    def shape3(self, t=None):
        t = self.t if t is None else t
        return tuple(math.prod(t.shape[d] for d in g) for g in self.groups)

    def reshaped(self, local: bool = False) -> torch.Tensor:
        """The flattening reshape, of the DTensor or of its local tensor (a
        transposed view where the groups are swapped)."""
        t = self.t.to_local() if local else self.t
        order = [d for g in self.groups for d in g]
        if order != sorted(order):  # swapped: flatten as stored, then transpose
            plain = (self.groups[0], self.groups[2], self.groups[1])
            return _Operand(self.t, self.ids, plain).reshaped(local).transpose(1, 2)
        shape = self.shape3(t)
        return aten._unsafe_view(t, shape) if self.copy else t.view(shape)

    def refused(self) -> bool:
        """Whether the reshape flattens a split that does not lead its group:
        torch 2.13 places it as a strided split, torch 2.11's view rule
        refuses it."""
        return any(self.letter(i) is not None and not self.outer(self.letter(i))
                   for i in range(self.t.device_mesh.ndim))

    def letter(self, i: int):
        p = self.t.placements[i]
        return self.ids[p.dim] if _plain_shard(p) else None

    def role(self, letter) -> int:
        return next(k for k, g in enumerate(self.groups) if self.ids.index(letter) in g)

    def outer(self, letter) -> bool:
        """Whether ``letter`` leads its group (a plain split once flattened;
        a later one is a strided split)."""
        d = self.ids.index(letter)
        return not any(self.t.shape[e] != 1 for e in self.groups[self.role(letter)] if e < d)

    def move(self, i: int, place) -> None:
        """Redistribute along mesh dimension ``i`` as DTensor's ``bmm`` does
        inside the op (:func:`_as_inside_an_op`): ``place`` is ``Replicate()``
        or a letter to split along."""
        want = list(self.t.placements)
        want[i] = place if not isinstance(place, int) else Shard(self.ids.index(place))
        with _as_inside_an_op():
            self.t = self.t.redistribute(self.t.device_mesh, want)


@contextlib.contextmanager
def _as_inside_an_op():
    """The block's ops counted as DTensor's own inside an op it dispatches: a
    mode that counts the ops a program issues (``counts_issued_ops``, the
    dry run's) and is innermost is set aside, as it never sees those; the
    modes under it (the collectives) see them."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode, _pop_mode_temporarily

    if getattr(_get_current_dispatch_mode(), "counts_issued_ops", False):
        with _pop_mode_temporarily():
            yield
    else:
        yield


def _viewable(t: DTensor, shape) -> bool:
    """Whether ``t``'s global strides let ATen view it as ``shape``."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():  # a stride check on the side, uncounted
        try:
            torch.empty_strided(t.shape, t.stride(), device="meta").view(shape)
        except RuntimeError:
            return False
    return True


def _plan(x: _Operand, y: _Operand):
    """How torch 2.13's ``bmm`` places ``x @ y`` (groups: batch, rows,
    contracted; and batch, contracted, columns) on each mesh dimension,
    where their flattened splits are strided: the output's placement (a
    letter, a pending sum, or whole), after moving an operand where its
    rule moves it.  A split batch letter meets the other operand alike,
    or whole (which is sliced where the letter leads its group, and else
    the split one gathered), or split along the letter that leads (the
    other then gathered and sliced alike), or along another inner letter
    (both gathered), or the other's rows or columns (the strided one
    gathered); rows of ``x`` or columns of ``y`` split meet the other
    whole; a contracted letter split on both gives a pending sum, as does
    a pending sum times a whole operand.  (Torch 2.13's choices, read off
    its ``bmm`` on strided splits; where its cost model weighs sizes the
    models' shapes decide as here.)  None for anything else (DTensor's own
    ``bmm`` then decides).  The moves are made only once every mesh
    dimension is placed."""
    place, moves = [], []
    for i, (px, py) in enumerate(zip(x.t.placements, y.t.placements)):
        lx, ly = x.letter(i), y.letter(i)
        rx = x.role(lx) if lx is not None else None
        ry = y.role(ly) if ly is not None else None
        if rx == 0 and ry == 0:
            if lx == ly:
                place.append(lx)
            elif x.outer(lx) and not y.outer(ly):  # gathered, then sliced
                moves += [(y, i, Replicate()), (y, i, lx)]
                place.append(lx)
            elif y.outer(ly) and not x.outer(lx):
                moves += [(x, i, Replicate()), (x, i, ly)]
                place.append(ly)
            elif not (x.outer(lx) or y.outer(ly)):  # two strided splits: both gathered
                moves += [(x, i, Replicate()), (y, i, Replicate())]
                place.append(Replicate())
            else:
                return None
        elif rx == 2 and ry == 1 and lx == ly:
            place.append(Partial())
        elif rx == 0 and ry == 2 and not x.outer(lx):  # a strided batch meets columns
            moves.append((x, i, Replicate()))
            place.append(ly)
        elif rx == 1 and ry == 0 and not y.outer(ly):  # rows meet a strided batch
            moves.append((y, i, Replicate()))
            place.append(lx)
        elif lx is not None and ly is None and py.is_replicate() and rx in (0, 1):
            if rx == 1:
                place.append(lx)
            elif x.outer(lx):
                moves.append((y, i, lx))
                place.append(lx)
            else:
                moves.append((x, i, Replicate()))
                place.append(Replicate())
        elif ly is not None and lx is None and px.is_replicate() and ry in (0, 2):
            if ry == 2:
                place.append(ly)
            elif y.outer(ly):
                moves.append((x, i, ly))
                place.append(ly)
            else:
                moves.append((y, i, Replicate()))
                place.append(Replicate())
        elif lx is None and ly is None and (px.is_replicate() or py.is_replicate()):
            place.append(py if px.is_replicate() else px)
        else:
            return None
    for operand, i, where in moves:
        operand.move(i, where)
    return place


def _local_bmm(x: _Operand, y: _Operand, plan, ids, shape) -> DTensor:
    """``bmm`` of the two operands' local tensors (placed by :func:`_plan`),
    viewed as ``shape`` whose dimensions are the letters ``ids``."""
    mesh = x.t.device_mesh
    place = [Shard(ids.index(p)) if not isinstance(p, Placement) else p for p in plan]
    local = list(shape)
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    y3 = torch.bmm(x.reshaped(local=True), y.reshaped(local=True))
    return DTensor.from_local(y3.view(local), mesh, place, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(math.prod(shape[i + 1:]) for i in range(len(shape))))


class _LocalProduct(torch.autograd.Function):
    """The product of :func:`_pair` (:func:`_bmm`: on local tensors where
    the running torch cannot flatten its operands), and its backward as
    ATen's ``bmm`` backward: the gradient reshaped to three dimensions,
    then ``x.T @ g`` and ``g @ y.T``, each by :func:`_bmm` again."""

    @staticmethod
    def forward(ctx, lt, rt, how):
        x, y, ids, shape, groups = how
        out = _bmm(x, y, ids, shape)
        # the operands as placed for the product, saved as autograd saves
        # bmm's (a recompute's hooks see them); only their layout is kept
        ctx.save_for_backward(x.t, y.t)
        ctx.how = ((x.ids, x.groups), (y.ids, y.groups), ids, groups)
        return out

    @staticmethod
    def backward(ctx, g):
        x, y, ids, groups = ctx.how
        x, y = (_Operand(t, *layout) for t, layout in zip(ctx.saved_tensors, (x, y)))
        xt, yt = x.t, y.t
        copy = not _viewable(g, tuple(math.prod(g.shape[d] for d in gr) for gr in groups))
        if copy:
            g = g.clone(memory_format=torch.contiguous_format)
        grads = [None, None]
        # ATen flattens the gradient once (``_unsafe_view`` after its copy);
        # a second product views it
        if ctx.needs_input_grad[1]:
            a, b = _Operand(xt, x.ids, x.groups).swapped(), _Operand(g, ids, groups, copy)
            grads[1] = _bmm(a, b, y.ids, tuple(yt.shape))
            copy = False
        if ctx.needs_input_grad[0]:
            a, b = _Operand(g, ids, groups, copy), _Operand(yt, y.ids, y.groups).swapped()
            grads[0] = _bmm(a, b, x.ids, tuple(xt.shape))
        return grads[0], grads[1], None


def _bmm(a: _Operand, b: _Operand, ids, shape) -> DTensor:
    """``a @ b`` viewed as ``shape`` (letters ``ids``): DTensor's own
    ``bmm`` and view where the running torch places the flattening (or
    :func:`_plan` does not know 2.13's choice), else :func:`_local_bmm`."""
    plan = _plan(a, b) if a.refused() or b.refused() else None
    if plan is not None:
        return _local_bmm(a, b, plan, ids, shape)
    y = torch.bmm(a.reshaped(), b.reshaped()).view(shape)
    # a new DTensor, not a view: the model writes the product in place
    return DTensor.from_local(y.to_local(), y.device_mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


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
    """An elementwise op as torch 2.13 places it (its single-dimension
    pointwise rule, expanded over the mesh): on each mesh dimension the
    output split along any of its dimensions, each input alike where it has
    the output's size there and whole where it broadcasts, or everything
    whole; the pending sums the op passes on (:func:`_partial_rows`); and
    the cheapest of these, which DTensor takes.  A split row is offered only
    where some input is split already, and an empty input (a CUDA
    ``log_sigmoid`` buffer) is whole."""
    from torch.distributed.tensor._op_schema import OpStrategy

    ins = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    out = torch.broadcast_shapes(*(tuple(a.shape) for a in ins if math.prod(a.shape)))
    rows = []
    for d in range(len(out)):
        row = [Shard(d)]
        for a in ins:
            j = d - (len(out) - a.ndim)
            row.append(Shard(j) if math.prod(a.shape) and j >= 0 and a.shape[j] == out[d]
                       else Replicate())
        rows.append(row)
    return _single_dim(op_schema, rows + _partial_rows(op_schema.op, len(ins)),
                       inplace=inplace or op_schema.is_inplace_op())


def _single_dim(op_schema, rows, inplace: bool = False):
    """A rule given for one mesh dimension expanded over the mesh as torch
    2.13 expands its single-dimension pointwise rules: the all-whole row
    first, the rows that split something only where some input is split,
    every combination over the mesh dimensions, each input split evenly
    enough to give every rank a part or kept as it is (an uneven split, a
    single row over the data ranks, stays), an in-place op's target and
    output as the target is."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs, is_tensor_shardable

    ins = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    have = [a.strategies[0].output_spec for a in ins]
    split = any(p.is_shard() for h in have for p in h.placements)
    rows = [[Replicate()] * (1 + len(ins))] + [
        r for r in rows if split or not any(isinstance(p, Shard) for p in r)]
    mesh = ins[0].mesh
    got = OpStrategy([])
    for combo in itertools.product(rows, repeat=mesh.ndim):
        out = _spec(mesh, [c[0] for c in combo])
        wanted = [_spec(mesh, [c[j + 1] for c in combo], h.tensor_meta) for j, h in enumerate(have)]
        if inplace and not (wanted[0].placements == out.placements == have[0].placements):
            continue
        if not all(is_tensor_shardable(a.shape, w) or w.placements == h.placements
                   for a, w, h in zip(ins, wanted, have)):
            continue
        got.strategies.append(OpSpec(
            output_specs=out, input_specs=tuple(wanted),
            redistribute_cost=[generate_redistribute_costs(a, w) for a, w in zip(ins, wanted)]))
    return got


# the pending sums an elementwise op passes on, by the number of its tensor
# operands: [output, *operands] (torch 2.13's ``_pointwise_ops`` tables;
# its max / min rows are left out: the models make no such partials)
_SUMS = ("sum", "avg")
_UNARY_LINEAR = [[Partial(r), Partial(r)] for r in _SUMS]
_PARTIAL_ROWS = {
    "additive": {2: [[Partial(r)] * 3 for r in _SUMS]
                 + [[Partial("avg"), Partial("avg"), Replicate()],
                    [Partial("avg"), Replicate(), Partial("avg")]]},
    "mul": {1: _UNARY_LINEAR,
            2: [[Partial(r), Partial(r), Replicate()] for r in _SUMS]
            + [[Partial(r), Replicate(), Partial(r)] for r in _SUMS]},
    "div": {1: _UNARY_LINEAR, 2: [[Partial(r), Partial(r), Replicate()] for r in _SUMS]},
    "linear": {1: _UNARY_LINEAR},
    "copy": {1: _UNARY_LINEAR, 2: [[Partial(r)] * 3 for r in _SUMS]},
}
_KIND = {"add.Tensor": "additive", "add_.Tensor": "additive", "sub.Tensor": "additive",
         "sub_.Tensor": "additive", "mul.Tensor": "mul", "mul_.Tensor": "mul",
         "div.Tensor": "div", "div_.Tensor": "div", "mul.Scalar": "linear",
         "mul_.Scalar": "linear", "div.Scalar": "linear", "div_.Scalar": "linear",
         "neg.default": "linear", "neg_.default": "linear", "to.dtype": "copy",
         "positive.default": "copy", "copy_.default": "copy"}


def _partial_rows(op, n: int) -> list:
    kind = _KIND.get(f"{op._overloadpacket.__name__}.{op._overloadname}")
    return [list(r) for r in _PARTIAL_ROWS.get(kind, {}).get(n, [])]


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


def _gathering_view(theirs: Callable) -> Callable:
    """Torch's view rule, and where it refuses to flatten a split that does
    not lead its group (torch 2.11; 2.13 places a strided split) that split
    gathered first, from the last mesh dimension on: a view the backward of
    a product makes (its gradient viewed as rows) does not fall back whole."""

    def strategy(op_schema):
        from torch.distributed.tensor._op_schema import OpSchema, OpSpec, OpStrategy
        from torch.distributed.tensor._ops.utils import generate_redistribute_costs

        try:
            return theirs(op_schema)
        except (RuntimeError, AssertionError):
            refused = sys.exc_info()
        src = op_schema.args_schema[0]
        spec = src.strategies[0].output_spec
        place = list(spec.placements)
        for i in reversed(range(len(place))):
            if not place[i].is_shard():
                continue
            place[i] = Replicate()
            gathered = _spec(spec.mesh, place, spec.tensor_meta)
            schema = OpSchema(op_schema.op, (OpStrategy([OpSpec(gathered)]),)
                              + tuple(op_schema.args_schema[1:]), op_schema.kwargs_schema)
            try:
                got = theirs(schema)
            except (RuntimeError, AssertionError):
                continue
            for s in got.strategies:
                s.input_specs = (gathered,)
                s.redistribute_cost = [generate_redistribute_costs(src, gathered)]
            return got
        raise refused[1]

    strategy.port_rule = True
    return strategy


_VIEWS = (aten.view.default, aten._unsafe_view.default)
VIEWS = "views: a split behind the first gathered"  # install()'s entry for them


def _follows_one_operand(fn) -> bool:
    """Whether ``fn`` is torch's pointwise strategy that follows one operand
    (torch 2.11's; 2.13 places pointwise ops per mesh dimension)."""
    return (getattr(fn, "__module__", "").endswith("_pointwise_ops")
            and getattr(fn, "__qualname__", "") in _FOLLOWING)


_FOLLOWING = ("pointwise_strategy", "linear_pointwise_strategy",
              "partial_preserving_pointwise_strategy")
POINTWISE = "pointwise ops: torch 2.13's rule"  # install()'s entry for them
# elementwise ops torch 2.13 places by its pointwise rule, where 2.11 has
# another (``clone`` keeps a pending sum there)
_ALSO_POINTWISE = (aten.clone.default,)


# op → (the port's strategy, the arguments of its schema info where torch
# registered none)
_RULES: Dict = {
    aten.flip.default: (_flip_strategy, (1,)),
    aten.scatter_.src: (_scatter_strategy, (1,)),
    aten.scatter.src: (_scatter_strategy, (1,)),
    aten.index_put.default: (_index_put_strategy, None),
    aten.log_sigmoid_backward.default: (_pointwise_strategy, None),
}
COVERED = tuple(_RULES)
for _rule, _ in _RULES.values():
    _rule.port_rule = True  # what install() registered, as DTensor holds it


def install() -> List[str]:
    """Register the port's rule for each op of :data:`COVERED`, each
    elementwise op whose rule follows one operand (and ``clone``; listed as
    :data:`POINTWISE`) and the views (torch's rule behind the port's
    gathering, :func:`_gathering_view`), wherever the running torch has no
    single-dimension rule for the op: none on a torch whose rules already
    place them as 2.13's do.  Returns what it registered; calling it again
    registers nothing new."""
    from torch.distributed.tensor._op_schema import RuntimeSchemaInfo

    prop = DTensor._op_dispatcher.sharding_propagator
    done = []
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    for op, (ours, info) in _RULES.items():
        if op in single:
            continue
        prop.op_strategy_funcs[op] = ours
        if op not in prop.op_to_schema_info and info is not None:
            prop.op_to_schema_info[op] = RuntimeSchemaInfo(*info)
        done.append(str(op))
    for op, theirs in list(prop.op_strategy_funcs.items()):
        out_variant = any(a.is_out for a in op._schema.arguments)  # the models call none
        if op not in single and not out_variant and (
                _follows_one_operand(theirs) or op in _ALSO_POINTWISE):
            prop.op_strategy_funcs[op] = _pointwise_strategy
    for op in _VIEWS:
        theirs = prop.op_strategy_funcs.get(op)
        if op not in single and theirs is not None and not getattr(theirs, "port_rule", False):
            prop.op_strategy_funcs[op] = _gathering_view(theirs)
    if any(getattr(prop.op_strategy_funcs.get(op), "port_rule", False) for op in _VIEWS):
        done.append(VIEWS)
    if any(f is _pointwise_strategy and op not in _RULES
           for op, f in prop.op_strategy_funcs.items()):
        done.append(POINTWISE)
    clear_caches()
    return done


def clear_caches() -> None:
    """Forget the placements DTensor worked out before a rule changed: its
    Python cache and, where the release has one, its C++ one."""
    DTensor._op_dispatcher.sharding_propagator.propagate_op_sharding.cache_clear()
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache", None)
    if clear is not None:
        clear()
