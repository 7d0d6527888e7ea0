"""One dry-run answer on both torch releases (``repro_torch.sharding.rules``).

The port takes a path of its own where the running torch's DTensor cannot
place what torch 2.13's places: ``rules.einsum`` runs a product on each
rank's shards where torch 2.11's view rule refuses to flatten a split that
does not lead the product's batch (2.13 places it as a strided split).
These tests run on this torch (2.13), whose own path is the oracle:

* each reduced cell's count with ``rules.flattens_splits`` forced to
  answer as 2.11 does equals the intact count: FLOPs, HBM bytes and every
  op's bytes within 1e-9, 0 fallbacks; the forced path multiplies on
  shards in the cells that flatten such splits;
* a reduced train step's loss and gradients, and a prefill's logits, on a
  one-rank gloo mesh are the same on both paths within 1e-6 (fp32);
* each rule the port registers where 2.11's rule parts from 2.13's
  (``clone`` and the pointwise ops, the out-of-place ``scatter``, the
  views) computes on every rank of a fake 2 × 2 mesh the rank's part of
  the op on whole tensors; with the release's own rule replaced by a
  stand-in that chooses as 2.11 does, ``install()`` brings the count back
  to the intact one (the views: no fallback, a split gathered).
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import procs
from repro_torch.sharding import default_rules, partition, rules

aten = torch.ops.aten


@pytest.fixture(scope="module", autouse=True)
def _no_group_left_behind():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh22():
    D.fake_world(4)
    return D.make_mesh((2, 2), ("data", "model"), device_type="cpu")


def _count(arch, kind):
    shape = ShapeConfig("t", D.REDUCED_SEQ, D.REDUCED_BATCH, kind)
    c = D.count_cell(configs.get_config(arch).reduced(), shape, _mesh22(), default_rules())
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes, "bytes_by_op": dict(c.stats.bytes_by_op),
            "fallbacks": c.fallbacks}


def _same(got, want):
    assert got["fallbacks"] == want["fallbacks"] == 0
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-9)
    assert got["hbm_bytes"] == pytest.approx(want["hbm_bytes"], rel=1e-9)
    assert set(got["bytes_by_op"]) == set(want["bytes_by_op"])
    for op, b in want["bytes_by_op"].items():
        assert got["bytes_by_op"][op] == pytest.approx(b, rel=1e-9), op


@contextlib.contextmanager
def _as_2_11(monkeypatch):
    """The port's probe of the running torch answering as torch 2.11's view
    rule does (it cannot flatten two splits), and the products it runs on
    shards counted."""
    products = []
    local_bmm = rules._local_bmm

    def counted(x, y, plan, ids, shape):
        products.append(ids)
        return local_bmm(x, y, plan, ids, shape)

    with monkeypatch.context() as m:
        m.setattr(rules, "flattens_splits", lambda: False)
        m.setattr(rules, "_local_bmm", counted)
        yield products


# the archs whose einsums flatten a split that does not lead their batch
# (MLA's and the SSD's: batch and heads split on 2 × 2); OLMoE has none
ON_SHARDS = {"deepseek-v2-lite-16b", "xlstm-1.3b", "zamba2-2.7b"}


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "xlstm-1.3b", "zamba2-2.7b",
                                  "olmoe-1b-7b"])
def test_the_2_11_path_counts_as_dtensor_does(arch, kind, monkeypatch):
    intact = _count(arch, kind)
    with _as_2_11(monkeypatch) as products:
        forced = _count(arch, kind)
    _same(forced, intact)
    assert bool(products) == (arch in ON_SHARDS)


def _one_rank(tmp_path):
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)


def _placed_on_one_rank(tree, axes):
    """``partition.placed`` without its shortcut for a one-rank mesh: the
    prefill's fresh decode state placed as the model's other tensors are."""
    from torch.distributed.tensor import distribute_tensor

    mesh = partition.active_mesh()

    def one(t, ax):
        place = partition.placements(partition.spec_for(ax, tuple(t.shape)), t.ndim, mesh)
        return distribute_tensor(t, mesh, place, src_data_rank=None)

    return partition._zip(one, tree, axes)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-2.7b"])
def test_a_step_and_a_prefill_give_the_same_values_on_both_paths(arch, tmp_path, monkeypatch):
    """On a one-rank mesh every split is kept as a placement, so the forced
    path multiplies on shards; loss, gradients and logits (fp32) agree with
    DTensor's own path within 1e-6."""
    from repro_torch.models import lm

    cfg = dataclasses.replace(configs.get_config(arch).reduced(), dtype="float32")
    kw = dict(mesh_shape=(1, 1), rules=default_rules(), device="cpu")
    monkeypatch.setattr(lm, "placed", _placed_on_one_rank)
    _one_rank(tmp_path)
    try:
        loss = procs.loss_program(cfg, batch=2, seq=16, **kw)
        serve = procs.serve_program(cfg, batch=2, prompt=16, steps=0, max_len=16, **kw)
        with _as_2_11(monkeypatch) as products:
            loss211 = procs.loss_program(cfg, batch=2, seq=16, **kw)
            serve211 = procs.serve_program(cfg, batch=2, prompt=16, steps=0, max_len=16, **kw)
    finally:
        dist.destroy_process_group()
    assert products
    assert abs(loss211["loss"] - loss["loss"]) <= 1e-6
    assert set(loss211["grads"]) == set(loss["grads"])
    for name, want in loss["grads"].items():
        np.testing.assert_allclose(loss211["grads"][name], want, rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(serve211["logits"][0], serve["logits"][0], rtol=0, atol=1e-6)


# --------------------------------------------- each rule the port registers

def _part(whole, placements, coord):
    t = whole
    for p, i in zip(placements, coord):
        if isinstance(p, Shard):
            t = torch.chunk(t, 2, dim=p.dim)[i]
    return t


def _placed(whole, placements, mesh):
    local = _part(whole, placements, (0, 0)).contiguous()
    stride = tuple(math.prod(whole.shape[i + 1:]) for i in range(whole.ndim))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=whole.shape,
                              stride=stride)


def _decide(op, args):
    """(input placements, output placements) DTensor picks for ``op``."""
    d = DTensor._op_dispatcher
    info = d.unwrap_to_op_info(op, args, {})
    out = d.sharding_propagator.propagate_op_sharding(info.schema)
    schema = out.redistribute_schema or info.schema
    return [tuple(s.placements) for s in schema.args_spec], tuple(out.output_spec.placements)


@contextlib.contextmanager
def _rules_as(stand_ins):
    """Each op of ``stand_ins`` placed by its stand-in alone (torch's rules,
    and the port's, put back after)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    saved = {op: (prop.op_strategy_funcs.get(op), single.pop(op, None)) for op in stand_ins}
    prop.op_strategy_funcs.update(stand_ins)
    rules.clear_caches()
    try:
        yield
    finally:
        for op, (strategy, one_dim) in saved.items():
            prop.op_strategy_funcs.pop(op, None)
            if strategy is not None:
                prop.op_strategy_funcs[op] = strategy
            if one_dim is not None:
                single[op] = one_dim
        rules.clear_caches()


def _follow_first(op_schema):
    """Torch 2.11's pointwise rule where one operand leads: every operand
    placed as the first (a pending sum passes through)."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    ins = [a for a in op_schema.args_schema if isinstance(a, OpStrategy)]
    first = ins[0].strategies[0].output_spec
    ndim = max(a.ndim for a in ins)
    wanted = []
    for a in ins:
        lead = ndim - a.ndim
        place = [p if not isinstance(p, Shard) else
                 Shard(p.dim - lead) if p.dim >= lead and a.shape[p.dim - lead] ==
                 ins[0].shape[p.dim - (ndim - ins[0].ndim)] else Replicate()
                 for p in first.placements]
        wanted.append(rules._spec(first.mesh, place, a.strategies[0].output_spec.tensor_meta))
    return OpStrategy([OpSpec(output_specs=rules._spec(first.mesh, first.placements),
                              input_specs=tuple(wanted),
                              redistribute_cost=[generate_redistribute_costs(a, w)
                                                 for a, w in zip(ins, wanted)])])


_follow_first.__module__ = "torch.distributed.tensor._ops._pointwise_ops"
_follow_first.__qualname__ = "pointwise_strategy"


def _keep_input(op_schema):
    """Torch 2.11's ``clone``: the input's placement, a pending sum kept."""
    from torch.distributed.tensor._ops._tensor_ops import propagate_single_input_strategy

    return propagate_single_input_strategy(op_schema)


def _replicate_all(op_schema):
    """Torch 2.11's ``scatter``: every operand whole."""
    from torch.distributed.tensor._op_schema import OpStrategy

    n = 1 + sum(isinstance(a, OpStrategy) for a in op_schema.args_schema)
    return rules._expand(op_schema, [[Replicate()] * n])


def _refusing(theirs):
    """Torch 2.11's view rule: it refuses where 2.13 places a strided split."""

    def strategy(op_schema):
        got = theirs(op_schema)
        if any(hasattr(p, "split_factor") for s in got.strategies
               for p in s.output_spec.placements):
            raise RuntimeError("cannot flatten a split that does not lead its group")
        return got

    return strategy


S0, S1, S2, R_ = Shard(0), Shard(1), Shard(2), Replicate()
g = torch.Generator().manual_seed(0)
_X = torch.randn(4, 6, 8, generator=g)
_IDX = torch.randint(0, 10, (4, 5, 8), generator=g)
_SRC = torch.randn(4, 5, 8, generator=g)

# name → (op, whole args, placements of the tensors, the stand-in 2.11 places
#         the op by, whether every split is kept: no operand gathered)
RULE_CASES = {
    "clone_reduces_a_pending_sum_onto_a_split": (aten.clone.default, (_X,), [(S0, Partial())],
                                                 _keep_input, True),
    "mul_slices_an_activation_for_a_split_parameter": (
        aten.mul.Tensor, (_X, torch.randn(8, generator=g)), [(S0, R_), (R_, S0)], _follow_first,
        True),
    "add_keeps_the_splits_alike": (aten.add.Tensor, (_X, _X.clone()), [(S0, S2), (S0, S2)],
                                   _follow_first, True),
    "scatter_out_of_place_kept": (aten.scatter.src, (torch.zeros(4, 10, 8), 1, _IDX, _SRC),
                                  [(S0, S2), (S0, S2), (S0, S2)], _replicate_all, True),
    "view_gathers_a_split_behind_the_first": (aten.view.default, (_X, [-1, 8]), [(S0, S1)],
                                              None, False),
}


def _with(args, fn):
    k = iter(range(100))
    return tuple(fn(a, next(k)) if isinstance(a, torch.Tensor) else a for a in args)


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_each_port_rule_computes_each_ranks_part_of_the_op_on_whole_tensors(case):
    op, args, places, stand_in, kept = RULE_CASES[case]
    mesh = _mesh22()
    prop = DTensor._op_dispatcher.sharding_propagator
    if stand_in is None:  # the view: torch 2.11's refusal, behind the port's gathering
        stand_in = rules._gathering_view(_refusing(prop.op_strategy_funcs[op]))
    with _rules_as({op: stand_in}):
        rules.install()
        dargs = _with(args, lambda t, i: _placed(t, places[i], mesh))
        ins, out = _decide(op, dargs)
    gathered = any(isinstance(was, Shard) and now != was
                   for given, target in zip(places, ins) for was, now in zip(given, target))
    assert gathered != kept
    whole = op(*_with(args, lambda t, i: t.clone()))
    for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
        if any(isinstance(p, Partial) for p in places[0]):  # a pending sum: reduced whole
            local_in = _with(args, lambda t, i: _part(t * 2, ins[i], coord).clone())
            local = op(*local_in)
            torch.testing.assert_close(local, _part(whole * 2, out, coord), rtol=0, atol=0)
            continue
        local = op(*_with(args, lambda t, i: _part(t, ins[i], coord).clone()))
        torch.testing.assert_close(local, _part(whole, out, coord), rtol=0, atol=0)


def _pointwise_ops():
    """The elementwise ops torch 2.13 places by its single-dimension rule
    (``clone`` among them), but their ``out=`` variants, which the port
    leaves to torch (the models call none)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    return [op for op in single if torch.Tag.pointwise in op.tags
            and not any(a.is_out for a in op._schema.arguments)]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b"])
def test_the_port_rules_bring_a_count_with_2_11s_choices_back_to_the_intact_one(arch):
    """Torch 2.13's ``clone`` and pointwise rules, and its ``scatter`` rule,
    replaced by stand-ins that choose as 2.11's do: the count moves; with
    ``install()`` (the port's rules in their place) it equals the intact
    count."""
    intact = _count(arch, "train")
    stand_ins = {op: _follow_first for op in _pointwise_ops()}
    stand_ins.update({aten.clone.default: _keep_input, aten.scatter.src: _replicate_all})
    prop = DTensor._op_dispatcher.sharding_propagator
    with _rules_as(stand_ins):
        before = _count(arch, "train")
        rules.install()
        assert all(getattr(prop.op_strategy_funcs[op], "port_rule", False) for op in stand_ins)
        after = _count(arch, "train")
    assert before["bytes_by_op"] != intact["bytes_by_op"]
    _same(after, intact)
