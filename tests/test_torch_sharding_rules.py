"""The port's DTensor rules (``repro_torch.sharding.rules``) on the CPU.

The rules exist for torch releases (2.11, the card's) that have none, or a
failing one, for ``flip``, ``scatter_.src`` and ``index_put`` on the
placements the models give them.  Torch 2.13 places all three
itself, so the tests take its rules away (``without_torchs_rules``: its
strategy tables and the decomposition path it falls back on, for the ops
the port covers) and check that

* the dry run's counts then fall back, and with ``install()`` equal the
  intact torch's counts (FLOPs, HBM bytes and bytes by op within 1e-9);
* a real train step on a one-rank mesh then raises, and with ``install()``
  equals the step with no mesh within 1e-6 (fp32);
* each rule, and the SSD product on shards (``rules.einsum``), computes on
  every rank of a 2 × 2 mesh the rank's part of the op on the whole
  tensors, where it keeps the split and where it replicates: exactly.
"""

import contextlib
import math

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch import configs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as R
from repro_torch.sharding import default_rules, rules

aten = torch.ops.aten


@pytest.fixture(scope="module", autouse=True)
def _no_group_left_behind():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@contextlib.contextmanager
def _torch_rules_removed():
    from torch.distributed.tensor._decompositions import DecompShardingStrategy

    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    saved = {op: (prop.op_strategy_funcs.pop(op, None), single.pop(op, None))
             for op in rules.COVERED}
    has = DecompShardingStrategy.has_decomp
    DecompShardingStrategy.has_decomp = staticmethod(
        lambda op: op not in rules.COVERED and has(op))
    rules.clear_caches()
    try:
        yield
    finally:
        DecompShardingStrategy.has_decomp = has
        for op, (strategy, one_dim) in saved.items():
            prop.op_strategy_funcs.pop(op, None)
            if strategy is not None:
                prop.op_strategy_funcs[op] = strategy
            if one_dim is not None:
                single[op] = one_dim
        rules.clear_caches()


@pytest.fixture
def without_torchs_rules():
    """Torch's own placement of every op the port covers taken away (and put
    back after the test, the port's rules as ``install()`` left them)."""
    with _torch_rules_removed():
        yield


def _mesh22():
    D.fake_world(4)
    return D.make_mesh((2, 2), ("data", "model"), device_type="cpu")


def _count(arch):
    c = D.count_cell(configs.get_config(arch).reduced(), ShapeConfig("t", 64, 4, "train"),
                     _mesh22(), default_rules())
    return {"flops": c.flops, "hbm_bytes": c.hbm_bytes, "bytes_by_op": dict(c.stats.bytes_by_op),
            "fallbacks": c.fallbacks, "fallback_ops": dict(c.fallback_ops)}


def test_install_leaves_every_op_torch_places_itself_on_torchs_rule():
    prop = DTensor._op_dispatcher.sharding_propagator
    before = dict(prop.op_strategy_funcs)
    got = rules.install()
    assert got == rules.install()           # a second call registers nothing new
    for op in rules.COVERED:
        mine = getattr(prop.op_strategy_funcs.get(op), "port_rule", False)
        assert mine == (str(op) in got), op
        if op in getattr(prop, "op_single_dim_strategy_funcs", {}):
            assert str(op) not in got, op   # DTensor asks that rule first
    assert all(prop.op_strategy_funcs[op] is f for op, f in before.items())


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b"])
def test_counts_fall_back_without_the_rules_and_equal_intact_torch_with_them(arch):
    intact = _count(arch)
    assert intact["fallbacks"] == 0
    with _torch_rules_removed():
        without = _count(arch)
        rules.install()
        with_rules = _count(arch)
    assert without["fallbacks"] > 0
    assert set(without["fallback_ops"]) <= {str(op) for op in rules.COVERED}
    # the gathered inputs: none of the three ops has a FLOP formula
    assert without["hbm_bytes"] != intact["hbm_bytes"]
    assert without["bytes_by_op"]["all-gather"] > intact["bytes_by_op"]["all-gather"]
    assert with_rules["fallbacks"] == 0
    assert with_rules["flops"] == pytest.approx(intact["flops"], rel=1e-9)
    assert with_rules["hbm_bytes"] == pytest.approx(intact["hbm_bytes"], rel=1e-9)
    assert set(with_rules["bytes_by_op"]) == set(intact["bytes_by_op"])
    for op, b in intact["bytes_by_op"].items():
        assert with_rules["bytes_by_op"][op] == pytest.approx(b, rel=1e-9), op


def _loss_and_grads(cfg, start, batch, mesh=None):
    """Loss and gradients of one step from the weights ``start``; under
    ``mesh`` the parameters and batch are DTensors placed by the default
    rules, as the sharded ``Trainer`` places them."""
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import ParamTree, build_model
    from repro_torch.models.module import axes_of, shapes_of
    from repro_torch.sharding import partition
    from repro_torch.train.optimizer import leaves
    from repro_torch.train.trainer import _place

    model = build_model(cfg)
    params = ParamTree.from_state_dict({k: v.clone() for k, v in start.items()})
    placed = contextlib.ExitStack()
    if mesh is not None:
        specs = model.specs()
        _place(params, partition.param_sharding(axes_of(specs), mesh, default_rules(),
                                                shapes_tree=shapes_of(specs)), mesh)
        with partition.use_partitioning(mesh, default_rules()):
            batch = {k: distribute_tensor(v, mesh, partition.placements(partition.spec_for(
                ("batch",) + (None,) * (v.ndim - 1), tuple(v.shape)), v.ndim, mesh),
                src_data_rank=None) for k, v in batch.items()}
        placed.enter_context(partition.use_partitioning(mesh, default_rules()))
        placed.enter_context(implicit_replication())
    p = leaves(params)
    for t in p.values():
        t.requires_grad_(True)
    with placed:
        loss, _ = model.loss(params, batch)
        loss.backward()
    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor) else t).detach()
    return whole(loss), {k: whole(t.grad) for k, t in p.items()}


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "olmoe-1b-7b"])
def test_a_one_rank_mesh_step_raises_without_the_rules_and_equals_no_mesh_with_them(
        arch, tmp_path):
    """A real (not counted) step has no fallback: with no rule for the ops
    the step meets (Zamba2: ``flip``; OLMoE: ``scatter_``, ``index_put``)
    it raises."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import build_model

    cfg = configs.get_config(arch).reduced()
    start = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu").state_dict()
    batch = {k: torch.as_tensor(v) for k, v in
             SyntheticLMData(cfg, DataConfig(global_batch=4, seq_len=32)).global_batch(0).items()}
    want_loss, want = _loss_and_grads(cfg, start, batch)
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        with _torch_rules_removed():
            with pytest.raises((NotImplementedError, RuntimeError)):
                _loss_and_grads(cfg, start, batch, mesh)
            rules.install()
            loss, grads = _loss_and_grads(cfg, start, batch, mesh)
    finally:
        dist.destroy_process_group()
    torch.testing.assert_close(loss, want_loss, rtol=0, atol=1e-6)
    assert set(grads) == set(want)
    for k in want:
        torch.testing.assert_close(grads[k], want[k], rtol=0, atol=1e-6, msg=k)


# --------------------------------------------------- each rule on its own

def _part(whole, placements, coord):
    """The part of ``whole`` a rank at mesh coordinate ``coord`` holds under
    ``placements`` (mesh dimensions applied in order, ``torch.chunk``'s
    sizes)."""
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


S0, S1, S2, R_ = Shard(0), Shard(1), Shard(2), Replicate()
g = torch.Generator().manual_seed(0)
_X = torch.randn(4, 6, 8, generator=g)
_IDX = torch.randint(0, 10, (4, 5, 8), generator=g)
_SRC = torch.randn(4, 5, 8, generator=g)
_ROWS = torch.tensor([5, 0, 3, 3, 1])
_VALS = torch.randn(4, 5, 8, generator=g)

# name → (op, whole args (tensors and the rest), placements of the tensors,
#         whether every split is kept: no operand gathered along it)
RULE_CASES = {
    "flip_kept": (aten.flip.default, (_X, [1]), [(S0, S2)], True),
    "flip_replicates_the_flipped_dim": (aten.flip.default, (_X, [2]), [(S0, S2)], False),
    "scatter_kept": (aten.scatter_.src, (torch.zeros(4, 10, 8), 1, _IDX, _SRC),
                     [(S0, S2), (S0, S2), (S0, S2)], True),
    "scatter_replicates_a_mismatched_dim": (
        aten.scatter_.src, (torch.zeros(4, 10, 8), 1, _IDX[:, :, :4], _SRC[:, :, :4]),
        [(S0, R_), (S0, S2), (S0, S2)], False),
    "index_put_kept": (aten.index_put.default, (torch.zeros(4, 6, 8), [None, _ROWS], _VALS, True),
                       [(R_, R_), (R_, R_), (S0, S2)], True),
    "index_put_replicates_the_indexed_dim": (
        aten.index_put.default, (torch.zeros(4, 6, 8), [None, _ROWS], _VALS, True),
        [(R_, R_), (R_, R_), (S1, R_)], False),
}


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, list):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _with(args, fn):
    """``args`` with each tensor (inside lists too) replaced by ``fn`` of
    it and its position among the tensors."""
    k = iter(range(100))
    swap = lambda a: fn(a, next(k)) if isinstance(a, torch.Tensor) else a
    return tuple([swap(t) for t in a] if isinstance(a, list) else swap(a) for a in args)


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_each_rule_computes_each_ranks_part_of_the_op_on_whole_tensors(case,
                                                                       without_torchs_rules):
    op, args, places, kept = RULE_CASES[case]
    mesh = _mesh22()
    rules.install()
    dargs = _with(args, lambda t, i: _placed(t, places[i], mesh))
    ins, out = _decide(op, dargs)
    gathered = any(isinstance(was, Shard) and now != was
                   for given, target in zip(places, ins) for was, now in zip(given, target))
    assert gathered != kept
    whole = op(*_with(args, lambda t, i: t.clone()))
    for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
        local = op(*_with(args, lambda t, i: _part(t, ins[i], coord).clone()))
        torch.testing.assert_close(local, _part(whole, out, coord), rtol=0, atol=0)


def test_the_ssd_product_on_shards_is_each_ranks_part_of_the_whole_einsum(monkeypatch):
    """Where the running torch cannot flatten two split batch letters, the
    SSD's intra-chunk product runs on each rank's shards, with no
    collective, and each rank's result is its part of the whole einsum;
    operands split any other way go to DTensor."""
    monkeypatch.setattr(rules, "flattens_splits", lambda: False)
    mesh = _mesh22()
    eq = "bclmh,bcmhp->bclhp"
    w, x = torch.randn(4, 2, 4, 4, 6, generator=g), torch.randn(4, 2, 4, 6, 3, generator=g)
    a, b = _placed(w, (S0, Shard(4)), mesh), _placed(x, (S0, Shard(3)), mesh)
    with R.count_step() as c:
        y = rules.einsum(eq, a, b)
    assert c.stats.total_count == 0 and tuple(y.placements) == (S0, Shard(3))
    assert tuple(y.shape) == (4, 2, 4, 6, 3)
    whole = torch.einsum(eq, w, x)
    torch.testing.assert_close(y.to_local(), _part(whole, y.placements, (0, 0)), rtol=0, atol=0)
    for coord in ((0, 1), (1, 0), (1, 1)):
        local = torch.einsum(eq, _part(w, (S0, Shard(4)), coord), _part(x, (S0, Shard(3)), coord))
        torch.testing.assert_close(local, _part(whole, y.placements, coord), rtol=0, atol=0)
    # one split batch letter: DTensor flattens it itself
    a1, b1 = _placed(w, (S0, R_), mesh), _placed(x, (S0, R_), mesh)
    assert tuple(rules.einsum(eq, a1, b1).placements) == \
        tuple(torch.einsum(eq, a1, b1).placements)


def test_the_trace_lists_every_op_with_its_placements_and_the_running_flops(tmp_path):
    """``python -m repro_torch.launch.dryrun_trace``'s lines, for diffing the
    placements of two torch releases: one per op the count sees, the last
    one's FLOPs the count's."""
    from repro_torch.launch import dryrun_trace as T

    cfg = configs.get_config("zamba2-2.7b").reduced()
    shape = ShapeConfig("t", 64, 4, "train")
    lines = T.trace_cell(cfg, shape, _mesh22(), default_rules())
    count = D.count_cell(cfg, shape, _mesh22(), default_rules())
    assert float(lines[-1].rsplit("flops=", 1)[1]) == count.flops
    assert any("aten.bmm.default" in x and "S(0)" in x for x in lines)
    assert R._Ops.__torch_dispatch__ is not None and "traced" not in R._Ops.__torch_dispatch__.__name__


def test_a_local_gradient_comes_back_contiguous_and_unwrapped():
    """``partition.local_part``'s gradient hook: a transposed gradient is
    made contiguous (a later view of it would fail), and a DTensor one (a
    remat recompute on autograd's CUDA thread hands one back) gives its
    local tensor, which DTensor then wraps once."""
    from repro_torch.sharding.partition import _local_gradient

    g = torch.arange(12.0).reshape(3, 4).t()
    got = _local_gradient(g)
    assert got.is_contiguous() and torch.equal(got, g)
    mesh = _mesh22()
    wrapped = _placed(torch.arange(16.0).reshape(4, 4).t(), (S0, R_), mesh)
    got = _local_gradient(wrapped)
    assert not isinstance(got, DTensor) and got.is_contiguous()
    assert torch.equal(got, wrapped.to_local())
