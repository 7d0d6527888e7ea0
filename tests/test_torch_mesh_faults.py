"""The port's sharded path on the faults the dry run found against the
reference (``ROADMAP.md`` Queue 3, F1–F5), on the CPU.

* F1: a decode step writes its split KV cache on each rank's part (the
  reference's one-hot write) and attends each rank's part of it; the count
  runs with no fallback, and a reduced model served on a 2 × 2 gloo mesh
  of four processes gives the logits, tokens and caches of one process.
* F2: query heads split over "model" even where the KV heads do not, each
  rank reading the KV heads its query heads read; hand counts of a
  two-layer dense prefill, and the loss and every gradient on four
  processes against one.
* F3: the xLSTM train count runs one sLSTM cell a layer in each pass (the
  forward and the remat recompute), and skips exactly the other cells.
* F5: the pointwise placement the port offers beside a rule that follows
  one operand, and the gathered views, each rank's part of the whole op.

Tolerances: FLOPs are exact (integer counts of the same products); values
on four processes against one are fp32 sums in another order: 1e-6
absolute for logits, loss and gradients, and 1e-5 of the largest entry (at
least 1e-5) for a cache or recurrent state, whose entries reach ~10 and
carry the rounding of every layer before them (3.4e-6 the largest seen,
a Mamba-2 state of Zamba2).
"""

import contextlib
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def _mesh(shape=(2, 2)):
    D.fake_world(math.prod(shape))
    return D.make_mesh(shape, ("data", "model"), device_type="cpu")


def _spawned(program, cfg, kw, tmp_path, mesh_shape=(2, 2)):
    return procs.spawn(program, math.prod(mesh_shape), (cfg,),
                       dict(kw, mesh_shape=mesh_shape, rules=default_rules(), device="cpu"),
                       store_dir=str(tmp_path), timeout_s=300)


# ------------------------------------------------- F1: decode under a mesh

@pytest.mark.parametrize("arch", ["granite-20b", "deepseek-v2-lite-16b"])
def test_a_decode_step_counts_on_a_split_cache_with_no_fallback(arch):
    """The cache is split along its length over "model" (its batch over
    "data"); the step's write and attention stay on each rank's part."""
    cfg = configs.get_config(arch).reduced()
    c = D.count_cell(cfg, ShapeConfig("d", 32, 4, "decode"), _mesh(), default_rules())
    assert c.fallbacks == 0 and c.flops > 0
    # the combine of the split softmax: small all-reduces, no gathered cache
    assert c.stats.count_by_op.get("all-reduce", 0) > 0


SERVE_ARCHS = ["granite-20b", "whisper-small", "zamba2-2.7b", "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_a_four_process_decode_equals_one_process(arch, tmp_path):
    """Prefill and two greedy decode steps: GQA with one KV head (granite),
    Whisper's self and cross attention, Zamba2's shared attention and
    Mamba-2 states, DeepSeek's MLA cache."""
    cfg = configs.get_config(arch).reduced()
    kw = dict(batch=4, prompt=12, steps=2, max_len=16, seed=0)
    one = procs.serve_program(cfg, **kw, device="cpu")
    for rank in _spawned(procs.serve_program, cfg, kw, tmp_path):
        assert rank["tokens"] == one["tokens"]
        for got, want in zip(rank["logits"], one["logits"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert len(rank["state"]) == len(one["state"])
        for got, want in zip(rank["state"], one["state"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


# ---------------------------------- F2: heads split where KV heads do not

# name -> (query heads, KV heads, mesh): one KV head for all; half a group a
# rank; ranks whose heads straddle two groups; heads that do not split
KV_CASES = {
    "one_kv_head": (4, 1, (2, 2)),
    "half_a_group": (8, 2, (1, 4)),
    "groups_straddle_ranks": (12, 3, (2, 2)),
    "heads_do_not_split": (3, 1, (2, 2)),
}


def _dense(H, K):
    return dataclasses.replace(configs.get_config("mistral-large-123b").reduced(), n_layers=2,
                               n_heads=H, n_kv_heads=K, head_dim=16, dtype="bfloat16")


@pytest.mark.parametrize("case", list(KV_CASES))
def test_two_layer_dense_prefill_flops_per_rank_equal_a_hand_count_when_kv_heads_do_not_split(
        case):
    """Every product is split over both mesh axes (rows over "data"; heads,
    width or vocabulary over "model") but, where the query heads do not
    split over "model", attention and its output projection, which every
    "model" rank then does whole for its rows."""
    H, K, shape = KV_CASES[case]
    cfg = _dense(H, K)
    dp, m = shape
    B, S, d, Dh, F, V = 4, 16, cfg.d_model, 16, cfg.d_ff, cfg.vocab
    T = B * S
    split = dp * m
    heads_split = H % m == 0
    per_layer = (
        2 * T * d * (H + 2 * K) * Dh / split                       # q, k, v projections
        + 2 * (2 * B * H * S * S * Dh) / (split if heads_split else dp)  # scores, probs · v
        + 2 * T * H * Dh * d / (split if heads_split else dp)      # output projection
        + 3 * 2 * T * d * F / split                                # SwiGLU
    )
    want = cfg.n_layers * per_layer + 2 * B * d * V / split        # last position's logits
    c = D.count_cell(cfg, ShapeConfig("hand", S, B, "prefill"), _mesh(shape), default_rules())
    assert c.fallbacks == 0
    assert c.flops == want


@pytest.mark.parametrize("case", list(KV_CASES))
def test_loss_and_gradients_on_four_processes_equal_one_process_when_kv_heads_do_not_split(
        case, tmp_path):
    H, K, shape = KV_CASES[case]
    cfg = dataclasses.replace(_dense(H, K), dtype="float32")
    kw = dict(batch=4, seq=16, seed=0)
    one = procs.loss_program(cfg, **kw, device="cpu")
    for rank in _spawned(procs.loss_program, cfg, kw, tmp_path, shape):
        assert abs(rank["loss"] - one["loss"]) <= 1e-6
        assert set(rank["grads"]) == set(one["grads"])
        for name, want in one["grads"].items():
            np.testing.assert_allclose(rank["grads"][name], want, rtol=0, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("first, count, group, want", [
    (0, 2, 4, (0, 1)),          # half a group
    (6, 6, 2, (3, 6)),          # three whole groups
    (0, 6, 4, [0, 0, 0, 0, 1, 1]),  # one and a half groups: a KV head per query head
    (4, 4, 8, (0, 1)),
])
def test_the_kv_heads_a_rank_reads(first, count, group, want):
    from repro_torch.models.attention import _kv_heads_of

    got = _kv_heads_of(first, count, group)
    assert got == want
    idx = list(range(*got)) if isinstance(got, tuple) else got
    g = count // len(idx)
    # the local grouped call maps each local query head to the KV head it reads
    assert all(idx[j // g] == (first + j) // group for j in range(count))


# --------------------------------------------- F3: the xLSTM train count

def test_the_xlstm_train_count_runs_one_cell_a_layer_in_each_pass():
    """Reduced xLSTM, a train step on 2 × 2: with the memo the count runs
    (the remat recompute saves what the forward saved) and equals the count
    with every cell run, less the cells it skips: S - 1 cells a sLSTM layer,
    each its recurrent product in the forward, the recompute and, twice,
    the backward, on a rank's rows and heads."""
    cfg = configs.get_config("xlstm-1.3b").reduced()
    S, B = 8, 4
    shape = ShapeConfig("t", S, B, "train")
    once = D.count_cell(cfg, shape, _mesh(), default_rules())
    saved = D._slstm_body_once
    D._slstm_body_once = contextlib.nullcontext
    try:
        every = D.count_cell(cfg, shape, _mesh(), default_rules())
    finally:
        D._slstm_body_once = saved
    H, Dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    n_slstm = cfg.n_layers // cfg.xlstm.slstm_every
    cell = 2 * (H // 2) * (B // 2) * Dh * 4 * Dh
    assert once.fallbacks == every.fallbacks == 0
    assert every.flops - once.flops == n_slstm * (S - 1) * 4 * cell


# ------------------------------------- F5: placements and gathered views

def _part(whole, placements, coord, mesh):
    t = whole
    for p, i, n in zip(placements, coord, mesh.shape):
        if isinstance(p, Shard):
            t = torch.chunk(t, n, dim=p.dim)[i]
    return t


def _placed(whole, placements, mesh):
    local = _part(whole, placements, (0, 0), mesh).contiguous()
    stride = tuple(math.prod(whole.shape[i + 1:]) for i in range(whole.ndim))
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=whole.shape,
                              stride=stride)


def _decide(op, args):
    d = DTensor._op_dispatcher
    info = d.unwrap_to_op_info(op, args, {})
    out = d.sharding_propagator.propagate_op_sharding(info.schema)
    schema = out.redistribute_schema or info.schema
    return [tuple(s.placements) for s in schema.args_spec], tuple(out.output_spec.placements)


@contextlib.contextmanager
def _only_rule(op, strategy):
    """``op`` placed by ``strategy`` alone (torch's own rule put back after)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    saved = prop.op_strategy_funcs.get(op), single.pop(op, None)
    prop.op_strategy_funcs[op] = strategy
    rules.clear_caches()
    try:
        yield
    finally:
        prop.op_strategy_funcs.pop(op, None)
        if saved[0] is not None:
            prop.op_strategy_funcs[op] = saved[0]
        if saved[1] is not None:
            single[op] = saved[1]
        rules.clear_caches()


def _follow_first(op_schema):
    """A rule that follows its first operand, as torch 2.11's pointwise one
    does when that operand has the most splits: every other is placed alike."""
    from torch.distributed.tensor._op_schema import OpSpec, OpStrategy
    from torch.distributed.tensor._ops.utils import generate_redistribute_costs

    first = op_schema.args_schema[0]
    place = first.strategies[0].output_spec.placements
    others = [a for a in op_schema.args_schema[1:] if isinstance(a, OpStrategy)]
    wanted = [rules._spec(first.mesh, [p if not isinstance(p, Shard) or p.dim < a.ndim
                                       and a.shape[p.dim] == first.shape[p.dim] else Replicate()
                                       for p in place], a.strategies[0].output_spec.tensor_meta)
              for a in others]
    wanted = [rules._spec(first.mesh, place, first.strategies[0].output_spec.tensor_meta)] + wanted
    return OpStrategy([OpSpec(output_specs=rules._spec(first.mesh, place),
                              input_specs=tuple(wanted),
                              redistribute_cost=[generate_redistribute_costs(a, w) for a, w in
                                                 zip([first] + others, wanted)])])


def test_the_cheapest_pointwise_placement_slices_an_activation_to_meet_a_split_parameter():
    """A whole (per "model") activation times a parameter split over
    "model": a rule that follows the activation gathers the parameter; the
    port's rule (torch 2.13's, per mesh dimension) slices the activation
    instead (no collective) and each rank's result is its part of the whole
    product."""
    mesh = _mesh()
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn(4, 6, 8, generator=g), torch.randn(8, generator=g)
    args = (_placed(x, (Shard(0), Replicate()), mesh), _placed(w, (Replicate(), Shard(0)), mesh))
    with _only_rule(aten.mul.Tensor, _follow_first):
        ins, _ = _decide(aten.mul.Tensor, args)
    assert ins[1] == (Replicate(), Replicate())  # the parameter gathered
    with _only_rule(aten.mul.Tensor, rules._pointwise_strategy):
        ins, out = _decide(aten.mul.Tensor, args)
    assert ins == [(Shard(0), Shard(2)), (Replicate(), Shard(0))] and out == (Shard(0), Shard(2))
    whole = x * w
    for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
        local = _part(x, ins[0], coord, mesh) * _part(w, ins[1], coord, mesh)
        torch.testing.assert_close(local, _part(whole, out, coord, mesh), rtol=0, atol=0)


def test_install_offers_the_cheaper_placement_only_beside_a_rule_that_follows_one_operand():
    def follows(op_schema):
        raise AssertionError

    follows.__module__ = "torch.distributed.tensor._ops._pointwise_ops"
    follows.__qualname__ = "pointwise_strategy"
    assert rules._follows_one_operand(follows)
    assert not rules._follows_one_operand(rules._pointwise_strategy)
    prop = DTensor._op_dispatcher.sharding_propagator
    # this torch places pointwise ops per mesh dimension: none is the port's
    wrapped = [op for op, f in prop.op_strategy_funcs.items()
               if f is rules._pointwise_strategy and op not in rules.COVERED]
    assert (rules.POINTWISE in rules.install()) == bool(wrapped)
    single = getattr(prop, "op_single_dim_strategy_funcs", {})
    assert all(op not in single for op in wrapped)


@pytest.mark.parametrize("placements", [(Shard(0), Shard(2)), (Shard(0), Replicate()),
                                        (Replicate(), Replicate())])
def test_log_sigmoid_backward_computes_each_ranks_part(placements):
    mesh = _mesh()
    g = torch.Generator().manual_seed(1)
    grad, x = torch.randn(4, 6, 8, generator=g), torch.randn(4, 6, 8, generator=g)
    buf = aten.log_sigmoid_forward.default(x)[1]  # the CPU kernel's buffer: x's shape
    op = aten.log_sigmoid_backward.default
    with _only_rule(op, rules._pointwise_strategy):
        ins, out = _decide(op, tuple(_placed(t, placements, mesh) for t in (grad, x, buf)))
        # a CUDA buffer is empty: whole on every rank, the rest kept
        empty = _placed(torch.empty(0), (Replicate(), Replicate()), mesh)
        cuda_ins, cuda_out = _decide(op, (_placed(grad, placements, mesh),
                                          _placed(x, placements, mesh), empty))
    assert ins == [placements] * 3 and out == placements  # kept: no collective
    assert cuda_ins == [placements, placements, (Replicate(), Replicate())]
    assert cuda_out == placements
    whole = op(grad, x, buf)
    for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
        local = op(*(_part(t, p, coord, mesh) for t, p in zip((grad, x, buf), ins)))
        torch.testing.assert_close(local, _part(whole, out, coord, mesh), rtol=0, atol=0)


def test_a_product_split_in_a_way_no_view_describes_is_gathered_and_its_gradient_passes():
    """Heads × width split over "model" where "model" does not divide the
    heads: gathered along it before the view, the gradient handed back as
    it comes; a split the heads take, or a plain tensor, as it is.  A
    sequence split is gathered before a view of the rows."""
    mesh = _mesh()
    y = _placed(torch.randn(4, 2 * 8), (Shard(0), Shard(1)), mesh)
    assert partition.unflattenable(y, 2) is y
    y.requires_grad_(True)
    got = partition.unflattenable(y, 1)
    assert tuple(got.placements) == (Shard(0), Replicate())
    got.sum().backward()
    assert y.grad is not None and tuple(y.grad.shape) == (4, 16)
    plain = torch.randn(4, 6)
    assert partition.unflattenable(plain, 5) is plain
    z = _placed(torch.randn(4, 1, 8), (Shard(0), Replicate()), mesh)
    flat = partition.flatten_last(z, 2)
    assert tuple(flat.shape) == (4, 8) and tuple(flat.placements) == (Shard(0), Replicate())
    assert tuple(partition.flatten_last(torch.randn(2, 3, 4), 2).shape) == (2, 12)
    rows = _placed(torch.randn(4, 6, 8), (Shard(0), Shard(1)), mesh)
    assert tuple(partition.whole_along(rows, 1).placements) == (Shard(0), Replicate())
    assert partition.whole_along(z, 1) is z


def test_a_pending_sum_passes_through_the_cheapest_pointwise_placement():
    """A partial sum times a replicated factor stays a partial sum (torch
    2.13's rule for ``mul``): each rank's local product sums, over the
    ranks, to the whole product."""
    from torch.distributed.tensor import Partial

    mesh = _mesh()
    g = torch.Generator().manual_seed(2)
    parts = [torch.randn(4, 6, generator=g) for _ in range(2)]
    w = torch.randn(6, generator=g)
    local = parts[0]
    x = DTensor.from_local(local, mesh, (Shard(0), Partial()), run_check=False,
                           shape=torch.Size((8, 6)), stride=(6, 1))
    wd = _placed(w, (Replicate(), Replicate()), mesh)
    with _only_rule(aten.mul.Tensor, rules._pointwise_strategy):
        ins, out = _decide(aten.mul.Tensor, (x, wd))
    assert ins == [(Shard(0), Partial()), (Replicate(), Replicate())]
    assert out == (Shard(0), Partial())  # no collective
    torch.testing.assert_close(parts[0] * w + parts[1] * w, (parts[0] + parts[1]) * w)


def test_an_einsum_on_shards_takes_one_split_letter_and_moves_a_second(monkeypatch):
    """Where the running torch cannot flatten a split that does not lead the
    product's batch (torch 2.11), ``rules.einsum`` multiplies each rank's
    shards, placed and moved as DTensor's own path on this torch (2.13)
    places and moves them: one split batch letter (DTensor's path), the
    heads split alike on both operands (no collective), and the heads of
    one meeting the rows of the other split over both mesh dimensions
    (the heads gathered and sliced as rows, whose values the fake group
    does not move: there the placements and the collectives are held);
    each rank's result is its part of the whole."""
    from repro_torch.launch import roofline as R

    mesh = _mesh()
    g = torch.Generator().manual_seed(3)
    eq = "bshk,bthk->bhst"
    q, k = torch.randn(4, 3, 2, 5, generator=g), torch.randn(4, 3, 2, 5, generator=g)
    whole = torch.einsum(eq, q, k)
    cases = [((Shard(0), Replicate()), (Shard(0), Replicate())),
             ((Shard(0), Shard(2)), (Shard(0), Shard(2))),
             ((Shard(0), Shard(2)), (Shard(0), Shard(0)))]
    for qp, kp in cases:
        with R.count_step() as c:
            want = torch.einsum(eq, _placed(q, qp, mesh), _placed(k, kp, mesh))
        with monkeypatch.context() as m:
            m.setattr(rules, "flattens_splits", lambda: False)
            with R.count_step() as d:
                y = rules.einsum(eq, _placed(q, qp, mesh), _placed(k, kp, mesh))
        assert tuple(y.placements) == tuple(want.placements)
        assert tuple(y.shape) == tuple(whole.shape) and y.stride() == want.stride()
        assert dict(d.stats.bytes_by_op) == dict(c.stats.bytes_by_op)
        assert d.flops == c.flops and d.hbm_bytes == c.hbm_bytes and d.fallbacks == 0
        if not c.stats.total_count:  # the fake group's collectives move no data
            torch.testing.assert_close(y.to_local(), _part(whole, y.placements, (0, 0), mesh),
                                       rtol=0, atol=0)
    assert c.stats.total_count  # the last case moves the heads


def test_the_reference_record_holds_every_live_single_pod_cell_and_the_ratios_read_it():
    """``tests/data/reference_single_pod.json``, the reference's roofline and
    ``memory_analysis`` per live cell (the oracle of ``PERF.md``'s table),
    and ``reference_table.rows`` on one port record."""
    from repro_torch.launch import reference_table as T

    ref = __import__("json").loads(T.REFERENCE.read_text())
    live = {f"{a}__{s}" for a in configs.ARCH_IDS for s, shape in configs.SHAPES.items()
            if configs.shape_applicable(configs.get_config(a), shape)[0]}
    assert set(ref) == live and len(live) == 32
    for rec in ref.values():
        assert rec["flops"] > 0 and rec["chips"] == 256
        assert all(rec[k] >= 0 for k in T.MEMORY_FIELDS)
    key = "granite-20b__decode_32k"
    port = {key: {"status": "ok", "per_rank": {"flops": 2 * ref[key]["flops"]},
                  "collectives": {"bytes_by_op": {
                      "all-gather": ref[key]["bytes_by_op"]["all-gather"]}},
                  "memory_per_rank": {"temp_size_in_bytes": ref[key]["temp_size_in_bytes"],
                                      "argument_size_in_bytes": ref[key]["argument_size_in_bytes"],
                                      "peak_by_op": {"where": 1}},
                  "fallbacks": {"count": 0}, "pccl_pricing": {"speedup": 1.5}}}
    row = next(r for r in T.rows(port, ref) if r["cell"] == key)
    assert (row["flops_ratio"], row["all_gather_ratio"], row["temp_ratio"]) == (2.0, 1.0, 1.0)
    assert row["peak_op"] == "where"
    assert all(r["status"] == "not counted" for r in T.rows(port, ref) if r["cell"] != key)
